"""Smoke run of tatt_tpu_torch on one CUDA card: the port's eval and
training paths at full width, with all four hand-written kernels held
against their plain PyTorch versions.

  python3 chip_smoke.py
  python3 chip_smoke.py --forward-kernels-only   # phases 1-2 alone
  python3 chip_smoke.py --kernels-only           # phases 1, 2 and 6 alone
  python3 chip_smoke.py --lstm-bwd-only          # phase 1 and the LSTM backward of phase 6
  python3 chip_smoke.py --gru-fwd-only           # phase 1 and the BiGRU forward of phase 2
  python3 chip_smoke.py --data-only              # phases 1 and 10 alone
  python3 chip_smoke.py --pretrain-only          # phases 1 and 11 alone
  python3 chip_smoke.py --flags-only             # phases 1 and 12 alone
  python3 chip_smoke.py --judges-only            # phases 1 and 13 alone
  python3 chip_smoke.py --tsrn-only              # phases 1 and 14 alone
  python3 chip_smoke.py --zoo-only               # phases 1 and 15 alone
  python3 chip_smoke.py --chinese-only           # phases 1 and 16 alone

Phases (any failure exits non-zero; no phase carries on after its own):
  1. card name and power limit; build the CUDA kernels from csrc/
  2. each forward kernel against its plain version at the main paths'
     shapes, with timings of kernel (the smaller of CUDA events and its own
     device time in a profiler window), plain version and cuDNN, a launch at
     L=1 and so the time of a step, and the launch plan; the LSTM kernel
     also with its cell states, beside the input projection (cuDNN's time
     includes it)
  3. the full-width eval path (Evaluator over 256 synthetic images at
     batch 64), launch counts, and one batch on the card against the CPU
  4. the trained fixture judge reads HR through the LSTM kernel
  5. a profiler window over one eval batch: device time by kernel
  6. each backward kernel against its plain twin at the training path's
     shapes (and the LSTM forward's cell states), with timings of kernel,
     plain twin and a cuDNN forward+backward; for both backward kernels
     also the device time of each of their entries (recurrence,
     weight-gradient pass, ...), a launch at L=1 and so the time of a step,
     and the launch plan; the BiGRU backward also at the plain step's
     shapes (B=64, L=16 R=4096 and L=64 R=1024); and the BiLSTM module at
     H=113 and 250, which its kernels refuse: the H it runs them at
     (decided from the kernels' plan queries, the layer counted, one
     forward and one backward launch), forward and backward against the
     plain twin on the CPU, timed beside the plain twin and cuDNN
  7. the full-width training path: Trainer.train with the canonical recipe
     at batch 64, images/s, launches per step, finite and falling losses
  8. one full-width train step at batch 8 on the card (kernels) against
     the same step on the CPU (plain twins): each parameter's gradient
  9. a profiler window over a few train steps: device time by kernel
 10. the real-data path through the CLI: TextZoom-layout LMDBs (PNG and
     JPEG, odd sizes, a corrupt record, a missing label) and a YAML;
     ``cli.run`` trains the recipe 8 steps (checkpoints at 4 and 8, launches
     per step), a resume with a new lr restores everything bitwise and its
     steps match the uninterrupted run's, ``--go_test`` of the best
     checkpoint gives the summary recorded when it was saved; LMDB train
     images/s with 4 and 1 loader threads beside phase 7's synthetic, the
     loader's host ms a batch alone, eval images/s with 1 and 4 workers,
     checkpoint save / restore ms and bytes
 11. CTC pretraining of the CRNN: the port's CTC loss card vs CPU on spread
     (1e30 entries) and plain targets, timed beside ``F.ctc_loss``; the
     BiLSTM kernels at pretraining's R=128 (H=256 and the judge's H=64),
     forward and backward, against their plain twins; ``pretrain_recognizer``
     on the full-width CRNN at batch 128 (images/s, launches per step,
     falling loss); the fixture judge's recipe cut to 480 steps (falling
     loss; held-out word accuracy beside the committed asset's), its
     ``.pth`` then the
     teacher of a 2-step ``cli.run`` and the judge of ``--go_test``
 12. the TATT step's flags: Trainer steps at full width, batch 64, for the
     recipe and each flag set (--use_label, --stu_iter=2 with separate
     copies and --for_cascading, --learning_STN, --training_stablize with
     --ssim_loss, --y_domain, --rotate_train=0, none of --use_distill /
     --gradient / --tssim_loss): launches per step, falling loss_sr, the
     new metrics, images/s; then one --stu_iter=2 step at batch 8, card
     against CPU, leaf by leaf
 13. the evaluation protocol's judges and extras: ASTER and MORAN at full
     width with seeded weights at batch 50 on the card (BiLSTM launches a
     judge call; encoder features and first-step logits card vs CPU; the
     share of identical ids; the ASTER decode's ms a batch), the BiLSTM
     forward kernel at their shapes (L=25, R=50, H=256, In 512 and 256)
     against its plain version, Evaluator images/s and launches a batch
     with the CRNN, ASTER and MORAN judges, with and without a seeded
     LPIPS, the --vis files, --demo over 8 PNGs, and ``cli.run`` with
     ``--test --rec=aster`` and ``--go_test --test_model=MORAN`` from
     saved weights against Evaluator on the same weights
 14. the TSRN family at full width (hidden 32, 5 SRBs, scale 2, --mask):
     Trainer steps at batch 64 for tsrn, tsrn_c2f and sem_tsrn (the plain
     step) and tsrn_tl_cascade and tsrn_tl_cascade_sft (the TATT step),
     images/s and launches per step, falling loss_sr for tsrn and
     tsrn_tl_cascade; one batch-8 tsrn step with --tssim_loss --mse_fuse,
     card against CPU, leaf by leaf; Evaluator images/s for tsrn; and
     ``cli.run --arch=tsrn`` for 4 steps, then ``--go_test`` of its best
     checkpoint against the summary saved with it
 15. the zoo at full width (the factory's defaults: hidden 32, 5 blocks,
     scale 2, --mask): Trainer steps at batch 64 with the recipe's flags
     for every factory arch but tatt, the TSRN family and bicubic (the
     plain step, or the TATT step with two forwards for the _tl archs and
     tranSR_v4), images/s, max memory and launches per step (20/20/0/0
     for pcan, 20/20/4/2 for pcan_tl, 0/0/4/2 for the other TATT-step
     archs, none for the other plain ones), falling loss_sr for pcan and
     pcan_tl (han at lr 1e-4: it diverges at the YAML's 1e-3, in the JAX
     package too); one batch-8 step card against CPU, leaf by leaf, for
     pcan_tl (the TATT step's two-forward tssim path) and pcan (the plain
     step, edge_image_loss); Evaluator images/s for pcan; ``cli.run
     --arch=pcan`` for 4 steps, then ``--go_test`` of its best checkpoint
     against the summary saved with it
 16. the Chinese path (``--CHNSR --tpg OPT``): the shipped TPG
     (``TPGModel(num_class=3965)``, the FAN ResNet at 512, CTC over
     T=129) with seeded weights, card against CPU on 8 images (logits in
     eval mode; logits and BatchNorm statistics in train mode), its
     forward ms at batch 64; the BiLSTM variant's launches a forward and
     backward (2/2); the LSTM kernels at its L=129 R=64 H=256 (In 512 /
     256) forward and backward against their plain twins, timed beside
     cuDNN; the Attn variant's greedy ids card vs CPU (agreement printed);
     Trainer steps at full width (TATT at text_emb 3965), batch 64, the
     recipe's flags: images/s, max memory, launches per step (10/10/0/0),
     falling loss_sr; Evaluator with the teacher TPG as judge (NED,
     accuracy under the chinese filter, images/s); one batch-8 step card
     against CPU, leaf by leaf (the student's against the CPU step in
     float64, within a fixed 3e-2 that two planted faults on the card,
     TF32 and one BatchNorm's eps doubled, must exceed); the host ms a
     batch of the collate over the 3965-symbol alphabet, the CTC decode
     (argmax on the card against on the host) and the filter; ``cli.run --CHNSR --tpg OPT`` for 4 steps, then
     ``--go_test`` of its best checkpoint against the summary saved with it
The last line is the JSON object the chip check reads; the line before
it the kernels, and before that the whole run's seconds.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import copy
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

from tatt_tpu_torch.cli import main as cli  # noqa: E402
from tatt_tpu_torch.core.charset import (  # noqa: E402
    AsterInfo, ctc_collapse, ctc_greedy_decode, str_filt, voc_table,
)
from tatt_tpu_torch.core.checkpoint import (  # noqa: E402
    load_checkpoint, restore_checkpoint, save_checkpoint,
)
from tatt_tpu_torch.core.config import Config, Flags  # noqa: E402
from tatt_tpu_torch.core.convert import from_jax, load_npz  # noqa: E402
from tatt_tpu_torch.core.device import set_cuda_flags  # noqa: E402
from tatt_tpu_torch.data.lmdb_dataset import LmdbTextDataset  # noqa: E402
from tatt_tpu_torch.data.loader import DataLoader  # noqa: E402
from tatt_tpu_torch.data.lmdb_lite import write_lmdb  # noqa: E402
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset  # noqa: E402
from tatt_tpu_torch.kernels import _build  # noqa: E402
from tatt_tpu_torch.data.collate import collate  # noqa: E402
from tatt_tpu_torch.kernels.gru import (  # noqa: E402
    bigru_bwd_plan, bigru_fwd_plan, bigru_recurrence, bigru_recurrence_bwd,
    bigru_recurrence_bwd_ref, bigru_recurrence_ref,
)
from tatt_tpu_torch.kernels.lstm import (  # noqa: E402
    bilstm_bwd_plan, bilstm_fwd_plan, bilstm_recurrence, bilstm_recurrence_bwd,
    bilstm_recurrence_bwd_ref, bilstm_recurrence_ref, kernels_serve, served_hidden,
)
from tatt_tpu_torch.kernels.ctc import ctc_loss  # noqa: E402
from tatt_tpu_torch.kernels.rnn import BiGRU, BiLSTM, compose_input_projection  # noqa: E402
from tatt_tpu_torch.losses.perceptual import VGG16Features, lpips_vgg  # noqa: E402
from tatt_tpu_torch.models.common import init_parameters  # noqa: E402
from tatt_tpu_torch.models.recognizers.aster import AsterRecognizer, parse_aster_input  # noqa: E402
from tatt_tpu_torch.models.recognizers.crnn import CRNN, parse_crnn_input  # noqa: E402
from tatt_tpu_torch.models.recognizers.moran import MORAN, parse_moran_input  # noqa: E402
from tatt_tpu_torch.models.factory import (  # noqa: E402
    ABLATION_SET, arch_steps, build_generator, recognizer_spec,
)
from tatt_tpu_torch.models.recognizers.tpg import TPGModel  # noqa: E402
from tatt_tpu_torch.models.tsrn import TATT, TSRN  # noqa: E402
from tatt_tpu_torch.train.judge import make_judge  # noqa: E402
from tatt_tpu_torch.train.loop import (  # noqa: E402
    Evaluator, Trainer, copies, make_summary_writer, step_config, to_device,
)
from tatt_tpu_torch.train.pretrain import (  # noqa: E402
    encode_ctc_targets, hr_crops, pretrain_recognizer, word_accuracy,
)
from tatt_tpu_torch.losses.image import image_loss  # noqa: E402
from tatt_tpu_torch.train.steps import (  # noqa: E402
    StepConfig, eval_step, plain_train_step, train_step,
)

HERE = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(HERE, "tests", "assets", "fixture_crnn.npz")
DEV = torch.device("cuda")
BATCH = 64
# f32 kernel vs plain f32 on the same card: the two differ only in the
# summation order of each step's matvec (~1e-7 relative), which the gates
# contract over the sequence
KERNEL_ATOL = 1e-5
# the whole generator, card (cuDNN convs in full f32, the kernels) vs CPU
# (oneDNN convs, the plain recurrences): ~40 layers of f32 arithmetic in
# different orders, each ~1e-6 relative on activations of order 1-10
SR_ATOL = 2e-4
# backward kernel vs plain twin, each error over the largest |value| of its
# output (at least 1): d(gates) repeat the per-step f32 maths (1e-5); the
# weight and bias gradients sum over every (row, step) pair, up to 131,072
# of them, in another order (1e-4)
DGATES_TOL, DW_TOL = 1e-5, 1e-4
# one full-width train step at batch 8, card vs CPU, leaf by leaf:
# ||card - CPU|| / ||CPU|| of each parameter's gradient, the CPU norm
# floored at LEAF_FLOOR of the model's largest leaf norm (a leaf whose
# gradient vanishes analytically, a conv bias before train-mode BatchNorm,
# holds only rounding noise).  The leaves of the BiGRUs and BiLSTMs, where
# a kernel fault shows first, within RNN_LEAF_TOL; the rest within
# LEAF_TOL: the CRNN's max pools with overlapping windows (stride 1 along
# the width) route a gradient to the other of two near-equal inputs when
# rounding flips their order, and one such flip moves ~2e-3 of the norm of
# the first convs' gradients (printed beside the float32-vs-float64
# readings of the CPU step itself)
LEAF_FLOOR, RNN_LEAF_TOL, LEAF_TOL = 1e-2, 1e-4, 1e-2
STEP_BATCH = 8
PROFILE_STEPS = 5
TRAIN_WARM, TRAIN_STEPS = 5, 30
# per train step, fused tssim: 5 GruBlocks x (gru1, gru2) forward and
# backward; the student's two BiLSTMs forward (with c) and backward, the
# frozen teacher's two forward only
STEP_LAUNCHES = {"bigru_fwd": 10, "bigru_bwd": 10, "bilstm_fwd": 4, "bilstm_bwd": 2}
COUNTERS = {
    "bigru_fwd": bigru_recurrence, "bigru_bwd": bigru_recurrence_bwd,
    "bilstm_fwd": bilstm_recurrence, "bilstm_bwd": bilstm_recurrence_bwd,
}
# the GRU backward's device entries (csrc/bigru_bwd.cu), by what each does
GRU_BWD_ENTRIES = {"recurrence": "bigru_bwd_rec", "dw": "bigru_bwd_dw", "sums": "sum_partials"}
# the LSTM backward's device entries (csrc/bilstm_bwd.cu)
LSTM_BWD_ENTRIES = {"gates": "bilstm_bwd_gates", "recurrence": "bilstm_bwd_rec",
                    "dw": "bilstm_bwd_dw"}
# phase 10, the real-data path: the recipe's flags, two train LMDBs and a
# val LMDB (100 images: one full batch of 64 and a short one), checkpoints
# and validation every 4 of 8 steps, a resume at the finetune stage's lr
RECIPE = ["--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
          "--stu_iter=1", "--rotate_train=5.0", "--tssim_loss", "--test_model=CRNN"]
DATA_TRAIN_N, DATA_VAL_N = 160, 100
DATA_ITERS, DATA_INTERVAL, DATA_WORKERS = 8, 4, 4
RESUME_LR = 2e-4
# the resumed run against the uninterrupted one: the first step's forward
# reads only restored weights and the kernels are bitwise-repeatable; the
# second reads Adam's update, where a cuDNN weight-gradient engine may sum
# in another order (~1e-7 relative)
LOSS_RTOL = 1e-6
# --go_test of the best checkpoint against the summary saved with it: the
# same weights and batches on the same card, metrics summed in float32
GO_TEST_PSNR_TOL, GO_TEST_SSIM_TOL = 0.01, 1e-4
# phase 11, CTC pretraining: the port's CTC loss card vs CPU (values, and
# each sample's gradient over its largest entry: the same float32 maths in
# another order, ~1e-6, where 1e30 entries hold integer-valued weights);
# the full-width CRNN at pretraining's batch; the fixture judge's recipe
# (experiments/train_fixture_judge.py) cut from JUDGE_STEPS to
# JUDGE_RUN_STEPS, after at most JUDGE_RENDER_S of rendering its training
# crops (in worker processes).  The cut is a step count, not a time: the
# recipe sits on the CTC plateau (loss ~19.3) until ~1,000 steps and has
# left it by 2,500 in 2 of 4 runs (scripts/judge_spread_torch.py), and its
# gate compares the loss of the run's first and last eighths, whose ratio
# on the plateau falls as the step count grows: 2.2x at 495 steps, 1.8x
# at 876 (step counts that a time budget once gave)
CTC_TOL = 1e-4
PRETRAIN_BATCH, PRETRAIN_STEPS = 128, 40
JUDGE_NH, JUDGE_NM = 64, (16, 32, 64, 64, 128, 128, 128)
JUDGE_STEPS, JUDGE_RUN_STEPS, JUDGE_TRAIN_N, JUDGE_RENDER_S = 4000, 480, 16384, 10.0
# phase 12, the TATT step's flags: Trainer steps at full width, batch 64,
# each set on top of the recipe, and launches per step from the code: the
# fused 2B forward once per stu_iter iteration (10 BiGRU forward and
# backward each), the teacher's two BiLSTMs forward, each iteration's
# student two forward (with c) and, where a loss reaches it, two backward.
# 45 timed steps: after 30 the falling-loss_sr gate's last-5 median of
# training_stablize + ssim_loss read 0.54-0.96x that of steps 2-4 over 5
# runs of the whole script, and under 0.7x after 45 in every run of
# scripts/loss_gate_margins.py
FLAG_WARM, FLAG_STEPS = 2, 45
FLAG_SETS = {
    "recipe": ({}, STEP_LAUNCHES),
    "use_label": ({"use_label": True}, STEP_LAUNCHES),
    "stu_iter=2, separate copies, for_cascading": (
        {"stu_iter": 2, "sr_share": False, "for_cascading": True},
        {"bigru_fwd": 20, "bigru_bwd": 20, "bilstm_fwd": 6, "bilstm_bwd": 4}),
    "learning_STN": ({"learning_STN": True}, STEP_LAUNCHES),
    "training_stablize + ssim_loss": ({"training_stablize": True, "ssim_loss": True}, STEP_LAUNCHES),
    "y_domain": ({"y_domain": True}, STEP_LAUNCHES),
    "rotate_train=0": ({"rotate_train": 0.0}, STEP_LAUNCHES),
    # no tssim: one forward of B; no distillation: no loss reaches the student
    "no use_distill / gradient / tssim_loss": (
        {"use_distill": False, "gradient": False, "tssim_loss": False},
        {"bigru_fwd": 10, "bigru_bwd": 10, "bilstm_fwd": 4, "bilstm_bwd": 0}),
}
# phase 13, the judges: the val batch of scripts/test_TATT.sh; ASTER's
# 97 classes (voc "all" + EOS, PADDING, UNKNOWN); ASTER's encoder BiLSTM
# (two layers, In 512 then 2H = 512) and MORAN's rnn0 / rnn1 (In 512 /
# 256), each L=25 (the CNN's width) and H=256, one launch each per call
JUDGE_BATCH, JUDGE_EVAL_N, JUDGE_DEMO_N, JUDGE_N_VIS = 50, 256, 8, 10
JUDGE_LAUNCHES = {"ASTER": 2, "MORAN": 2, "CRNN": 2}
# a judge on the card (cuDNN convs, the kernel) against the same on the
# CPU (oneDNN convs, the plain recurrence): ResNet trunks of ~50 layers,
# the STN / MORN resampling and the BiLSTMs in float32, each error over
# the largest |value| (at least 1)
JUDGE_TOL = 1e-3
# phase 14, the TSRN family: Trainer steps at full width, batch 64, with
# the recipe's flags (use_distill acts in the TATT step only), and
# launches per step from the code: the plain step runs two forwards of B
# (sr, and sr_ret for tssim) and backward through both, with no CRNN;
# the TL archs run the TATT step's fused 2B forward (STEP_LAUNCHES);
# SEM_TSRN's blocks hold no recurrence
# 40 timed steps: loss_sr varies ~2x batch to batch and a seed's
# trajectory differs run to run from about the fifth step, so after 25
# steps the gate's last-5 median of tsrn / tsrn_tl_cascade read up to
# 0.75x / 0.92x that of steps 2-4 over 5 runs, after 45 up to 0.67x /
# 0.55x (scripts/loss_gate_margins.py)
TSRN_WARM, TSRN_STEPS = 5, 40
PLAIN_LAUNCHES = {"bigru_fwd": 20, "bigru_bwd": 20, "bilstm_fwd": 0, "bilstm_bwd": 0}
TSRN_ARCHS = {
    "tsrn": PLAIN_LAUNCHES,
    "tsrn_c2f": PLAIN_LAUNCHES,
    "sem_tsrn": {"bigru_fwd": 0, "bigru_bwd": 0, "bilstm_fwd": 0, "bilstm_bwd": 0},
    "tsrn_tl_cascade": STEP_LAUNCHES,
    "tsrn_tl_cascade_sft": STEP_LAUNCHES,
}
TSRN_RECIPE = dict(STN=True, mask=True, use_distill=True, gradient=True, sr_share=True,
                   tssim_loss=True, rotate_train=5.0)
# the batch-8 tsrn step with --tssim_loss --mse_fuse: sr and sr_ret forward
# and backward, the mse_fuse target forward only
PLAIN_MSE_FUSE_LAUNCHES = {"bigru_fwd": 30, "bigru_bwd": 20, "bilstm_fwd": 0, "bilstm_bwd": 0}
TSRN_CLI_ITERS = 4
# phase 15, the zoo: Trainer steps at full width (the factory's defaults:
# hidden 32, 5 blocks, scale 2, --mask), batch 64, the recipe's flags, for
# every arch of the factory but tatt and the TSRN family (phases 7, 14) and
# bicubic (nothing to train).  Launches per step from the code: PCAN's 5
# PCABs run 2 GruBlocks each, 10 BiGRUs a forward; the plain step runs two
# forwards of B (sr, sr_ret) with backward through both and no CRNN; the
# zoo's _tl archs take the TATT step with two forwards of B (JAX fuses only
# the archs with bn_copies), the teacher's two BiLSTMs forward and the
# student's two forward and backward; the TP Interpreter's query GRU
# (hidden 512) is a plain loop, as in JAX
ZOO_PLAIN = {"bigru_fwd": 0, "bigru_bwd": 0, "bilstm_fwd": 0, "bilstm_bwd": 0}
ZOO_TL = {"bigru_fwd": 0, "bigru_bwd": 0, "bilstm_fwd": 4, "bilstm_bwd": 2}
ZOO_ARCHS = {
    **{a: ZOO_PLAIN for a in ("srcnn", "vdsr", "scgan", "srres", "edsr", "lapsrn", "rdn",
                              "esrgan", "han", "tbsrn")},
    **{a: ZOO_TL for a in ("srcnn_tl", "vdsr_tl", "scgan_tl", "srresnet_tl", "rdn_tl",
                           "esrgan_tl", "tbsrn_tl", "tranSR_v4")},
    "pcan": PLAIN_LAUNCHES,
    "pcan_tl": {"bigru_fwd": 20, "bigru_bwd": 20, "bilstm_fwd": 4, "bilstm_bwd": 2},
}
# warm-up and timed steps: PCAN and PCAN_TL (the kernels' archs) long
# enough for phase 12's falling-loss_sr gate, the rest a few.  After 25
# steps pcan_tl's last-5 median read 6.0-9.3 over 5 runs against 12.3-14.0
# for steps 2-4, and once 12.36 against 12.27 (a run the gate stopped);
# after 45 it read 4.2-5.3 (scripts/loss_gate_margins.py)
ZOO_WARM, ZOO_STEPS = 2, 3
ZOO_GATED, ZOO_GATED_WARM, ZOO_GATED_STEPS = ("pcan", "pcan_tl"), 5, 40
ZOO_CLI_ITERS = 4
# HAN at the YAML's lr 1e-3 diverges after its first Adam step, in the JAX
# package and the port alike (scripts/han_lr_divergence.py on the CPU; on
# the card loss_sr 11.8 -> 3.0e10 -> 8.8e27 -> nan): the phase trains it at
# the HAN paper's 1e-4
ZOO_LR = {"han": 1e-4}
# phase 16, the Chinese path (--CHNSR --tpg OPT): the TPG's 3965 classes;
# its card-vs-CPU checks on 8 images (a full-width CPU forward of 64 takes
# tens of seconds); launches per train step: the generator's fused 2B
# forward and backward (10 BiGRUs each), no recurrence in the TPG (its
# default sequence stage is "None"); Trainer steps as phase 14's
N_CHINESE = 3965
CHINESE_CHECK_BATCH = 8
CHINESE_LAUNCHES = {"bigru_fwd": 10, "bigru_bwd": 10, "bilstm_fwd": 0, "bilstm_bwd": 0}
CHINESE_WARM, CHINESE_STEPS, CHINESE_CLI_ITERS = 5, 40, 4
# the batch-8 step's student: its gradient comes from the distillation
# loss, whose margin term's sign flips where the seeded teacher's and
# student's near-uniform probabilities over 3965 classes (~2.5e-4) differ
# by less than rounding, and through train-mode BatchNorm, which makes the
# extractor's gradient ill-conditioned: float32 rounding alone moves the
# first convs and BatchNorm 8.2e-3-1.3e-2 (the CPU's float32 step against
# its float64 one; tests/test_torch_chinese.py holds the same gradient at
# 3e-2).  So each student leaf of the card's step is held against the
# CPU's float64 step within the fixed STUDENT_LEAF_TOL, and two planted
# faults on the card, TF32 convolutions and matmuls and one BatchNorm's eps
# doubled (FeatureExtraction.conv0_1_bn, 1e-5 -> 2e-5), must read above it
STUDENT_LEAF_TOL = 3e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def fail(msg: str) -> None:
    """Stop the run: a failed phase ends it, with no result line."""
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call, CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(kind: str, length: int, rows: int, hid: int, backward: bool = False):
    """Least time (ms) for one launch, and what sets it: each input read
    once and each output written once at the HBM rate, or the float32
    operations (matvec multiply-adds as 2, each gate nonlinearity and
    elementwise op as 1) at the f32 peak.  Forward: gates in, h out (and
    weights).  Backward: gates, h, dy (and the LSTM's c) in, d(gates) out,
    weights in and their gradients out; per row-step three matvec-sized
    products (the gate recompute, W^T d(gates), d(gates) h_prev^T)."""
    g = (3 if kind == "gru" else 4) * hid
    seq = length * rows * 2 * hid  # one [.., 2H] sequence
    weights = 2 * g * hid + 2 * g
    if backward:
        n_seq = 2 if kind == "gru" else 3  # h, dy (, c)
        nbytes = 4 * (2 * 2 * length * rows * g + n_seq * seq + 2 * weights
                      + (2 * g if kind == "gru" else 0))  # the GRU's input-bias grad
        per_row_step = 3 * 2 * g * hid + (30 if kind == "gru" else 24) * hid
    else:
        nbytes = 4 * (2 * length * rows * g + seq + weights)
        per_row_step = 2 * g * hid + (14 if kind == "gru" else 12) * hid
    flops = 2 * length * rows * per_row_step
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def scaled_err(got, want) -> float:
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def _gru_weights(length, rows, cin, cmid, hid, gen):
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=gen).mul_(sc).to(DEV)  # noqa: E731
    x = rnd(rows, length, cin)
    pre_k, pre_b = rnd(cmid, cin, sc=cin**-0.5), rnd(cmid, sc=0.1)
    b = hid**-0.5
    w_ih, w_hh = rnd(2, 3 * hid, cmid, sc=b), rnd(2, 3 * hid, hid, sc=b)
    b_ih, b_hh = rnd(2, 3 * hid, sc=b), rnd(2, 3 * hid, sc=b)
    w_eff, b_eff = compose_input_projection(w_ih, b_ih, pre_k, pre_b)
    gates = (torch.einsum("rli,dgi->dlgr", x, w_eff) + b_eff[:, None, :, None]).contiguous()
    return x, w_eff, b_eff, w_hh, b_hh, gates


def _library_rnn(cls, cin, hid, w_ih, w_hh, b_ih, b_hh):
    lib = cls(cin, hid, bidirectional=True, batch_first=True).to(DEV)
    with torch.no_grad():
        for d, sfx in enumerate(("l0", "l0_reverse")):
            getattr(lib, f"weight_ih_{sfx}").copy_(w_ih[d])
            getattr(lib, f"weight_hh_{sfx}").copy_(w_hh[d])
            getattr(lib, f"bias_ih_{sfx}").copy_(b_ih[d])
            getattr(lib, f"bias_hh_{sfx}").copy_(b_hh[d])
    return lib


def _library_fwd_bwd(lib, x, dy):
    """One cuDNN forward + backward of the same function (a yardstick)."""
    xg = x.detach().requires_grad_()
    torch.autograd.grad(lib(xg)[0], [xg, *lib.parameters()], dy)


def check_gru(name, length, rows, cin, cmid, hid, gen):
    """gates as GruBlock makes them: x [R, L, Cin] through the folded 1x1
    conv into the input projection."""
    x, w_eff, b_eff, w_hh, b_hh, gates = _gru_weights(length, rows, cin, cmid, hid, gen)
    out = bigru_recurrence(gates, w_hh, b_hh)
    ref = bigru_recurrence_ref(gates, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    lib = _library_rnn(torch.nn.GRU, cin, hid, w_eff, w_hh, b_eff, b_hh)
    lib_err = (lib(x)[0] - ref.permute(2, 0, 1)).abs().max().item()
    kernel = kernel_time(lambda: bigru_recurrence(gates, w_hh, b_hh), "bigru_fwd")
    # one step alone: set-up (W_hh into shared memory) plus one step
    first = gates[:, :1].contiguous()
    one_step = kernel_time(lambda: bigru_recurrence(first, w_hh, b_hh), "bigru_fwd")
    # the two passes before the kernel on the module's path (rnn.BiGRU): the
    # input projection, then its bias into a contiguous gates tensor
    xw = torch.einsum("rli,dgi->dlgr", x, w_eff)
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin, max_abs_err=err, tol=KERNEL_ATOL,
        kernel_ms=kernel["ms"], kernel_event_ms=kernel["event_ms"],
        kernel_profiler_ms=kernel["profiler_ms"], one_step_ms=one_step["ms"],
        projection_ms=timed_ms(lambda: torch.einsum("rli,dgi->dlgr", x, w_eff), 50),
        bias_ms=timed_ms(lambda: (xw + b_eff[:, None, :, None]).contiguous(), 50),
        plain_ms=timed_ms(lambda: bigru_recurrence_ref(gates, w_hh, b_hh), 5),
        library_ms=timed_ms(lambda: lib(x), 50), library_err=lib_err,
        plan=bigru_fwd_plan(hid, rows),
    )
    row["bound_ms"], row["bound_by"] = bound("gru", length, rows, hid)
    return row


def print_gru(row) -> None:
    """A forward BiGRU shape's launch, its time a step ((launch - launch at
    L=1) / (L - 1)), the passes before it, and its plan."""
    step_us = (row["kernel_ms"] - row["one_step_ms"]) / (row["L"] - 1) * 1e3
    print(f"[gru] {row['shape']}: kernel {row['kernel_ms']:.4f} ms (events "
          f"{row['kernel_event_ms']:.4f}, profiler {row['kernel_profiler_ms']}); at L=1 "
          f"{row['one_step_ms']:.4f} ms; {step_us:.2f} us a step; bound {row['bound_ms']:.4f} ms; "
          f"before it: projection {row['projection_ms']:.4f} + bias {row['bias_ms']:.4f} ms; "
          f"nn.GRU {row['library_ms']:.4f} ms; plan {json.dumps(row['plan'])}")


def _lstm_weights(length, rows, cin, hid, gen):
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=gen).mul_(sc).to(DEV)  # noqa: E731
    b = hid**-0.5
    x = rnd(rows, length, cin)
    w_ih, w_hh = rnd(2, 4 * hid, cin, sc=b), rnd(2, 4 * hid, hid, sc=b)
    b_ih, b_hh = rnd(2, 4 * hid, sc=b), rnd(2, 4 * hid, sc=b)
    gates = torch.matmul(x, w_ih.transpose(1, 2)[:, None]) + b_ih[:, None, None]
    return x, w_ih, w_hh, b_ih, b_hh, gates


def self_ms_by_name(fn, kernels, iters: int) -> dict:
    """For each name in ``kernels``, the mean self device time (ms) per call
    of the device kernels whose name holds it, from one profiler window over
    ``iters`` calls of ``fn`` (after warm-up); None when the profiler
    records no device time for it, or records its launches other than a
    whole number of times a call (a window that dropped records has read a
    forward launch at a third of its CUDA-event time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {}
    for k in kernels:
        hits = [e for e in events if k in e.key]
        total, count = sum(e.self_device_time_total for e in hits), sum(e.count for e in hits)
        out[k] = total / 1e3 / iters if total > 0 and count % iters == 0 else None
    return out


def kernel_self_ms(fn, kernel: str, iters: int):
    """Mean self device time (ms) per call of the device kernels whose name
    holds ``kernel`` (see :func:`self_ms_by_name`)."""
    return self_ms_by_name(fn, (kernel,), iters)[kernel]


def kernel_time(fn, kernel: str) -> dict:
    """A kernel's time per launch two ways: CUDA events around 50
    back-to-back calls (which, at tens of us a launch, may time the Python
    wrapper rather than the card) and the kernel's own device time in a
    profiler window; ``ms`` is the smaller."""
    event_ms = timed_ms(fn, 50)
    prof_ms = kernel_self_ms(fn, kernel, 20)
    return {"ms": event_ms if prof_ms is None else min(event_ms, prof_ms),
            "event_ms": event_ms, "profiler_ms": prof_ms}


def check_lstm(name, length, rows, cin, hid, gen):
    """The forward kernel against its plain version, timed without and
    with the cell states (training asks for them in half its launches),
    beside the input projection that runs before it and cuDNN's
    ``nn.LSTM``, which includes that projection."""
    x, w_ih, w_hh, b_ih, b_hh, gates = _lstm_weights(length, rows, cin, hid, gen)
    out = bilstm_recurrence(gates, w_hh, b_hh)
    ref = bilstm_recurrence_ref(gates, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    lib = _library_rnn(torch.nn.LSTM, cin, hid, w_ih, w_hh, b_ih, b_hh)
    lib_err = (lib(x)[0] - ref).abs().max().item()
    no_cs = kernel_time(lambda: bilstm_recurrence(gates, w_hh, b_hh), "bilstm_fwd")
    with_cs = kernel_time(lambda: bilstm_recurrence(gates, w_hh, b_hh, with_cs=True), "bilstm_fwd")
    # one step alone: set-up (W_hh into shared memory) plus one step, so that
    # (kernel_ms - one_step_ms) / (L - 1) is the time of a step
    first = gates[:, :, :1].contiguous()
    one_step = kernel_time(lambda: bilstm_recurrence(first, w_hh, b_hh), "bilstm_fwd")
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin, max_abs_err=err, tol=KERNEL_ATOL,
        kernel_ms=no_cs["ms"], kernel_event_ms=no_cs["event_ms"],
        kernel_profiler_ms=no_cs["profiler_ms"], kernel_cs_ms=with_cs["ms"],
        one_step_ms=one_step["ms"],
        projection_ms=timed_ms(
            lambda: torch.matmul(x, w_ih.transpose(1, 2)[:, None]) + b_ih[:, None, None], 50),
        plain_ms=timed_ms(lambda: bilstm_recurrence_ref(gates, w_hh, b_hh), 5),
        library_ms=timed_ms(lambda: lib(x), 50), library_err=lib_err,
    )
    row["bound_ms"], row["bound_by"] = bound("lstm", length, rows, hid)
    return row


def check_gru_bwd(name, length, rows, cin, cmid, hid, gen):
    """The backward kernel against its plain twin on the forward's saved
    h and a random dL/dout; every output: d(gates), dW_hh, db_hh and the
    input-bias gradient."""
    x, w_eff, b_eff, w_hh, b_hh, gates = _gru_weights(length, rows, cin, cmid, hid, gen)
    out = bigru_recurrence_ref(gates, w_hh, b_hh)
    dout = torch.randn(out.shape, generator=gen).to(DEV)
    got = bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout)
    want = bigru_recurrence_bwd_ref(gates, w_hh, b_hh, out, dout)
    torch.cuda.synchronize()
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    lib = _library_rnn(torch.nn.GRU, cin, hid, w_eff, w_hh, b_eff, b_hh)
    dy = dout.permute(2, 0, 1).contiguous()
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin,
        max_abs_err=max((g - w).abs().max().item() for g, w in zip(got, want)),
        scaled_err={k: e for k, e in zip(("dgates", "dw_hh", "db_hh", "dbx"), errs)},
        ok=errs[0] <= DGATES_TOL and max(errs[1:]) <= DW_TOL,
        kernel_ms=timed_ms(lambda: bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout), 20),
        plain_ms=timed_ms(lambda: bigru_recurrence_bwd_ref(gates, w_hh, b_hh, out, dout), 2),
        library_ms=timed_ms(lambda: _library_fwd_bwd(lib, x, dy), 20),
    )
    row["bound_ms"], row["bound_by"] = bound("gru", length, rows, hid, backward=True)
    # device time by entry, and of a launch at L=1 (set-up, one step, and the
    # weight-gradient pass over one step's rows)
    row["split_ms"] = self_ms_by_name(
        lambda: bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout), GRU_BWD_ENTRIES.values(), 20)
    g1, o1, d1 = gates[:, :1].contiguous(), out[:1].contiguous(), dout[:1].contiguous()
    row["one_step_split_ms"] = self_ms_by_name(
        lambda: bigru_recurrence_bwd(g1, w_hh, b_hh, o1, d1), GRU_BWD_ENTRIES.values(), 20)
    row["plan"] = bigru_bwd_plan(hid, rows)
    return row


def print_bwd_split(tag: str, row, entries: dict) -> None:
    """A backward kernel's launch by entry, and its time a step: (device
    time of the recurrence - the same at L=1) / (L - 1)."""
    split = {k: row["split_ms"][v] for k, v in entries.items()}
    one = {k: row["one_step_split_ms"][v] for k, v in entries.items()}
    if None in split.values() or None in one.values():
        print(f"[{tag}] {row['shape']}: the profiler recorded no device time for an entry: "
              f"{split} / L=1 {one}")
        return
    step_us = (split["recurrence"] - one["recurrence"]) / (row["L"] - 1) * 1e3
    parts = " + ".join(f"{k} {v:.4f}" for k, v in split.items())
    print(f"[{tag}] {row['shape']}: launch {row['kernel_ms']:.4f} ms (events), device "
          f"{sum(split.values()):.4f} ms = {parts}; at L=1 device "
          f"{sum(one.values()):.4f} ms (recurrence {one['recurrence']:.4f}); "
          f"{step_us:.2f} us a step; plan {json.dumps(row['plan'])}")


def check_lstm_bwd(name, length, rows, cin, hid, gen):
    """The backward kernel against its plain twin (d(gates), dW_hh,
    db_hh), and the forward kernel's cell states against the plain c."""
    x, w_ih, w_hh, b_ih, b_hh, gates = _lstm_weights(length, rows, cin, hid, gen)
    out, cs = bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs=True)
    k_out, k_cs = bilstm_recurrence(gates, w_hh, b_hh, with_cs=True)
    dout = torch.randn(out.shape, generator=gen).to(DEV)
    got = bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout)
    want = bilstm_recurrence_bwd_ref(gates, w_hh, b_hh, out, cs, dout)
    torch.cuda.synchronize()
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    cs_err = max((k_out - out).abs().max().item(), (k_cs - cs).abs().max().item())
    lib = _library_rnn(torch.nn.LSTM, cin, hid, w_ih, w_hh, b_ih, b_hh)
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin,
        max_abs_err=max((g - w).abs().max().item() for g, w in zip(got, want)),
        scaled_err={k: e for k, e in zip(("dgates", "dw_hh", "db_hh"), errs)},
        fwd_with_cs_err=cs_err,
        ok=errs[0] <= DGATES_TOL and max(errs[1:]) <= DW_TOL and cs_err <= KERNEL_ATOL,
        kernel_ms=timed_ms(lambda: bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout), 20),
        plain_ms=timed_ms(lambda: bilstm_recurrence_bwd_ref(gates, w_hh, b_hh, out, cs, dout), 2),
        library_ms=timed_ms(lambda: _library_fwd_bwd(lib, x, dout), 20),
    )
    row["bound_ms"], row["bound_by"] = bound("lstm", length, rows, hid, backward=True)
    # device time by entry, and of a launch at L=1 (set-up, one step, and the
    # weight-gradient pass over one step's rows)
    row["split_ms"] = self_ms_by_name(
        lambda: bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout),
        LSTM_BWD_ENTRIES.values(), 20)
    g1 = gates[:, :, :1].contiguous()
    o1, c1, d1 = (t[:, :1].contiguous() for t in (out, cs, dout))
    row["one_step_split_ms"] = self_ms_by_name(
        lambda: bilstm_recurrence_bwd(g1, w_hh, b_hh, o1, c1, d1), LSTM_BWD_ENTRIES.values(), 20)
    row["plan"] = bilstm_bwd_plan(hid, rows)
    return row


def check_lstm_module(name, length, rows, cin, hid, gen):
    """The BiLSTM module at a hidden size its kernels refuse: the H it runs
    them at (the next one they serve, decided from their plan queries
    before any launch, the layer counted in ``BiLSTM.padded_layers``; one
    forward and one backward launch), its forward and backward against
    the same module on the CPU (the plain twins at the true H), and its
    times beside the plain twins on the card and cuDNN's ``nn.LSTM`` on
    the same weights."""
    layer = init_parameters(BiLSTM(cin, hid), 5)
    x = torch.randn(rows, length, cin, generator=gen)
    w = torch.randn(rows, length, 2 * hid, generator=gen)
    xd, wd = x.to(DEV), w.to(DEV)
    card = copy.deepcopy(layer).to(DEV)

    def fwd_bwd(module, xs, ws):
        xg = xs.detach().clone().requires_grad_()
        module.zero_grad()
        out = module(xg)
        (out * ws).sum().backward()
        return out.detach(), xg.grad, [p.grad for p in module.parameters()]

    want = fwd_bwd(layer, x, w)
    padded_before, launches_before = BiLSTM.padded_layers, read_counts()
    got = fwd_bwd(card, xd, wd)
    torch.cuda.synchronize()
    wide = served_hidden(hid, DEV)
    path = f"kernels at H={wide}" if BiLSTM.padded_layers == padded_before + 1 else "kernels"
    launched = {k: v - launches_before[k] for k, v in read_counts().items()}
    errs = {"out": (got[0].cpu() - want[0]).abs().max().item(),
            "d_input": scaled_err(got[1].cpu(), want[1]),
            "d_weights": max(scaled_err(g.cpu(), r) for g, r in zip(got[2], want[2]))}
    w_ih, w_hh, b_ih, b_hh = (t.detach() for t in card.stacked())
    gates = torch.matmul(xd, w_ih.transpose(1, 2)[:, None]) + b_ih[:, None, None]
    out, cs = bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs=True)
    lib = _library_rnn(torch.nn.LSTM, cin, hid, w_ih, w_hh, b_ih, b_hh)
    with torch.no_grad():
        fwd = {"module_ms": timed_ms(lambda: card(xd), 5),
               "plain_ms": timed_ms(lambda: bilstm_recurrence_ref(gates, w_hh, b_hh), 5),
               "library_ms": timed_ms(lambda: lib(xd), 20)}
    fwd_bwd_ms = {"module_ms": timed_ms(lambda: fwd_bwd(card, xd, wd), 5),
                  "plain_ms": timed_ms(lambda: bilstm_recurrence_bwd_ref(
                      gates, w_hh, b_hh, *bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs=True),
                      wd), 5),
                  "library_ms": timed_ms(lambda: _library_fwd_bwd(lib, xd, wd), 20)}
    row = dict(shape=name, L=length, R=rows, H=hid, In=cin, served_by_kernels=kernels_serve(hid, DEV),
               path=path, kernel_launches=launched, errs=errs, forward=fwd,
               forward_backward=fwd_bwd_ms)
    row["ok"] = (wide > hid and path == f"kernels at H={wide}" and not row["served_by_kernels"]
                 and launched == {"bigru_fwd": 0, "bigru_bwd": 0, "bilstm_fwd": 1, "bilstm_bwd": 1}
                 and errs["out"] <= KERNEL_ATOL and errs["d_input"] <= KERNEL_ATOL
                 and errs["d_weights"] <= DW_TOL)
    del out, cs
    return row


def profile_window(fn, label: str) -> None:
    """Device busy time, idle share and the top kernels of one call of
    ``fn`` under the profiler (device kernels only: an operator's device
    time repeats its kernels')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)  # ranges such as Optimizer.step
    ]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy <= 0:
        print(f"[profile] {label}: the profiler recorded no device time: not measured")
        return
    print(f"[profile] {label}: wall {window * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"(idle share {max(0.0, 1 - busy / (window * 1e3)):.3f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def leaf_errors(ref: dict, got: dict) -> dict:
    """name -> ||got - ref|| / max(||ref||, floor) per leaf."""
    floor = LEAF_FLOOR * max(g.norm().item() for g in ref.values())
    return {k: (got[k] - g).norm().item() / max(g.norm().item(), floor) for k, g in ref.items()}


def rnn_leaves(model) -> set:
    """Names of the parameters of the model's BiGRU and BiLSTM layers."""
    return {f"{m_name}.{p_name}" for m_name, m in model.named_modules()
            if isinstance(m, (BiGRU, BiLSTM)) for p_name, _ in m.named_parameters()}


def load_judge():
    variables, meta = load_npz(ASSET)
    judge = CRNN(nh=int(meta["nh"]), nm=tuple(int(v) for v in meta["nm"]))
    judge.load_state_dict(from_jax(variables))
    return judge.eval()


def backward_kernels(gen, lstm_only: bool = False):
    """Phase 6: each backward kernel against its plain twin at the training
    path's shapes (and the LSTM's at the judge's H=64 and an odd H); fails
    the run on a disagreement.  ``lstm_only``: the LSTM backward alone."""
    gru_bwd_rows = [] if lstm_only else [
        check_gru_bwd("gru1, fused train batch 2B", 16, 2 * BATCH * 64, 128, 64, 32, gen),
        check_gru_bwd("gru2, fused train batch 2B", 64, 2 * BATCH * 16, 64, 64, 32, gen),
        check_gru_bwd("gru1 ragged rows", 16, 2 * BATCH * 64 + 3, 128, 64, 32, gen),
        # the plain step's two forwards of B (phase 14): its SRB's gru1
        # reads the residual alone, 64 channels
        check_gru_bwd("gru1, plain step batch B", 16, BATCH * 64, 64, 64, 32, gen),
        check_gru_bwd("gru2, plain step batch B", 64, BATCH * 16, 64, 64, 32, gen),
    ]
    lstm_bwd_rows = [
        check_lstm_bwd("student rnn0", 26, BATCH, 512, 256, gen),
        check_lstm_bwd("student rnn1", 26, BATCH, 256, 256, gen),
        check_lstm_bwd("student rnn0 ragged rows", 26, BATCH - 3, 512, 256, gen),
        check_lstm_bwd("judge rnn0 (H=64)", 26, BATCH, 128, 64, gen),
        check_lstm_bwd("odd H=63", 26, BATCH, 128, 63, gen),
        # an odd H that an earlier design of the backward refused, though the
        # forward served it: held on every run
        check_lstm_bwd("odd H=111", 26, BATCH, 256, 111, gen),
    ]
    for row in gru_bwd_rows + lstm_bwd_rows:
        print("[kernel-bwd] " + json.dumps(row))
        if not row["ok"]:
            fail(f"backward kernel {row['shape']}: {row}")
    for row in gru_bwd_rows:
        print_bwd_split("gru-bwd", row, GRU_BWD_ENTRIES)
    for row in lstm_bwd_rows:
        print_bwd_split("lstm-bwd", row, LSTM_BWD_ENTRIES)
    # hidden sizes the LSTM kernels refuse: the module runs them at the next
    # H they serve on zero-padded weights (L and R of the CRNN head at batch 64)
    for hid in (113, 250):
        row = check_lstm_module(f"BiLSTM module H={hid}", 26, BATCH, 512, hid, gen)
        print("[lstm-module] " + json.dumps(row))
        f, fb = row["forward"], row["forward_backward"]
        print(f"[lstm-module] H={hid}: path {row['path']}; forward {f['module_ms']:.3f} ms "
              f"(plain twin {f['plain_ms']:.3f}, cuDNN {f['library_ms']:.4f}); forward + backward "
              f"{fb['module_ms']:.3f} ms (plain twin {fb['plain_ms']:.3f}, cuDNN "
              f"{fb['library_ms']:.4f})")
        if not row["ok"]:
            fail(f"BiLSTM module at H={hid}: {row}")
    return gru_bwd_rows, lstm_bwd_rows


def card_vs_cpu_step(tag: str, cfg: StepConfig, n_sr: int, n_stu: int, want_launches: dict,
                     with_f64: bool = True) -> None:
    """One full-width train step under ``cfg`` at batch 8 with ``n_sr``
    generators and ``n_stu`` students (dropout off, rotation pinned): the
    card (kernels) against the CPU (plain twins), each trainable model's
    gradient leaf by leaf with the two-tier gate; with ``with_f64`` the CPU
    step also in float64 (how far float32 rounding alone moves each
    gradient)."""
    tatt = TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True, stn=True, dropout=0.0)
    models_cpu = ([init_parameters(copy.deepcopy(tatt), 7 + 10 * i) for i in range(n_sr)]
                  + [init_parameters(CRNN(), 8 + 10 * i) for i in range(n_stu)]
                  + [init_parameters(CRNN(), 9)])
    names = [f"generator {i}" for i in range(n_sr)] + [f"student {i}" for i in range(n_stu)]
    n_train = n_sr + n_stu
    sds = SyntheticTextDataset(n=STEP_BATCH, seed=5)
    b = collate([sds[i] for i in range(STEP_BATCH)])
    rot = {"rot_arc": torch.linspace(-0.08, 0.08, STEP_BATCH),
           "rot_offs": torch.linspace(0.1, 0.9, STEP_BATCH)}
    grads = {}
    runs = [("cpu", "cpu", torch.float32), ("cpu64", "cpu", torch.float64),
            ("card", DEV, torch.float32)]
    for run, dev, dt in runs if with_f64 else runs[::2]:
        models = [copy.deepcopy(m).to(dev, dt) for m in models_cpu]
        hr, lr = to_device(b, torch.device(dev), True)
        batch = {"images_hr": hr.to(dt), "images_lr": lr.to(dt),
                 **{k: v.to(dev, dt) for k, v in rot.items()}}
        opt = torch.optim.SGD([p for m in models[:n_train] for p in m.parameters()], lr=1.0)
        reset_counts()
        t0 = time.perf_counter()
        metrics = train_step([m.train() for m in models[:n_sr]],
                             [m.train() for m in models[n_sr:n_train]], models[-1].eval(), opt,
                             batch, cfg, torch.Generator(device=dev).manual_seed(0))
        counts = read_counts()
        grads[run] = [{k: p.grad.double().cpu() for k, p in m.named_parameters()}
                      for m in models[:n_train]]
        print(f"[{tag}] {run} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps({k: v.item() for k, v in metrics.items()})} launches {json.dumps(counts)}")
    if counts != want_launches:
        fail(f"card train step launches {counts} (want {want_launches})")
    for i, (name, model) in enumerate(zip(names, models_cpu)):
        card = leaf_errors(grads["cpu"][i], grads["card"][i])
        if with_f64:
            f32 = leaf_errors(grads["cpu64"][i], grads["cpu"][i])
            card64 = leaf_errors(grads["cpu64"][i], grads["card"][i])
        rnn = rnn_leaves(model)
        for what, keys, tol in (("BiGRU/BiLSTM", rnn, RNN_LEAF_TOL),
                                ("other", set(card) - rnn, LEAF_TOL)):
            worst = sorted(keys, key=lambda k: -card[k])
            print(f"[{tag}] {name}, {len(keys)} {what} leaves, ||card - CPU|| / ||CPU|| (tol {tol}"
                  + ("; CPU float32 vs float64; card vs CPU float64):" if with_f64 else "):"))
            for k in worst[:3]:
                print(f"[{tag}]   {card[k]:.3e}  "
                      + (f"({f32[k]:.3e}; {card64[k]:.3e})  " if with_f64 else "") + k)
            bad = {k: card[k] for k in worst if not card[k] <= tol}
            if bad:
                fail(f"{name} {what} gradients card vs CPU above {tol}: {bad}")


def _encoded(img, fmt: str) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def write_textzoom(root: str, n: int, seed: int, corrupt=(), unlabeled=()) -> str:
    """A TextZoom-layout LMDB of ``n`` synthetic samples: every fourth JPEG
    (the rest PNG), every seventh HR and LR at another size than 128x32 /
    64x16 (collate resizes them), a corrupt HR image at the indices in
    ``corrupt`` and no label at those in ``unlabeled``."""
    ds = SyntheticTextDataset(n=n, seed=seed)
    records = {b"num-samples": str(n).encode()}
    for i in range(n):
        hr, lr, label = ds[i]
        if i % 7 == 3:
            hr, lr = hr.resize((120, 30)), lr.resize((72, 18))
        fmt = "JPEG" if i % 4 == 0 else "PNG"
        if i not in unlabeled:
            records[b"label-%09d" % (i + 1)] = label.encode()
        records[b"image_hr-%09d" % (i + 1)] = b"\x89PNG corrupt" if i in corrupt else _encoded(hr, fmt)
        records[b"image_lr-%09d" % (i + 1)] = _encoded(lr, fmt)
    write_lmdb(root, records)
    return root


def state_equal(model, saved: dict) -> bool:
    own = model.state_dict()
    return all(torch.equal(v.cpu(), saved[k]) for k, v in own.items())


def adam_equal(optimizer, saved: dict) -> bool:
    state = optimizer.state_dict()["state"]
    return sorted(state) == sorted(saved["state"]) and all(
        torch.equal(v.cpu(), saved["state"][i][k]) for i, st in state.items() for k, v in st.items()
    )


def data_phase(synthetic_ips) -> None:
    """Phase 10: the real-data path through the CLI (checks and numbers in
    the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        roots = [write_textzoom(os.path.join(tmp, "train1"), DATA_TRAIN_N, 11, corrupt=(10,)),
                 write_textzoom(os.path.join(tmp, "train2"), DATA_TRAIN_N, 12),
                 write_textzoom(os.path.join(tmp, "val"), DATA_VAL_N, 13, unlabeled=(5,))]
        yaml = os.path.join(tmp, "smoke.yaml")
        with open(yaml, "w") as fh:
            fh.write(
                "TRAIN:\n"
                f"  train_data_dir: ['{roots[0]}', '{roots[1]}']\n"
                f"  batch_size: {BATCH}\n  workers: {DATA_WORKERS}\n"
                f"  saveInterval: {DATA_INTERVAL}\n  ckpt_dir: '{os.path.join(tmp, 'ckpt')}'\n"
                "  VAL:\n"
                f"    val_data_dir: ['{roots[2]}']\n    valInterval: {DATA_INTERVAL}\n"
                "    crnn_pretrained: ''\n"
            )
        run_dir = os.path.join(tmp, "ckpt", "vis_smoke")
        rolling, best_path = (os.path.join(run_dir, f) for f in ("checkpoint.ckpt", "model_best_acc_0.ckpt"))
        argv = RECIPE + ["--config", yaml, "--vis_dir", "vis_smoke"]
        print(f"[data] wrote 2 x {DATA_TRAIN_N} train and {DATA_VAL_N} val samples "
              f"({sum(os.path.getsize(os.path.join(r, 'data.mdb')) for r in roots)} bytes) in "
              f"{time.perf_counter() - t0:.2f} s")

        # ---- train through the CLI, 8 steps: validation and a save at 4 and 8
        reset_counts()
        t0 = time.perf_counter()
        code, trainer = cli.run(argv + ["--max_iters", str(DATA_ITERS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        val_batches = 2 * math.ceil(DATA_VAL_N / BATCH)  # two validations
        want = {"bigru_fwd": DATA_ITERS * 10 + val_batches * 10, "bigru_bwd": DATA_ITERS * 10,
                "bilstm_fwd": DATA_ITERS * 4 + val_batches * 8, "bilstm_bwd": DATA_ITERS * 2}
        print(f"[data] cli.run {DATA_ITERS} steps and 2 validations in {wall:.2f} s, launches "
              f"{json.dumps(counts)} (want {DATA_ITERS} steps x "
              f"{json.dumps(STEP_LAUNCHES)} + {val_batches} eval batches x 10 / 8)")
        if code != 0 or counts != want:
            fail(f"cli training: exit {code}, launches {counts} (want {want})")
        if not (os.path.exists(rolling) and os.path.exists(best_path)):
            fail(f"checkpoints missing: {sorted(os.listdir(run_dir))}")
        saved = load_checkpoint(rolling)
        iterators = [c["iterator"] for c in saved["converge"]]
        n_params = len(list(trainer.optimizer.param_groups[0]["params"]))
        moments = [bool(s["exp_avg"].any() and s["exp_avg_sq"].any())
                   for s in saved["optimizer"]["state"].values()]
        print(f"[data] checkpoint.ckpt: iters {saved['iters']}, converge {iterators}, "
              f"Adam state for {len(moments)} of {n_params} parameters, {sum(moments)} "
              f"with nonzero moments; best at iter {load_checkpoint(best_path)['iters']}")
        if saved["iters"] != DATA_ITERS or iterators != [DATA_INTERVAL, DATA_ITERS]:
            fail(f"checkpoint iters {saved['iters']} converge {iterators}")
        if len(moments) != n_params or not all(moments):
            fail("a parameter without Adam moments in the checkpoint")

        # ---- resume at the finetune lr: bitwise state, then the same steps
        code, resumed = cli.run(argv + ["--max_iters", str(DATA_ITERS), "--resume", rolling,
                                        "--lr", str(RESUME_LR)])
        lrs = [g["lr"] for g in resumed.optimizer.param_groups]
        same = {"generator": state_equal(resumed.generators[0], saved["generator"][0]),
                "student": state_equal(resumed.students[0], saved["student"][0]),
                "adam": adam_equal(resumed.optimizer, saved["optimizer"])}
        print(f"[data] resumed: iters {resumed.iters}, lr {lrs}, bitwise equal to the file "
              f"{json.dumps(same)}")
        if code != 0 or resumed.iters != DATA_ITERS or lrs != [RESUME_LR] or not all(same.values()):
            fail("resume did not restore the checkpoint")
        for group in trainer.optimizer.param_groups:  # the uninterrupted run at the same lr
            group["lr"] = RESUME_LR
        sds = SyntheticTextDataset(n=BATCH, seed=14)
        hr, lr = to_device(collate([sds[i] for i in range(BATCH)]), DEV, True)
        losses = {"uninterrupted": [], "resumed": []}
        for step in range(2):
            for name, t in (("uninterrupted", trainer), ("resumed", resumed)):
                m = train_step([t.generators[0].train()], [t.students[0].train()], t.teacher.eval(), t.optimizer,
                               {"images_hr": hr, "images_lr": lr}, StepConfig(),
                               torch.Generator(device=DEV).manual_seed(100 + step))
                losses[name].append(m["loss_total"].item())
        rel = [abs(a - b) / abs(a) for a, b in zip(losses["uninterrupted"], losses["resumed"])]
        print(f"[data] two steps on a fixed batch: loss_total {json.dumps(losses)}, relative "
              f"differences {rel} (tol {LOSS_RTOL})")
        if not all(r <= LOSS_RTOL for r in rel):
            fail(f"resumed steps differ from the uninterrupted run: {rel}")
        done = resumed.train(max_iters=DATA_ITERS + 1)["iters"]
        print(f"[data] the resumed trainer counts on: iters {done}")
        if done != DATA_ITERS + 1:
            fail(f"resumed trainer at iters {done}")

        # ---- --go_test of the best checkpoint against the summary saved with it
        best = load_checkpoint(best_path)["best_history_res"]["val"]
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            code = cli.main(["--arch=tatt", "--mask", "--go_test", "--vis_dir", "vis_smoke",
                             "--config", yaml, "--resume", best_path])
        counts = read_counts()
        lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[val] ")]
        got = ast.literal_eval(lines[-1][len("[val] "):]) if lines else {}
        eval_batches = math.ceil(DATA_VAL_N / BATCH)
        print(f"[data] --go_test of model_best_acc_0.ckpt: psnr {got.get('psnr_avg')} ssim "
              f"{got.get('ssim_avg')} acc {got.get('accuracy')} images {got.get('images')}; saved "
              f"with it: psnr {best['psnr_avg']} ssim {best['ssim_avg']} acc {best['accuracy']}; "
              f"launches {json.dumps(counts)}")
        if code != 0 or not got or got["images"] != DATA_VAL_N:
            fail(f"--go_test exit {code}, output {out.getvalue()[-500:]}")
        if not (abs(got["psnr_avg"] - best["psnr_avg"]) <= GO_TEST_PSNR_TOL
                and abs(got["ssim_avg"] - best["ssim_avg"]) <= GO_TEST_SSIM_TOL
                and got["accuracy"] == best["accuracy"]):
            fail(f"--go_test summary {got} differs from the saved {best}")
        if counts != {"bigru_fwd": 10 * eval_batches, "bigru_bwd": 0,
                      "bilstm_fwd": 8 * eval_batches, "bilstm_bwd": 0}:
            fail(f"--go_test launches {counts}")

        # ---- numbers: LMDB train images/s, eval images/s by workers, checkpoint I/O
        trainer.cfg.TRAIN.VAL.valInterval = trainer.cfg.TRAIN.saveInterval = 0
        trainer.train(max_iters=trainer.iters + 2)  # the loader's threads up
        lmdb_ips = {DATA_WORKERS: [], 1: []}
        for workers in (DATA_WORKERS, 1, 1, DATA_WORKERS):  # in turns
            trainer.loader.num_workers = workers
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train(max_iters=trainer.iters + TRAIN_STEPS)
            torch.cuda.synchronize()
            lmdb_ips[workers].append(TRAIN_STEPS * BATCH / (time.perf_counter() - t0))
        print(f"[data] train images/s on the LMDBs by loader threads ({TRAIN_STEPS} steps at batch "
              f"{BATCH} each, in turns {DATA_WORKERS},1,1,{DATA_WORKERS}): "
              + json.dumps({w: [round(v, 1) for v in r] for w, r in lmdb_ips.items()})
              + "; synthetic (phase 7, this call) "
              + (f"{synthetic_ips:.1f}" if synthetic_ips else "not run"))
        # the host's side alone: batches of the train LMDBs (decode, resize,
        # stack) against cached synthetic crops (stack only), no device work
        train_ds, cached = trainer.loader.dataset, SyntheticTextDataset(n=4 * BATCH, seed=15)
        for i in range(len(cached)):
            cached[i]
        loader_ms = {}
        for name, ds, workers in (("lmdb", train_ds, 1), ("lmdb", train_ds, DATA_WORKERS),
                                  ("synthetic, cached", cached, 1)):
            loader = DataLoader(ds, BATCH, num_workers=workers)
            t0 = time.perf_counter()
            n = sum(1 for _ in loader)
            loader_ms[f"{name}, {workers} workers"] = (time.perf_counter() - t0) * 1e3 / n
        print(f"[data] host ms a batch of the loader alone (an epoch, {BATCH} a batch): "
              + json.dumps({k: round(v, 2) for k, v in loader_ms.items()}))
        val_ds = LmdbTextDataset(roots[2])
        rates = {1: [], 4: []}
        for workers in (1, 4, 4, 1, 1, 4):
            ev = Evaluator([trainer.generators[0].eval()], [trainer.students[0].eval()], trainer.teacher, DEV,
                           BATCH, True, workers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev.evaluate(val_ds)
            torch.cuda.synchronize()
            rates[workers].append(DATA_VAL_N / (time.perf_counter() - t0))
        print("[data] val-LMDB eval images/s by workers (3 passes each, in turns 1,4,4,1,1,4): "
              + json.dumps({w: [round(r, 1) for r in v] for w, v in rates.items()}))
        path = os.path.join(tmp, "timed.ckpt")
        save_ms, restore_ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(path, trainer.generators, trainer.students, trainer.optimizer, trainer.iters)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            restore_checkpoint(load_checkpoint(path), resumed.generators, resumed.students,
                               resumed.optimizer)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[data] full-width checkpoint: {os.path.getsize(path)} bytes, save ms "
              f"{[round(v, 1) for v in save_ms]}, restore ms (read and copy to the card) "
              f"{[round(v, 1) for v in restore_ms]}")


def _render_hr(job):
    """HR crops (uint8 arrays) and labels of samples ``lo .. hi - 1`` of
    ``SyntheticTextDataset(seed=seed)`` (a sample depends on its index and
    the seed alone), in a worker process."""
    seed, lo, hi = job
    ds = SyntheticTextDataset(n=hi, seed=seed)
    return [(np.asarray(ds[i][0].convert("RGB")), ds[i][2]) for i in range(lo, hi)]


class _Rendered:
    """(HR, None, label) samples from rendered crops."""

    def __init__(self, crops):
        self.crops = crops

    def __len__(self) -> int:
        return len(self.crops)

    def __getitem__(self, i):
        hr, label = self.crops[i]
        return Image.fromarray(hr), None, label


def render_train_crops(seed: int, n: int, budget_s: float) -> list:
    """The first samples of ``SyntheticTextDataset(n, seed)``, rendered in
    chunks of 512 by a pool of worker processes, in order, until ``n`` or
    ``budget_s`` seconds; the pool is shut down before returning."""
    import concurrent.futures
    import multiprocessing

    t0, crops = time.perf_counter(), []
    jobs = [(seed, lo, min(lo + 512, n)) for lo in range(0, n, 512)]
    # forked workers (no import to repeat) that touch no CUDA state
    with concurrent.futures.ProcessPoolExecutor(
            min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("fork")) as pool:
        futures = [pool.submit(_render_hr, job) for job in jobs]
        for fut in futures:
            crops += fut.result()
            if time.perf_counter() - t0 > budget_s:
                break
        for fut in futures:
            fut.cancel()
    return crops


def ctc_check(gen, smi: str) -> None:
    """Phase 11 (a): the port's CTC loss at pretraining's [26, 128, 37],
    card against CPU, on the collate's spread targets (1e30 entries
    included) and on plain targets; forward + backward timed beside
    ``F.ctc_loss`` on the plain ones (blank-free and feasible; a yardstick,
    never on the path)."""
    t, b, c = 26, PRETRAIN_BATCH, 37
    ds = SyntheticTextDataset(n=b, seed=40)
    samples = [ds[i] for i in range(b)]
    spread = collate(samples)
    plain = encode_ctc_targets([lab for _, _, lab in samples])
    logits = torch.randn(t, b, c, generator=gen) * 2
    ilens = torch.full((b,), t)
    cases = {"spread": (spread.ctc_targets, spread.ctc_lengths), "plain": plain}
    times = {}
    for name, (tg, tl) in cases.items():
        tg, tl = torch.from_numpy(tg), torch.from_numpy(tl)
        out = {}
        for dev in ("cpu", DEV):
            x = logits.to(dev, copy=True).requires_grad_()
            loss = ctc_loss(torch.log_softmax(x, -1), tg.to(dev), ilens.to(dev), tl.to(dev))
            loss.sum().backward()
            out[str(dev)] = (loss.detach().cpu(), x.grad.cpu())
        (v_cpu, g_cpu), (v_card, g_card) = out["cpu"], out[str(DEV)]
        infeasible = v_cpu >= 1e29
        v_err = ((v_card - v_cpu).abs() / v_cpu.abs()).max().item()
        scale = g_cpu.abs().amax(dim=(0, 2), keepdim=True)
        g_err = ((g_card - g_cpu).abs() / (g_cpu.abs() + scale)).max().item()
        x = logits.to(DEV, copy=True).requires_grad_()
        tg_d, tl_d, il_d = tg.to(DEV), tl.to(DEV), ilens.to(DEV)

        def port_fb():
            x.grad = None
            ctc_loss(torch.log_softmax(x, -1), tg_d, il_d, tl_d).mean().backward()

        times[name] = timed_ms(port_fb, 20)
        print(f"[ctc] {name} targets [{b}, {tg.shape[1]}]: {int(infeasible.sum())} of {b} at 1e30 "
              f"(card {int((v_card >= 1e29).sum())}); card vs CPU: values {v_err:.3e}, gradients "
              f"{g_err:.3e} (tol {CTC_TOL}); forward + backward {times[name]:.3f} ms ({smi})")
        if not (torch.equal(infeasible, v_card >= 1e29) and v_err <= CTC_TOL and g_err <= CTC_TOL
                and torch.isfinite(g_card).all()):
            fail(f"ctc {name}: card vs CPU values {v_err}, gradients {g_err}")
    tg_d, tl_d = (torch.from_numpy(a).to(DEV) for a in plain)
    x = logits.to(DEV, copy=True).requires_grad_()
    il_d = ilens.to(DEV)
    lib = F.ctc_loss(torch.log_softmax(x, -1), tg_d, il_d, tl_d, blank=0, reduction="none")
    ours = ctc_loss(torch.log_softmax(x, -1), tg_d, il_d, tl_d)
    lib_err = ((lib - ours).abs() / ours.abs()).max().item()

    def lib_fb():
        x.grad = None
        F.ctc_loss(torch.log_softmax(x, -1), tg_d, il_d, tl_d, blank=0,
                   reduction="none").mean().backward()

    print(f"[ctc] F.ctc_loss on the plain targets: forward + backward {timed_ms(lib_fb, 20):.3f} ms "
          f"against the port's {times['plain']:.3f} ms; values within {lib_err:.3e} ({smi})")


def pretrain_phase(smi: str) -> None:
    """Phase 11: CTC, the BiLSTM kernels at pretraining's shapes, the
    full-width CRNN pretrained at batch 128, and the fixture judge's
    recipe handed to the CLI as teacher and judge."""
    gen = torch.Generator().manual_seed(11)
    ctc_check(gen, smi)

    # ---- (b) the BiLSTM kernels at R=128: the full-width CRNN and the judge's H=64
    with torch.no_grad():
        fwd_rows = [check_lstm("pretrain rnn0 R=128", 26, PRETRAIN_BATCH, 512, 256, gen),
                    check_lstm("pretrain rnn1 R=128", 26, PRETRAIN_BATCH, 256, 256, gen),
                    check_lstm("judge rnn0 R=128 (H=64)", 26, PRETRAIN_BATCH, 128, 64, gen),
                    check_lstm("judge rnn1 R=128 (H=64)", 26, PRETRAIN_BATCH, 64, 64, gen)]
    bwd_rows = [check_lstm_bwd("pretrain rnn0 R=128", 26, PRETRAIN_BATCH, 512, 256, gen),
                check_lstm_bwd("pretrain rnn1 R=128", 26, PRETRAIN_BATCH, 256, 256, gen),
                check_lstm_bwd("judge rnn0 R=128 (H=64)", 26, PRETRAIN_BATCH, 128, 64, gen),
                check_lstm_bwd("judge rnn1 R=128 (H=64)", 26, PRETRAIN_BATCH, 64, 64, gen)]
    for row in fwd_rows:
        row["plan"] = bilstm_fwd_plan(row["H"], row["R"])
        print("[kernel] " + json.dumps(row))
        if not row["max_abs_err"] <= KERNEL_ATOL:
            fail(f"kernel {row['shape']}: err {row['max_abs_err']} > {KERNEL_ATOL}")
        print(f"[lstm] {row['shape']}: kernel {row['kernel_ms']:.4f} ms, with c "
              f"{row['kernel_cs_ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_by']}), plain "
              f"{row['plain_ms']:.3f}, + projection {row['kernel_ms'] + row['projection_ms']:.4f} "
              f"vs nn.LSTM {row['library_ms']:.4f}; plan {json.dumps(row['plan'])} ({smi})")
    for row in bwd_rows:
        print("[kernel-bwd] " + json.dumps(row))
        if not row["ok"]:
            fail(f"backward kernel {row['shape']}: {row}")
        print_bwd_split("lstm-bwd", row, LSTM_BWD_ENTRIES)
        print(f"[lstm-bwd] {row['shape']}: {row['kernel_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}), plain {row['plain_ms']:.3f}, nn.LSTM forward + backward "
              f"{row['library_ms']:.4f} ({smi})")

    # ---- (c) the full-width CRNN pretrained at batch 128
    ds, ev = SyntheticTextDataset(n=8 * PRETRAIN_BATCH, seed=41), SyntheticTextDataset(n=64, seed=42)
    for d in (ds, ev):
        for i in range(len(d)):
            d[i]
    crnn = init_parameters(CRNN(), 50)
    pretrain_recognizer(crnn, ds, steps=3, batch_size=PRETRAIN_BATCH, eval_every=3, eval_dataset=ev,
                        log_fn=None, device=DEV)  # builds and cuDNN autotuning
    n_evals = 4
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pretrain_recognizer(crnn, ds, steps=PRETRAIN_STEPS, batch_size=PRETRAIN_BATCH, seed=1,
                              eval_every=PRETRAIN_STEPS // n_evals, eval_dataset=ev, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    losses = [h["loss"] for h in res.history]
    # per step 2 forward (with c) and 2 backward; each evaluation 2 forward
    want = {"bigru_fwd": 0, "bigru_bwd": 0, "bilstm_fwd": 2 * PRETRAIN_STEPS + 2 * n_evals,
            "bilstm_bwd": 2 * PRETRAIN_STEPS}
    print(f"[pretrain] full-width CRNN (nh=256), {PRETRAIN_STEPS} steps at batch {PRETRAIN_BATCH}: "
          f"{wall:.2f} s with {n_evals} evaluations of 64 crops, images/s "
          f"{PRETRAIN_STEPS * PRETRAIN_BATCH / wall:.1f}; loss by window {losses}; launches "
          f"{json.dumps(counts)} (want {json.dumps(want)}) ({smi})")
    if counts != want:
        fail(f"pretraining launches {counts} (want {want})")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        fail(f"pretraining loss did not fall: {losses}")

    # ---- (d) the fixture judge's recipe from a fresh seed
    heldout = SyntheticTextDataset(n=256, seed=991)
    for i in range(len(heldout)):
        heldout[i]
    t0 = time.perf_counter()
    train = _Rendered(render_train_crops(7, JUDGE_TRAIN_N, JUDGE_RENDER_S))
    render_s, n_train = time.perf_counter() - t0, len(train)
    # a warm-up outside the timed run (cuDNN's autotuning at the judge's widths)
    pretrain_recognizer(init_parameters(CRNN(nh=JUDGE_NH, nm=JUDGE_NM), 0), train, steps=3,
                        batch_size=PRETRAIN_BATCH, eval_every=10**9, eval_dataset=heldout,
                        log_fn=None, device=DEV)
    steps = JUDGE_RUN_STEPS
    judge = init_parameters(CRNN(nh=JUDGE_NH, nm=JUDGE_NM), 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pretrain_recognizer(judge, train, steps=steps, batch_size=PRETRAIN_BATCH, lr=1e-3, seed=0,
                              eval_dataset=heldout, eval_every=max(steps // 8, 1), device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = wall / steps * 1e3  # the 8 held-out evaluations included
    losses = [h["loss"] for h in res.history]
    labels = [heldout[i][2] for i in range(len(heldout))]
    asset_acc = word_accuracy(load_judge().to(DEV), hr_crops(heldout), labels)
    print(f"[judge-pretrain] the fixture judge's recipe (nh={JUDGE_NH}, nm={JUDGE_NM}, batch "
          f"{PRETRAIN_BATCH}, lr 1e-3, seed 0): {steps} of {JUDGE_STEPS} steps ({step_ms:.2f} ms a "
          f"step) on {n_train} of {JUDGE_TRAIN_N} training crops (rendered in {render_s:.1f} s) in "
          f"{wall:.1f} s; loss by window {[round(v, 4) for v in losses]}; held-out word accuracy "
          f"{res.final_accuracy:.4f} against the committed JAX asset's {asset_acc:.4f} on the same "
          f"256 crops ({smi})")
    if not losses[0] >= 2 * losses[-1]:
        fail(f"judge pretraining loss fell less than 2x: {losses}")

    # the .pth as the CLI's teacher (a 2-step run) and as --go_test's judge
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "crnn.pth")
        torch.save({k: v.cpu() for k, v in judge.state_dict().items()}, pth)
        saved = torch.load(pth, weights_only=True)
        code, trainer = cli.run(RECIPE + ["--synthetic", str(2 * BATCH), "--batch_size", str(BATCH),
                                          "--max_iters", "2", "--crnn_pretrained", pth])
        if code != 0 or not state_equal(trainer.teacher, saved):
            fail(f"cli.run with --crnn_pretrained: exit {code}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli.main(["--arch=tatt", "--mask", "--go_test", "--synthetic", "256",
                             "--batch_size", str(BATCH), "--crnn_pretrained", pth])
        lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[easy] ")]
        got = ast.literal_eval(lines[-1][len("[easy] "):]) if lines else {}
        print(f"[judge-pretrain] {pth.rsplit(os.sep, 1)[-1]}: teacher of a 2-step cli.run (exit 0, "
              f"its weights equal to the file), judge of --go_test: HR accuracy "
              f"{got.get('accuracy_hr')}, LR {got.get('accuracy_lr')} on {got.get('images')} crops")
        if code != 0 or not got:
            fail(f"--go_test with the pretrained judge: exit {code}, {out.getvalue()[-300:]}")


def flags_phase(smi: str, synthetic_ips) -> None:
    """Phase 12: Trainer steps at full width for each flag set of the
    TATT step, then one --stu_iter=2 step card against CPU."""
    train_ds = SyntheticTextDataset(n=8 * BATCH, seed=1)
    for i in range(len(train_ds)):
        train_ds[i]
    recipe = dict(STN=True, mask=True, use_distill=True, gradient=True, sr_share=True,
                  tssim_loss=True, rotate_train=5.0, batch_size=BATCH)
    ips = {}
    for name, (flags, want) in FLAG_SETS.items():
        args = Flags(**{**recipe, **flags})
        cfg = Config(args=args)
        cfg.TRAIN.VAL.valInterval = cfg.TRAIN.saveInterval = 0
        cfg.TRAIN.displayInterval = 10**9
        n_sr, n_stu = copies(args)
        tatt = TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True, stn=True)
        gens = [init_parameters(copy.deepcopy(tatt), 1234 + 3 * i).to(DEV) for i in range(n_sr)]
        stus = [init_parameters(CRNN(), 1235 + 3 * i).to(DEV) for i in range(n_stu)]
        trainer = Trainer(cfg, gens, stus, init_parameters(CRNN(), 1236).to(DEV), train_ds, DEV)
        first = trainer.train(max_iters=FLAG_WARM)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        timed = trainer.train(max_iters=FLAG_WARM + FLAG_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_step = {k: v / FLAG_STEPS for k, v in read_counts().items()}
        metrics = {k: first["metrics"][k] + timed["metrics"][k] for k in timed["metrics"]}
        ips[name] = FLAG_STEPS * BATCH / wall
        sr = metrics["loss_sr"]
        new = [k for k in ("sr_mean", "sr_min", "sr_max", "gnorm/srb2", "gnorm/stn_head",
                           "loss_distill_each", "loss_ssim") if k in metrics]
        print(f"[flags] {name}: {FLAG_STEPS} steps at batch {BATCH}, images/s {ips[name]:.1f}; "
              f"launches per step {json.dumps(per_step)} (want {json.dumps(want)}); loss_sr "
              f"{[round(v, 4) for v in sr]}; new metrics {new}"
              + (f"; loss_distill (CTC term, not gated) {[f'{v:.4g}' for v in metrics['loss_distill']]}"
                 if flags.get("use_label") else "") + f" ({smi})")
        if per_step != {k: float(v) for k, v in want.items()}:
            fail(f"{name}: launches per step {per_step} (want {want})")
        if not all(math.isfinite(v) for vals in metrics.values() for v in vals):
            fail(f"{name}: non-finite metrics")
        # batch to batch loss_sr varies by 2-4x this early, and the first
        # step (at the random init) reads 2-4x above the rest: the median of
        # the last 5 steps against that of steps 2-4
        if not np.median(sr[-5:]) < np.median(sr[1:4]):
            fail(f"{name}: loss_sr did not fall: {sr[1:4]} -> {sr[-5:]}")
        wanted = {"sr_mean", "sr_min", "sr_max", "gnorm/srb2"}
        if not wanted <= set(metrics):
            fail(f"{name}: metrics {sorted(metrics)} lack {wanted - set(metrics)}")
        del trainer, gens, stus
    print(f"[flags] train images/s at batch {BATCH}: recipe {ips['recipe']:.1f}, --use_label "
          f"{ips['use_label']:.1f}, --stu_iter=2 {ips['stu_iter=2, separate copies, for_cascading']:.1f}"
          f"; phase 7 of this call {f'{synthetic_ips:.1f}' if synthetic_ips else 'not run'} ({smi})")
    name = "stu_iter=2, separate copies, for_cascading"
    card_vs_cpu_step("step2", StepConfig(stu_iter=2, sr_share=False, for_cascading=True), 2, 2,
                     FLAG_SETS[name][1], with_f64=False)


def seeded_lpips(seed: int):
    """LPIPS-VGG with seeded weights on the card (the real VGG16 and lpips
    heads are the user's files): a function of (images, HR) -> [N]."""
    vgg = init_parameters(VGG16Features(), seed).to(DEV).eval()
    gen = torch.Generator().manual_seed(seed)
    lin = [(0.1 * torch.rand(c, generator=gen)).to(DEV) for c in (64, 128, 256, 512, 512)]  # relu1_2..5_3
    return lambda a, b: lpips_vgg(vgg, lin, a, b)


def judge_readings(kind: str, model, images):
    """(encoder features, first decode step's logits, ids) of an ASTER or
    MORAN ``model`` on RGB ``images`` in [0, 1]."""
    with torch.no_grad():
        if kind == "ASTER":
            feats = model.encode(parse_aster_input(images))
            dec = model.decoder.decoder
            state = feats.new_zeros(feats.shape[0], dec.s_dim)
            bos = torch.full((feats.shape[0],), dec.num_classes, dtype=torch.long, device=feats.device)
            first, _ = dec.step(dec.attention_unit.xEmbed(feats), feats, state, bos)
            return feats, first, model.decoder(feats, model.max_len)[0]
        x = parse_moran_input(images)
        seq = model.ASRN.cnn(model.MORN(x))[:, :, 0].transpose(1, 2)
        for layer in model.ASRN.rnn:
            seq = layer(seq)
        l2r = model(x)[0]
        return seq, l2r[:, 0], l2r.argmax(-1)


def print_lstm(row, smi: str = "") -> None:
    """A forward BiLSTM shape: the launch and its time a step, with c, the
    input projection beside cuDNN's ``nn.LSTM`` (which includes it), the
    bound, the plain version and the plan."""
    step_us = (row["kernel_ms"] - row["one_step_ms"]) / (row["L"] - 1) * 1e3
    print(f"[lstm] {row['shape']}: kernel {row['kernel_ms']:.4f} ms "
          f"({step_us:.2f} us a step after {row['one_step_ms']:.4f} ms for set-up and "
          f"step 1; events {row['kernel_event_ms']:.4f}, profiler "
          f"{row['kernel_profiler_ms']}), "
          f"with c {row['kernel_cs_ms']:.4f}; + projection "
          f"{row['kernel_ms'] + row['projection_ms']:.4f} vs nn.LSTM {row['library_ms']:.4f}; bound "
          f"{row['bound_ms']:.4f} ({row['bound_by']}); plain {row['plain_ms']:.3f}; plan "
          f"{json.dumps(bilstm_fwd_plan(row['H'], row['R']))}" + (f" ({smi})" if smi else ""))


def judges_phase(smi: str) -> list:
    """Phase 13: the ASTER and MORAN judges, LPIPS, --vis, --demo and the
    CLI's --test / --test_model (checks and numbers in the module
    docstring).  Returns the BiLSTM forward rows at the judges' shapes."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(13)

    # ---- (a) the BiLSTM forward kernel at the judges' shapes
    with torch.no_grad():
        rows = [check_lstm("judges In 512 (ASTER rnn l0 and l1, MORAN rnn0)", 25, JUDGE_BATCH, 512,
                           256, gen),
                check_lstm("judges In 256 (MORAN rnn1)", 25, JUDGE_BATCH, 256, 256, gen)]
    for row in rows:
        row["plan"] = bilstm_fwd_plan(row["H"], row["R"])
        print("[kernel] " + json.dumps(row))
        if not row["max_abs_err"] <= KERNEL_ATOL:
            fail(f"kernel {row['shape']}: err {row['max_abs_err']} > {KERNEL_ATOL}")
        print_lstm(row, smi)

    # ---- (b) ASTER and MORAN at full width, batch 50: card against CPU
    sds = SyntheticTextDataset(n=JUDGE_BATCH, seed=30)
    hr, _ = to_device(collate([sds[i] for i in range(JUDGE_BATCH)]), DEV, True)
    info = AsterInfo("all")
    judges = {"CRNN": make_judge("CRNN", load_judge().to(DEV))}
    models = {"ASTER": init_parameters(AsterRecognizer(info.rec_num_classes), 20),
              "MORAN": init_parameters(MORAN(), 21)}
    for kind, model in models.items():
        cpu = copy.deepcopy(model).eval()
        card = model.to(DEV).eval()
        judges[kind] = judge = make_judge(kind, card, "all")
        judge(hr)  # cuDNN autotuning
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        strings = judge(hr)
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        f_card, l_card, ids_card = judge_readings(kind, card, hr)
        f_cpu, l_cpu, ids_cpu = judge_readings(kind, cpu, hr.cpu())
        errs = {"features": scaled_err(f_card.cpu(), f_cpu), "first_logits": scaled_err(l_card.cpu(), l_cpu)}
        same = (ids_card.cpu() == ids_cpu).double().mean().item()
        extra = ""
        if kind == "ASTER":
            with torch.no_grad():
                feats = card.encode(parse_aster_input(hr))
                decode_ms = timed_ms(lambda: card.decoder(feats, card.max_len), 5)
                profile_window(lambda: card.decoder(feats, card.max_len),
                               f"ASTER decode, {card.max_len} steps at batch {JUDGE_BATCH}")
            extra = f"; the decode alone ({card.max_len} steps) {decode_ms:.2f} ms a batch"
        print(f"[judges] {kind} at batch {JUDGE_BATCH}: {wall_ms:.2f} ms a call (host clock){extra}; "
              f"launches a call {json.dumps(counts)}; card vs CPU {json.dumps(errs)} (tol {JUDGE_TOL}); "
              f"identical ids {same:.4f} (not gated); readings e.g. {strings[:3]} ({smi})")
        if counts != {"bigru_fwd": 0, "bigru_bwd": 0, "bilstm_fwd": JUDGE_LAUNCHES[kind], "bilstm_bwd": 0}:
            fail(f"{kind} judge launches {counts}")
        if not (all(e <= JUDGE_TOL for e in errs.values()) and len(strings) == JUDGE_BATCH):
            fail(f"{kind} judge card vs CPU {errs}")

    # ---- (c) Evaluator images/s by judge, without and with LPIPS
    generator = init_parameters(TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True),
                                1234).to(DEV).eval()
    student = init_parameters(CRNN(), 1235).to(DEV).eval()
    lpips = seeded_lpips(22)
    ev_ds = SyntheticTextDataset(n=JUDGE_EVAL_N, seed=2)
    for i in range(len(ev_ds)):  # render (and cache) every sample up front
        ev_ds[i]
    n_batches = math.ceil(JUDGE_EVAL_N / JUDGE_BATCH)
    for kind in ("CRNN", "ASTER", "MORAN"):
        for fn in (None, lpips):
            ev = Evaluator([generator], [student], judges[kind], DEV, JUDGE_BATCH, True, lpips=fn)
            ev.evaluate(ev_ds)  # the tail batch's shapes autotuned too
            rates = []
            for _ in range(2):
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                summary = ev.evaluate(ev_ds)
                torch.cuda.synchronize()
                rates.append(JUDGE_EVAL_N / (time.perf_counter() - t0))
            counts = read_counts()
            # 10 GruBlocks a generator forward; the student's 2 BiLSTMs and
            # each judge call's (on SR, LR and HR)
            want = {"bigru_fwd": 10 * n_batches, "bigru_bwd": 0,
                    "bilstm_fwd": (2 + 3 * JUDGE_LAUNCHES[kind]) * n_batches, "bilstm_bwd": 0}
            lp = (f", LPIPS SR {summary['lpips_vgg_sr']:.4f} LR {summary['lpips_vgg_lr']:.4f}"
                  if fn else "")
            print(f"[judges] Evaluator, {kind} judge{' + LPIPS' if fn else ''}: {JUDGE_EVAL_N} images at "
                  f"batch {JUDGE_BATCH}, images/s {rates[0]:.1f} / {rates[1]:.1f} (two passes); launches a batch "
                  f"{json.dumps({k: v / n_batches for k, v in counts.items()})}; psnr "
                  f"{summary['psnr_avg']:.4f} ssim {summary['ssim_avg']:.5f} acc SR "
                  f"{summary['accuracy']:.4f} HR {summary['accuracy_hr']:.4f}{lp} ({smi})")
            if counts != want:
                fail(f"Evaluator with {kind}: launches {counts} (want {want})")
            if not (math.isfinite(summary["psnr_avg"]) and (fn is None or (
                    summary["lpips_vgg_sr"] > 0 and math.isfinite(summary["lpips_vgg_lr"])))):
                fail(f"Evaluator with {kind}: {summary}")

    # ---- (d) --log_dir's writer, --vis, --demo, and the CLI from saved judge weights
    with tempfile.TemporaryDirectory() as tmp:
        writer = make_summary_writer(os.path.join(tmp, "tb"), "smoke")
        print(f"[judges] tensorboardX summary writer made: {writer is not None} (without "
              "tensorboardX the trainers log no scalars, after one warning)")
        if writer is not None:
            writer.add_scalar("smoke/one", 1.0, 0)
            writer.close()
        vis = os.path.join(tmp, "vis")
        Evaluator([generator], [student], judges["ASTER"], DEV, JUDGE_BATCH, True, n_vis=JUDGE_N_VIS,
                  vis_root=vis).evaluate(ev_ds)
        files = os.listdir(vis)
        n_att = sum(f.startswith("att_") for f in files)
        print(f"[judges] --vis: {len(files) - n_att} triptychs and {n_att} attention tiles")
        if (len(files) - n_att, n_att) != (JUDGE_N_VIS, JUDGE_N_VIS):
            fail(f"--vis wrote {sorted(files)}")
        crops = os.path.join(tmp, "crops")
        os.makedirs(crops)
        dds = SyntheticTextDataset(n=JUDGE_DEMO_N, seed=31)
        for i in range(JUDGE_DEMO_N):
            dds[i][1].save(os.path.join(crops, f"crop{i}.png"))
        out, cwd = io.StringIO(), os.getcwd()
        os.chdir(tmp)  # --demo writes demo_out/<vis_dir> where it runs, as JAX does
        try:
            with contextlib.redirect_stdout(out):
                code = cli.main(["--arch=tatt", "--mask", "--demo", "--demo_dir", crops, "--vis_dir", "smoke",
                                 "--synthetic", "8"])
        finally:
            os.chdir(cwd)
        lines = out.getvalue().splitlines()
        readings = [ln for ln in lines if ": LR='" in ln]
        saved = os.listdir(os.path.join(tmp, "demo_out", "smoke"))
        print(f"[judges] --demo over {JUDGE_DEMO_N} PNGs: exit {code}, {len(readings)} readings, "
              f"{len(saved)} SR images saved; {lines[-1] if lines else ''}")
        if code != 0 or len(readings) != JUDGE_DEMO_N or len(saved) != JUDGE_DEMO_N \
                or not lines[-1].startswith(f"demo: {JUDGE_DEMO_N} images, fps="):
            fail(f"--demo: exit {code}, output {out.getvalue()[-500:]}")
        paths = {"ASTER": os.path.join(tmp, "aster_demo.pth.tar"), "MORAN": os.path.join(tmp, "moran.pth")}
        torch.save({"state_dict": {f"module.{k}": v.cpu() for k, v in models["ASTER"].state_dict().items()},
                    "epoch": 0}, paths["ASTER"])
        torch.save({k: v.cpu() for k, v in models["MORAN"].state_dict().items()}, paths["MORAN"])
        base = ["--arch=tatt", "--mask", "--synthetic", str(4 * JUDGE_EVAL_N), "--batch_size", str(JUDGE_BATCH)]
        for kind, argv in (("ASTER", ["--test", "--rec=aster", "--rec_pretrained", paths["ASTER"]]),
                           ("MORAN", ["--go_test", "--test_model=MORAN", "--moran_pretrained", paths["MORAN"]])):
            out = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(out):
                code = cli.main(base + argv)
            counts = read_counts()
            lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[easy] ")]
            got = ast.literal_eval(lines[-1][len("[easy] "):]) if lines else {}
            cfg, _ = cli.parse_config(base + argv)
            gens, stus, _ = cli.build_models(cfg, "")
            want = Evaluator([m.to(DEV).eval() for m in gens], [m.to(DEV).eval() for m in stus],
                             cli.load_judge(kind, paths[kind], "all", DEV), DEV, JUDGE_BATCH,
                             True).evaluate(ev_ds)
            keys = ("psnr_avg", "ssim_avg", "accuracy", "accuracy_lr", "accuracy_hr", "images")
            print(f"[judges] cli {' '.join(argv[:2])}: exit {code}, "
                  f"{json.dumps({k: got.get(k) for k in keys})}; Evaluator on the same weights "
                  f"{json.dumps({k: want[k] for k in keys})}; launches {json.dumps(counts)}")
            if code != 0 or not got or got["images"] != JUDGE_EVAL_N:
                fail(f"cli {argv}: exit {code}, output {out.getvalue()[-500:]}")
            if not (abs(got["psnr_avg"] - want["psnr_avg"]) <= GO_TEST_PSNR_TOL
                    and abs(got["ssim_avg"] - want["ssim_avg"]) <= GO_TEST_SSIM_TOL
                    and all(got[k] == want[k] for k in keys[2:])):
                fail(f"cli {argv}: {got} against the Evaluator's {want}")
            if counts["bilstm_fwd"] != (2 + 3 * JUDGE_LAUNCHES[kind]) * n_batches:
                fail(f"cli {argv}: launches {counts}")
    print(f"[judges] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return rows


def plain_card_vs_cpu_step() -> None:
    """One full-width tsrn step at batch 8 with --tssim_loss --mse_fuse
    (rotation pinned, SGD at lr 1): the card (kernels) against the CPU
    (plain twins), each gradient leaf with phase 8's two-tier gate."""
    cfg = StepConfig(tssim_loss=True, mse_fuse=True)
    model_cpu = init_parameters(TSRN(stn=True, mask=True), 17)
    sds = SyntheticTextDataset(n=STEP_BATCH, seed=15)
    b = collate([sds[i] for i in range(STEP_BATCH)])
    rot = {"rot_arc": torch.linspace(-0.08, 0.08, STEP_BATCH),
           "rot_offs": torch.linspace(0.1, 0.9, STEP_BATCH)}
    grads, stats = {}, {}
    for run, dev in (("cpu", torch.device("cpu")), ("card", DEV)):
        model = copy.deepcopy(model_cpu).to(dev)
        hr, lr = to_device(b, dev, True)
        batch = {"images_hr": hr, "images_lr": lr, **{k: v.to(dev) for k, v in rot.items()}}
        opt = torch.optim.SGD(model.parameters(), lr=1.0)
        reset_counts()
        t0 = time.perf_counter()
        metrics = plain_train_step([model.train()], opt, batch, cfg,
                                   torch.Generator(device=dev).manual_seed(0),
                                   image_loss, 4, distorted=True)
        counts = read_counts()
        grads[run] = {k: p.grad.double().cpu() for k, p in model.named_parameters()}
        stats[run] = {k: v.double().cpu() for k, v in model.state_dict().items() if "running" in k}
        print(f"[tsrn-step] {run} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps({k: v.item() for k, v in metrics.items()})} launches {json.dumps(counts)}")
    if counts != PLAIN_MSE_FUSE_LAUNCHES:
        fail(f"tsrn step launches {counts} (want {PLAIN_MSE_FUSE_LAUNCHES})")
    card = leaf_errors(grads["cpu"], grads["card"])
    rnn = rnn_leaves(model_cpu)
    for what, keys, tol in (("BiGRU", rnn, RNN_LEAF_TOL), ("other", set(card) - rnn, LEAF_TOL)):
        worst = sorted(keys, key=lambda k: -card[k])
        print(f"[tsrn-step] {len(keys)} {what} leaves, ||card - CPU|| / ||CPU|| (tol {tol}): "
              + "; ".join(f"{card[k]:.3e} {k}" for k in worst[:3]))
        bad = {k: card[k] for k in worst if not card[k] <= tol}
        if bad:
            fail(f"tsrn {what} gradients card vs CPU above {tol}: {bad}")
    stat_err = max(scaled_err(stats["card"][k], v) for k, v in stats["cpu"].items())
    print(f"[tsrn-step] BN running statistics after three forwards, card vs CPU: {stat_err:.3e} "
          f"(tol {LEAF_TOL})")
    if not stat_err <= LEAF_TOL:
        fail(f"tsrn BN running statistics card vs CPU {stat_err}")


def tsrn_phase(smi: str) -> None:
    """Phase 14: the TSRN family at full width (checks and numbers in the
    module docstring)."""
    t_phase = time.perf_counter()
    train_ds = SyntheticTextDataset(n=8 * BATCH, seed=1)
    for i in range(len(train_ds)):
        train_ds[i]
    ips = {}
    for arch, want in TSRN_ARCHS.items():
        cfg = Config(args=Flags(arch=arch, batch_size=BATCH, **TSRN_RECIPE))
        cfg.TRAIN.VAL.valInterval = cfg.TRAIN.saveInterval = 0
        cfg.TRAIN.displayInterval = 10**9
        generator = init_parameters(build_generator(arch, cfg), 1234).to(DEV)
        trainer = Trainer(cfg, [generator], [init_parameters(CRNN(), 1235).to(DEV)],
                          init_parameters(CRNN(), 1236).to(DEV), train_ds, DEV)
        first = trainer.train(max_iters=TSRN_WARM)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        timed = trainer.train(max_iters=TSRN_WARM + TSRN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_step = {k: v / TSRN_STEPS for k, v in read_counts().items()}
        metrics = {k: first["metrics"][k] + timed["metrics"][k] for k in timed["metrics"]}
        ips[arch] = TSRN_STEPS * BATCH / wall
        sr = metrics["loss_sr"]
        step = "TATT" if arch in ABLATION_SET else "plain"
        print(f"[tsrn] {arch} ({step} step): {TSRN_STEPS} steps at batch {BATCH}, images/s "
              f"{ips[arch]:.1f}, {wall / TSRN_STEPS * 1e3:.1f} ms a step; launches per step "
              f"{json.dumps(per_step)} (want {json.dumps(want)}); metrics {sorted(metrics)}; "
              f"loss_sr {[round(v, 4) for v in sr]} ({smi})")
        if per_step != {k: float(v) for k, v in want.items()}:
            fail(f"{arch}: launches per step {per_step} (want {want})")
        if not all(math.isfinite(v) for vals in metrics.values() for v in vals):
            fail(f"{arch}: non-finite metrics")
        # phase 12's gate: the median of the last 5 steps below that of steps 2-4
        if arch in ("tsrn", "tsrn_tl_cascade") and not np.median(sr[-5:]) < np.median(sr[1:4]):
            fail(f"{arch}: loss_sr did not fall: {sr[1:4]} -> {sr[-5:]}")
        if arch == "tsrn":
            tsrn_gen, tsrn_teacher = generator, trainer.teacher
            tsrn_sr_fn = trainer.evaluator.sr_fn
        del trainer

    plain_card_vs_cpu_step()

    # ---- Evaluator for tsrn at batch 64: the generator on LR alone, the
    # judge (the teacher CRNN) on SR, LR and HR
    evaluator = Evaluator([tsrn_gen.eval()], [], tsrn_teacher.eval(), DEV, batch_size=BATCH,
                          mask=True, sr_fn=tsrn_sr_fn)
    ds, warm = SyntheticTextDataset(n=4 * BATCH, seed=2), SyntheticTextDataset(n=BATCH, seed=3)
    for d in (ds, warm):  # render (and cache) every sample up front, as phase 3 does
        for i in range(len(d)):
            d[i]
    evaluator.evaluate(warm)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    summary = evaluator.evaluate(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {"bigru_fwd": 10 * 4, "bigru_bwd": 0, "bilstm_fwd": 6 * 4, "bilstm_bwd": 0}
    print(f"[tsrn] Evaluator, tsrn at batch {BATCH}: images/s {summary['images'] / wall:.1f}, psnr "
          f"{summary['psnr_avg']:.4f} ssim {summary['ssim_avg']:.5f}, launches {json.dumps(counts)} "
          f"(want {json.dumps(want)}) ({smi})")
    if counts != want or not math.isfinite(summary["psnr_avg"]):
        fail(f"tsrn eval: launches {counts}, psnr {summary['psnr_avg']}")

    # ---- cli.run --arch=tsrn, then --go_test of its best checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        yaml = os.path.join(tmp, "tsrn.yaml")
        with open(yaml, "w") as fh:
            fh.write(f"TRAIN:\n  batch_size: {BATCH}\n  saveInterval: {TSRN_CLI_ITERS}\n"
                     f"  ckpt_dir: '{os.path.join(tmp, 'ckpt')}'\n"
                     f"  VAL:\n    valInterval: {TSRN_CLI_ITERS}\n    crnn_pretrained: ''\n")
        argv = ["--arch=tsrn", "--STN", "--mask", "--gradient", "--rotate_train=5.0", "--tssim_loss",
                "--config", yaml, "--vis_dir", "vis_tsrn", "--synthetic", str(4 * BATCH)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code, _ = cli.run(argv + ["--max_iters", str(TSRN_CLI_ITERS)])
        best_path = os.path.join(tmp, "ckpt", "vis_tsrn", "model_best_acc_0.ckpt")
        if code != 0 or not os.path.exists(best_path):
            fail(f"cli.run --arch=tsrn: exit {code}, output {out.getvalue()[-500:]}")
        saved = load_checkpoint(best_path)
        best = saved["best_history_res"]["easy"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli.main(argv + ["--go_test", "--resume", best_path])
        lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[easy] ")]
        got = ast.literal_eval(lines[-1][len("[easy] "):]) if lines else {}
        print(f"[tsrn] cli.run --arch=tsrn {TSRN_CLI_ITERS} steps (arch in the checkpoint: "
              f"{saved['info']['arch']}), --go_test of model_best_acc_0.ckpt: psnr "
              f"{got.get('psnr_avg')} ssim {got.get('ssim_avg')} acc {got.get('accuracy')}; saved "
              f"with it: psnr {best['psnr_avg']} ssim {best['ssim_avg']} acc {best['accuracy']}")
        if code != 0 or not got or got["images"] != best["images"] or saved["info"]["arch"] != "tsrn":
            fail(f"--go_test --arch=tsrn: exit {code}, output {out.getvalue()[-500:]}")
        if not (abs(got["psnr_avg"] - best["psnr_avg"]) <= GO_TEST_PSNR_TOL
                and abs(got["ssim_avg"] - best["ssim_avg"]) <= GO_TEST_SSIM_TOL
                and got["accuracy"] == best["accuracy"]):
            fail(f"--go_test --arch=tsrn summary {got} differs from the saved {best}")
    print(f"[tsrn] train images/s at batch {BATCH}: "
          + ", ".join(f"{a} {v:.1f}" for a, v in ips.items())
          + f" ({smi}); phase 14 in {time.perf_counter() - t_phase:.1f} s")


def zoo_card_vs_cpu_step(arch: str, want_launches: dict) -> None:
    """One full-width ``arch`` step at batch 8 through ``factory.arch_steps``
    with the recipe's flags (rotation pinned, SGD at lr 1): the card
    (kernels) against the CPU (plain twins), each trainable model's
    gradient leaf by leaf with phase 8's two-tier gate."""
    cfg = Config(args=Flags(arch=arch, **TSRN_RECIPE))
    train_fn, _ = arch_steps(cfg)
    tl = arch in ABLATION_SET
    models_cpu = [init_parameters(build_generator(arch, cfg), 27), init_parameters(CRNN(), 28),
                  init_parameters(CRNN(), 29)]
    names = ["generator", "student"] if tl else ["generator"]
    sds = SyntheticTextDataset(n=STEP_BATCH, seed=25)
    b = collate([sds[i] for i in range(STEP_BATCH)])
    rot = {"rot_arc": torch.linspace(-0.08, 0.08, STEP_BATCH),
           "rot_offs": torch.linspace(0.1, 0.9, STEP_BATCH)}
    grads = {}
    for run, dev in (("cpu", torch.device("cpu")), ("card", DEV)):
        gen_m, stu, teacher = (copy.deepcopy(m).to(dev) for m in models_cpu)
        hr, lr = to_device(b, dev, True)
        batch = {"images_hr": hr, "images_lr": lr, **{k: v.to(dev) for k, v in rot.items()}}
        opt = torch.optim.SGD(list(gen_m.parameters()) + list(stu.parameters()), lr=1.0)
        reset_counts()
        t0 = time.perf_counter()
        metrics = train_fn([gen_m.train()], [stu.train()], teacher.eval(), opt, batch,
                           step_config(cfg.args), torch.Generator(device=dev).manual_seed(0))
        counts = read_counts()
        grads[run] = [{k: p.grad.double().cpu() for k, p in m.named_parameters()}
                      for m in (gen_m, stu)[:len(names)]]
        print(f"[zoo-step] {arch} {run} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps({k: v.item() for k, v in metrics.items()})} launches {json.dumps(counts)}")
    if counts != want_launches:
        fail(f"{arch} step launches {counts} (want {want_launches})")
    for i, name in enumerate(names):
        card = leaf_errors(grads["cpu"][i], grads["card"][i])
        rnn = rnn_leaves(models_cpu[i])
        for what, keys, tol in (("BiGRU/BiLSTM", rnn, RNN_LEAF_TOL),
                                ("other", set(card) - rnn, LEAF_TOL)):
            worst = sorted(keys, key=lambda k: -card[k])
            print(f"[zoo-step] {arch} {name}, {len(keys)} {what} leaves, ||card - CPU|| / ||CPU|| "
                  f"(tol {tol}): " + "; ".join(f"{card[k]:.3e} {k}" for k in worst[:3]))
            bad = {k: card[k] for k in worst if not card[k] <= tol}
            if bad:
                fail(f"{arch} {name} {what} gradients card vs CPU above {tol}: {bad}")


def zoo_phase(smi: str) -> None:
    """Phase 15: the zoo at full width (checks and numbers in the module
    docstring)."""
    t_phase = time.perf_counter()
    train_ds = SyntheticTextDataset(n=8 * BATCH, seed=1)
    for i in range(len(train_ds)):
        train_ds[i]
    ips, mem = {}, {}
    for arch, want in ZOO_ARCHS.items():
        cfg = Config(args=Flags(arch=arch, batch_size=BATCH, lr=ZOO_LR.get(arch), **TSRN_RECIPE))
        cfg.TRAIN.VAL.valInterval = cfg.TRAIN.saveInterval = 0
        cfg.TRAIN.displayInterval = 10**9
        warm, steps = (ZOO_GATED_WARM, ZOO_GATED_STEPS) if arch in ZOO_GATED else (ZOO_WARM, ZOO_STEPS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_arch = time.perf_counter()
        generator = init_parameters(build_generator(arch, cfg), 1234).to(DEV)
        trainer = Trainer(cfg, [generator], [init_parameters(CRNN(), 1235).to(DEV)],
                          init_parameters(CRNN(), 1236).to(DEV), train_ds, DEV)
        first = trainer.train(max_iters=warm)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        timed = trainer.train(max_iters=warm + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_step = {k: v / steps for k, v in read_counts().items()}
        metrics = {k: first["metrics"][k] + timed["metrics"][k] for k in timed["metrics"]}
        ips[arch] = steps * BATCH / wall
        mem[arch] = torch.cuda.max_memory_allocated() / 2**30
        sr = metrics["loss_sr"]
        step = "TATT" if arch in ABLATION_SET else "plain"
        print(f"[zoo] {arch} ({step} step, {sum(p.numel() for p in generator.parameters())} "
              f"parameters, lr {cfg.lr:g}): {steps} steps at batch {BATCH} after {warm}, images/s {ips[arch]:.1f}, "
              f"{wall / steps * 1e3:.1f} ms a step, max memory {mem[arch]:.2f} GiB; launches per "
              f"step {json.dumps(per_step)} (want {json.dumps(want)}); loss_sr "
              f"{[round(v, 4) for v in sr]}; {time.perf_counter() - t_arch:.1f} s ({smi})")
        if per_step != {k: float(v) for k, v in want.items()}:
            fail(f"{arch}: launches per step {per_step} (want {want})")
        if not all(math.isfinite(v) for vals in metrics.values() for v in vals):
            fail(f"{arch}: non-finite metrics")
        # phase 12's gate: the median of the last 5 steps below that of steps 2-4
        if arch in ZOO_GATED:
            print(f"[zoo] {arch} loss_sr median of steps 2-4 {np.median(sr[1:4]):.4f}, of the "
                  f"last 5 {np.median(sr[-5:]):.4f}")
            if not np.median(sr[-5:]) < np.median(sr[1:4]):
                fail(f"{arch}: loss_sr did not fall: {sr[1:4]} -> {sr[-5:]}")
        if arch == "pcan":
            pcan_gen, pcan_teacher = generator, trainer.teacher
            pcan_sr_fn = trainer.evaluator.sr_fn
        del trainer, generator
    torch.cuda.empty_cache()

    zoo_card_vs_cpu_step("pcan_tl", ZOO_ARCHS["pcan_tl"])
    zoo_card_vs_cpu_step("pcan", ZOO_ARCHS["pcan"])

    # ---- Evaluator for pcan at batch 64: the generator on LR alone, the
    # judge (the teacher CRNN) on SR, LR and HR
    evaluator = Evaluator([pcan_gen.eval()], [], pcan_teacher.eval(), DEV, batch_size=BATCH,
                          mask=True, sr_fn=pcan_sr_fn)
    ds, warm_ds = SyntheticTextDataset(n=4 * BATCH, seed=2), SyntheticTextDataset(n=BATCH, seed=3)
    for d in (ds, warm_ds):
        for i in range(len(d)):
            d[i]
    evaluator.evaluate(warm_ds)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    summary = evaluator.evaluate(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {"bigru_fwd": 10 * 4, "bigru_bwd": 0, "bilstm_fwd": 6 * 4, "bilstm_bwd": 0}
    print(f"[zoo] Evaluator, pcan at batch {BATCH}: images/s {summary['images'] / wall:.1f}, psnr "
          f"{summary['psnr_avg']:.4f} ssim {summary['ssim_avg']:.5f}, launches {json.dumps(counts)} "
          f"(want {json.dumps(want)}) ({smi})")
    if counts != want or not math.isfinite(summary["psnr_avg"]):
        fail(f"pcan eval: launches {counts}, psnr {summary['psnr_avg']}")
    del evaluator, pcan_gen, pcan_teacher

    # ---- cli.run --arch=pcan, then --go_test of its best checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        yaml = os.path.join(tmp, "pcan.yaml")
        with open(yaml, "w") as fh:
            fh.write(f"TRAIN:\n  batch_size: {BATCH}\n  saveInterval: {ZOO_CLI_ITERS}\n"
                     f"  ckpt_dir: '{os.path.join(tmp, 'ckpt')}'\n"
                     f"  VAL:\n    valInterval: {ZOO_CLI_ITERS}\n    crnn_pretrained: ''\n")
        argv = ["--arch=pcan", "--mask", "--gradient", "--rotate_train=5.0", "--tssim_loss",
                "--config", yaml, "--vis_dir", "vis_pcan", "--synthetic", str(4 * BATCH)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code, _ = cli.run(argv + ["--max_iters", str(ZOO_CLI_ITERS)])
        best_path = os.path.join(tmp, "ckpt", "vis_pcan", "model_best_acc_0.ckpt")
        if code != 0 or not os.path.exists(best_path):
            fail(f"cli.run --arch=pcan: exit {code}, output {out.getvalue()[-500:]}")
        saved = load_checkpoint(best_path)
        best = saved["best_history_res"]["easy"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli.main(argv + ["--go_test", "--resume", best_path])
        lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[easy] ")]
        got = ast.literal_eval(lines[-1][len("[easy] "):]) if lines else {}
        print(f"[zoo] cli.run --arch=pcan {ZOO_CLI_ITERS} steps (arch in the checkpoint: "
              f"{saved['info']['arch']}), --go_test of model_best_acc_0.ckpt: psnr "
              f"{got.get('psnr_avg')} ssim {got.get('ssim_avg')} acc {got.get('accuracy')}; saved "
              f"with it: psnr {best['psnr_avg']} ssim {best['ssim_avg']} acc {best['accuracy']}")
        if code != 0 or not got or got["images"] != best["images"] or saved["info"]["arch"] != "pcan":
            fail(f"--go_test --arch=pcan: exit {code}, output {out.getvalue()[-500:]}")
        if not (abs(got["psnr_avg"] - best["psnr_avg"]) <= GO_TEST_PSNR_TOL
                and abs(got["ssim_avg"] - best["ssim_avg"]) <= GO_TEST_SSIM_TOL
                and got["accuracy"] == best["accuracy"]):
            fail(f"--go_test --arch=pcan summary {got} differs from the saved {best}")
    print(f"[zoo] train images/s at batch {BATCH} (max memory GiB): "
          + ", ".join(f"{a} {ips[a]:.1f} ({mem[a]:.2f})" for a in ips)
          + f" ({smi}); phase 15 in {time.perf_counter() - t_phase:.1f} s")


def chinese_trainer(seed: int, train_ds):
    """Phase 16's ``Trainer``: TATT at full width (5 SRBs, hidden 32) with
    ``text_emb`` 3965 and the TPG students and teacher (``--tpg OPT``),
    the recipe's flags under ``--CHNSR``, the models seeded from ``seed``."""
    cfg = Config(args=Flags(batch_size=BATCH, CHNSR=True, tpg="OPT", **TSRN_RECIPE))
    cfg.TRAIN.VAL.valInterval = cfg.TRAIN.saveInterval = 0
    cfg.TRAIN.displayInterval = 10**9
    gen = init_parameters(build_generator("tatt", cfg), seed).to(DEV)
    spec = recognizer_spec(cfg)
    return Trainer(cfg, [gen], [init_parameters(spec.build(), seed + 1).to(DEV)],
                   init_parameters(spec.build(), seed + 2).to(DEV), train_ds, DEV)


def chinese_dataset(n: int, seed: int) -> SyntheticTextDataset:
    """Synthetic crops labelled from a slice of the 3965-character table
    (as ``tests/test_chinese_path.py``), every sample rendered up front."""
    ds = SyntheticTextDataset(n=n, seed=seed, charset=voc_table("chinese")[200:264])
    for i in range(n):
        ds[i]
    return ds


def tpg_card_vs_cpu(gen) -> None:
    """The shipped TPG at full width, one set of seeded weights, card
    against CPU on ``CHINESE_CHECK_BATCH`` images: logits in eval mode, and
    logits and BatchNorm running statistics after a train-mode forward;
    the BiLSTM variant's launches a forward and backward; the Attn
    variant's greedy ids (agreement printed, not gated)."""
    luma = torch.rand(CHINESE_CHECK_BATCH, 1, 32, 512, generator=gen)
    model = init_parameters(TPGModel(num_class=N_CHINESE), 41)
    for train in (False, True):
        cpu, card = copy.deepcopy(model).train(train), copy.deepcopy(model).to(DEV).train(train)
        with torch.no_grad():
            want, got = cpu(luma), card(luma.to(DEV)).cpu()
        errs = {"logits": scaled_err(got, want)}
        if train:
            own = card.state_dict()
            errs["bn_stats"] = max(scaled_err(own[k].cpu(), v) for k, v in cpu.state_dict().items()
                                   if "running" in k)
        print(f"[chinese] TPGModel(num_class={N_CHINESE}) {'train' if train else 'eval'} mode, "
              f"batch {CHINESE_CHECK_BATCH}, logits {tuple(got.shape)}: card vs CPU "
              f"{json.dumps(errs)} (tol {JUDGE_TOL})")
        if got.shape != (129, CHINESE_CHECK_BATCH, N_CHINESE) or not max(errs.values()) <= JUDGE_TOL:
            fail(f"TPG card vs CPU ({'train' if train else 'eval'}): {errs}")
    card = model.to(DEV).eval()
    batch_luma = torch.rand(BATCH, 1, 32, 512, generator=gen).to(DEV)
    with torch.no_grad():
        fwd_ms = timed_ms(lambda: card(batch_luma), 10)
    print(f"[chinese] TPGModel forward at batch {BATCH} (32x512, T=129): {fwd_ms:.3f} ms "
          f"({BATCH / fwd_ms * 1e3:.1f} images/s)")

    bilstm = init_parameters(TPGModel(num_class=N_CHINESE, sequence_modeling="BiLSTM"), 42).to(DEV)
    reset_counts()
    (bilstm.train()(batch_luma).square().mean()).backward()
    torch.cuda.synchronize()
    counts = read_counts()
    want = {"bigru_fwd": 0, "bigru_bwd": 0, "bilstm_fwd": 2, "bilstm_bwd": 2}
    print(f"[chinese] TPGModel(sequence_modeling='BiLSTM') forward + backward at batch {BATCH}: "
          f"launches {json.dumps(counts)} (want {json.dumps(want)})")
    if counts != want:
        fail(f"TPG BiLSTM launches {counts} (want {want})")

    attn = init_parameters(TPGModel(num_class=N_CHINESE, prediction="Attn"), 43).eval()
    with torch.no_grad():
        want_ids = attn(luma).argmax(-1)
        got_ids = attn.to(DEV)(luma.to(DEV)).argmax(-1).cpu()
    print(f"[chinese] TPGModel(prediction='Attn') greedy ids card vs CPU: identical share "
          f"{(got_ids == want_ids).float().mean().item():.4f} over {tuple(got_ids.shape)} (not gated)")
    del bilstm, attn, card


def chinese_card_vs_cpu_step() -> None:
    """One full-width ``--CHNSR --tpg OPT`` step at batch 8 with the recipe's
    flags (rotation pinned, dropout off, SGD at lr 1): the card (kernels)
    against the CPU (plain twins), each trainable model's gradient leaf
    by leaf with phase 8's two-tier gate, but the student's against the
    CPU step in float64 within STUDENT_LEAF_TOL, which the planted faults
    (TF32, one BatchNorm's eps doubled) must exceed."""
    cfg = Config(args=Flags(CHNSR=True, tpg="OPT", **TSRN_RECIPE))
    tatt = TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True, stn=True,
                text_emb=N_CHINESE, dropout=0.0)
    spec = recognizer_spec(cfg)
    models_cpu = [init_parameters(tatt, 7), init_parameters(spec.build(), 8),
                  init_parameters(spec.build(), 9)]
    ds = chinese_dataset(STEP_BATCH, 5)
    b = collate([ds[i] for i in range(STEP_BATCH)], alphabet=spec.alphabet)
    rot = {"rot_arc": torch.linspace(-0.08, 0.08, STEP_BATCH),
           "rot_offs": torch.linspace(0.1, 0.9, STEP_BATCH)}
    grads, counts = {}, {}
    for run, dev, dt in (("cpu", "cpu", torch.float32), ("cpu64", "cpu", torch.float64),
                         ("card", DEV, torch.float32), ("fault: tf32", DEV, torch.float32),
                         ("fault: bn eps", DEV, torch.float32)):
        models = [copy.deepcopy(m).to(dev, dt) for m in models_cpu]
        if run == "fault: bn eps":
            models[1].FeatureExtraction.conv0_1_bn.eps = 2e-5
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = run == "fault: tf32"
        hr, lr = to_device(b, torch.device(dev), True)
        batch = {"images_hr": hr.to(dt), "images_lr": lr.to(dt),
                 **{k: v.to(dev, dt) for k, v in rot.items()}}
        opt = torch.optim.SGD([p for m in models[:2] for p in m.parameters()], lr=1.0)
        reset_counts()
        t0 = time.perf_counter()
        metrics = train_step([models[0].train()], [models[1].train()], models[2].eval(), opt, batch,
                             StepConfig(), torch.Generator(device=dev).manual_seed(0),
                             spec.parse_fn)
        counts[run] = read_counts()
        grads[run] = [{k: p.grad.double().cpu() for k, p in m.named_parameters()} for m in models[:2]]
        print(f"[chinese-step] {run} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps({k: v.item() for k, v in metrics.items()})} launches {json.dumps(counts[run])}")
    set_cuda_flags()
    if counts["card"] != CHINESE_LAUNCHES:
        fail(f"card --CHNSR step launches {counts['card']} (want {CHINESE_LAUNCHES})")
    for i, (name, model) in enumerate(zip(("generator", "student"), models_cpu)):
        card = leaf_errors(grads["cpu"][i], grads["card"][i])
        f32 = leaf_errors(grads["cpu64"][i], grads["cpu"][i])
        card64 = leaf_errors(grads["cpu64"][i], grads["card"][i])
        rnn = rnn_leaves(model)
        # the student's other leaves: the card against the float64 step
        other = (card64, STUDENT_LEAF_TOL) if name == "student" else (card, LEAF_TOL)
        for what, keys, (err, tol) in (("BiGRU/BiLSTM", rnn, (card, RNN_LEAF_TOL)),
                                       ("other", set(card) - rnn, other)):
            worst = sorted(keys, key=lambda k: -err[k])
            gated = "card vs CPU float64" if err is card64 else "card vs CPU"
            print(f"[chinese-step] {name}, {len(keys)} {what} leaves, ||card - CPU|| / ||CPU|| (tol "
                  f"{tol} on {gated}; CPU float32 vs float64; card vs CPU float64):")
            for k in worst[:3]:
                print(f"[chinese-step]   {card[k]:.3e}  ({f32[k]:.3e}; {card64[k]:.3e})  {k}")
            bad = {k: err[k] for k in worst if not err[k] <= tol}
            if bad:
                fail(f"--CHNSR step: {name} {what} gradients card vs CPU above {tol}: {bad}")
    passed = []
    for run in ("fault: tf32", "fault: bn eps"):
        err = leaf_errors(grads["cpu64"][1], grads[run][1])
        worst = max(err, key=err.get)
        print(f"[chinese-step] planted {run}: the student's largest leaf error against the CPU "
              f"float64 step {err[worst]:.3e} ({worst}; {sum(e > STUDENT_LEAF_TOL for e in err.values())} "
              f"of {len(err)} leaves above {STUDENT_LEAF_TOL})")
        if not err[worst] > STUDENT_LEAF_TOL:
            passed.append(run)
    if passed:
        fail(f"--CHNSR step: the student gate {STUDENT_LEAF_TOL} passes the planted {passed}")


def chinese_host_costs() -> None:
    """Host work that grows with the alphabet, per batch of ``BATCH``: the
    collate's label fields over blank + the table against the CRNN's 37
    symbols, the CTC decode of [129, B, 3965] logits on the card (the
    judge's argmax on the card and the ids' collapse on the host, against
    copying the logits and taking the argmax on the host), the
    ``chinese`` filter."""
    ds = chinese_dataset(BATCH, 11)
    samples = [ds[i] for i in range(BATCH)]
    alphabet = "-" + voc_table("chinese")

    def host_ms(fn, n=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    logits = torch.randn(129, BATCH, N_CHINESE, device=DEV)
    labels = [s[2] for s in samples]
    costs = {"collate_chinese_ms": host_ms(lambda: collate(samples, alphabet=alphabet)),
             "collate_crnn_ms": host_ms(lambda: collate(samples)),
             "ctc_decode_card_argmax_ms": host_ms(
                 lambda: ctc_collapse(logits.argmax(-1).T.cpu().numpy(), alphabet)),
             "ctc_decode_host_argmax_ms": host_ms(
                 lambda: ctc_greedy_decode(logits.cpu().numpy(), alphabet)),
             "str_filt_ms": host_ms(lambda: [str_filt(w, "chinese") for w in labels * 3])}
    print(f"[chinese] host ms a batch of {BATCH}: {json.dumps(costs)} (one-hots "
          f"[{BATCH}, {len(set(alphabet))}, 1, 26] f32, "
          f"{BATCH * len(set(alphabet)) * 26 * 4 / 2**20:.1f} MiB)")


def chinese_phase(smi: str) -> list:
    """Phase 16: the Chinese path, ``--CHNSR --tpg OPT`` (checks and numbers
    in the module docstring).  Returns the LSTM kernels' rows at the TPG
    BiLSTM's shapes."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(16)
    tpg_card_vs_cpu(gen)

    # ---- kernels #3 and #4 at the TPG BiLSTM's L=129 R=64 H=256 (In 512 / 256)
    with torch.no_grad():
        fwd_rows = [check_lstm("TPG seq0", 129, BATCH, 512, 256, gen),
                    check_lstm("TPG seq1", 129, BATCH, 256, 256, gen)]
    bwd_rows = [check_lstm_bwd("TPG seq0", 129, BATCH, 512, 256, gen),
                check_lstm_bwd("TPG seq1", 129, BATCH, 256, 256, gen)]
    for row in fwd_rows:
        print("[chinese-kernel] " + json.dumps(row))
        print_lstm(row, smi)
        if not row["max_abs_err"] <= KERNEL_ATOL:
            fail(f"kernel {row['shape']}: err {row['max_abs_err']} > {KERNEL_ATOL}")
    for row in bwd_rows:
        print("[chinese-kernel-bwd] " + json.dumps(row))
        print_bwd_split("lstm-bwd", row, LSTM_BWD_ENTRIES)
        if not row["ok"]:
            fail(f"backward kernel {row['shape']}: {row}")

    # ---- Trainer steps at full width, batch 64
    train_ds = chinese_dataset(8 * BATCH, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = chinese_trainer(1234, train_ds)
    t0 = time.perf_counter()
    first = trainer.train(max_iters=CHINESE_WARM)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    timed = trainer.train(max_iters=CHINESE_WARM + CHINESE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = {k: v / CHINESE_STEPS for k, v in read_counts().items()}
    metrics = {k: first["metrics"][k] + timed["metrics"][k] for k in timed["metrics"]}
    sr, ips = metrics["loss_sr"], CHINESE_STEPS * BATCH / wall
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"[chinese] Trainer --CHNSR --tpg OPT, recipe flags: {CHINESE_STEPS} steps at batch {BATCH} "
          f"after {CHINESE_WARM} ({warm_s:.1f} s), images/s {ips:.1f}, {wall / CHINESE_STEPS * 1e3:.1f} "
          f"ms a step, max memory {mem:.2f} GiB; launches per step {json.dumps(per_step)} (want "
          f"{json.dumps(CHINESE_LAUNCHES)}); loss_sr {[round(v, 4) for v in sr]} ({smi})")
    if per_step != {k: float(v) for k, v in CHINESE_LAUNCHES.items()}:
        fail(f"--CHNSR train launches per step {per_step} (want {CHINESE_LAUNCHES})")
    if not all(math.isfinite(v) for vals in metrics.values() for v in vals):
        fail("--CHNSR: non-finite training metrics")
    print(f"[chinese] loss_sr median of steps 2-4 {np.median(sr[1:4]):.4f}, of the last 5 "
          f"{np.median(sr[-5:]):.4f}")
    if not np.median(sr[-5:]) < np.median(sr[1:4]):
        fail(f"--CHNSR: loss_sr did not fall: {sr[1:4]} -> {sr[-5:]}")

    # ---- Evaluator: the teacher TPG as judge, NED and accuracy under the chinese filter
    ds, warm_ds = chinese_dataset(4 * BATCH, 2), chinese_dataset(BATCH, 3)
    evaluator = trainer.evaluator
    trainer.evaluate(warm_ds)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    summary = trainer.evaluate(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {"bigru_fwd": 10 * 4, "bigru_bwd": 0, "bilstm_fwd": 0, "bilstm_bwd": 0}
    print(f"[chinese] Evaluator (judge: the teacher TPG, filter {evaluator.spec.filter_mode}) at batch "
          f"{BATCH}: images/s {summary['images'] / wall:.1f}, psnr {summary['psnr_avg']:.4f} ssim "
          f"{summary['ssim_avg']:.5f} acc {summary['accuracy']:.4f} ned {summary['ned']:.4f}, "
          f"launches {json.dumps(counts)} (want {json.dumps(want)}) ({smi})")
    if (counts != want or not math.isfinite(summary["psnr_avg"]) or not 0.0 <= summary["ned"] <= 1.0
            or evaluator.spec.filter_mode != "chinese"):
        fail(f"--CHNSR eval: launches {counts}, summary {summary}")
    del trainer, evaluator
    torch.cuda.empty_cache()

    chinese_card_vs_cpu_step()
    chinese_host_costs()

    # ---- cli.run --CHNSR --tpg OPT, then --go_test of its best checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        yaml = os.path.join(tmp, "chnsr.yaml")
        with open(yaml, "w") as fh:
            fh.write(f"TRAIN:\n  batch_size: {BATCH}\n  voc_type: chinese\n"
                     f"  saveInterval: {CHINESE_CLI_ITERS}\n  ckpt_dir: '{os.path.join(tmp, 'ckpt')}'\n"
                     f"  VAL:\n    valInterval: {CHINESE_CLI_ITERS}\n    crnn_pretrained: ''\n")
        argv = RECIPE + ["--CHNSR", "--tpg", "OPT", "--config", yaml, "--vis_dir", "vis_chnsr",
                         "--synthetic", str(4 * BATCH)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code, _ = cli.run(argv + ["--max_iters", str(CHINESE_CLI_ITERS)])
        best_path = os.path.join(tmp, "ckpt", "vis_chnsr", "model_best_acc_0.ckpt")
        if code != 0 or not os.path.exists(best_path):
            fail(f"cli.run --CHNSR --tpg OPT: exit {code}, output {out.getvalue()[-500:]}")
        best = load_checkpoint(best_path)["best_history_res"]["easy"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli.main(argv + ["--go_test", "--resume", best_path])
        lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[easy] ")]
        got = ast.literal_eval(lines[-1][len("[easy] "):]) if lines else {}
        print(f"[chinese] cli.run --CHNSR --tpg OPT {CHINESE_CLI_ITERS} steps, --go_test of "
              f"model_best_acc_0.ckpt: psnr {got.get('psnr_avg')} ssim {got.get('ssim_avg')} acc "
              f"{got.get('accuracy')} ned {got.get('ned')}; saved with it: psnr {best['psnr_avg']} "
              f"ssim {best['ssim_avg']} acc {best['accuracy']} ned {best['ned']}")
        if code != 0 or not got or got["images"] != best["images"]:
            fail(f"--go_test --CHNSR --tpg OPT: exit {code}, output {out.getvalue()[-500:]}")
        if not (abs(got["psnr_avg"] - best["psnr_avg"]) <= GO_TEST_PSNR_TOL
                and abs(got["ssim_avg"] - best["ssim_avg"]) <= GO_TEST_SSIM_TOL
                and got["accuracy"] == best["accuracy"] and abs(got["ned"] - best["ned"]) <= 1e-9):
            fail(f"--go_test --CHNSR summary {got} differs from the saved {best}")
    print(f"[chinese] train images/s at batch {BATCH} {ips:.1f}, max memory {mem:.2f} GiB ({smi}); "
          f"phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return fwd_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forward-kernels-only", action="store_true",
                    help="stop after phase 2 (a quick look at the forward kernels' "
                         "accuracy and times); prints no result line")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1, 2 and 6 alone (every kernel against its plain "
                         "version, with times); prints no result line")
    ap.add_argument("--lstm-bwd-only", action="store_true",
                    help="run phase 1 and the LSTM backward of phase 6 alone (to time "
                         "versions of that kernel in turns); prints no result line")
    ap.add_argument("--gru-fwd-only", action="store_true",
                    help="run phase 1 and the BiGRU forward rows of phase 2 alone (to time "
                         "versions of that kernel in turns); prints no result line")
    ap.add_argument("--data-only", action="store_true",
                    help="run phases 1 and 10 alone (the real-data path through the CLI: LMDB "
                         "data, checkpoints, resume, --go_test); prints no result line")
    ap.add_argument("--pretrain-only", action="store_true",
                    help="run phases 1 and 11 alone (CTC pretraining of the CRNN); prints no "
                         "result line")
    ap.add_argument("--flags-only", action="store_true",
                    help="run phases 1 and 12 alone (the TATT step's flags); prints no result "
                         "line")
    ap.add_argument("--tsrn-only", action="store_true",
                    help="run phases 1 and 14 alone (the TSRN family at full width); prints "
                         "no result line")
    ap.add_argument("--zoo-only", action="store_true",
                    help="run phases 1 and 15 alone (the zoo at full width); prints no result "
                         "line")
    ap.add_argument("--chinese-only", action="store_true",
                    help="run phases 1 and 16 alone (the Chinese path, --CHNSR --tpg OPT); prints "
                         "no result line")
    ap.add_argument("--judges-only", action="store_true",
                    help="run phases 1 and 13 alone (the ASTER and MORAN judges, LPIPS, --vis, "
                         "--demo, --test); prints no result line")
    args = ap.parse_args(argv)
    t_run = time.perf_counter()
    set_cuda_flags()  # full f32 (no TF32) and cuDNN autotuning
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] nvcc of {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, report in _build.ptxas_report.items():
        # per entry function (its mangled name, template arguments included):
        # registers and spills
        regs = [ln.split("'")[1] if "Compiling entry function" in ln else ln.strip()
                for ln in report.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry function" in ln]
        print(f"[build] {name}: {' | '.join(regs)}")
    for hid, rows in ((256, BATCH), (256, BATCH - 3), (64, BATCH)):
        print(f"[build] bilstm_fwd plan at H={hid} R={rows}: {json.dumps(bilstm_fwd_plan(hid, rows))}")
    for hid, rows in ((256, BATCH), (256, BATCH - 3), (64, BATCH), (111, BATCH)):
        print(f"[build] bilstm_bwd plan at H={hid} R={rows}: {json.dumps(bilstm_bwd_plan(hid, rows))}")
    for hid, rows in ((32, 2 * BATCH * 64), (32, 2 * BATCH * 16), (128, 2 * BATCH * 16)):
        print(f"[build] bigru_bwd plan at H={hid} R={rows}: {json.dumps(bigru_bwd_plan(hid, rows))}")
    for hid, rows in ((32, 2 * BATCH * 64), (32, 2 * BATCH * 16), (32, BATCH * 64),
                      (32, BATCH * 16), (128, BATCH * 16)):
        print(f"[build] bigru_fwd plan at H={hid} R={rows}: {json.dumps(bigru_fwd_plan(hid, rows))}")

    if args.lstm_bwd_only:
        backward_kernels(torch.Generator().manual_seed(0), lstm_only=True)
        return 0
    if args.data_only:
        data_phase(None)
        return 0
    if args.pretrain_only:
        pretrain_phase(smi)
        return 0
    if args.flags_only:
        flags_phase(smi, None)
        return 0
    if args.judges_only:
        judges_phase(smi)
        print(f"[smoke] the whole run took {time.perf_counter() - t_run:.1f} s")
        return 0
    if args.tsrn_only:
        tsrn_phase(smi)
        print(f"[smoke] the whole run took {time.perf_counter() - t_run:.1f} s")
        return 0
    if args.zoo_only:
        zoo_phase(smi)
        print(f"[smoke] the whole run took {time.perf_counter() - t_run:.1f} s")
        return 0
    if args.chinese_only:
        chinese_phase(smi)
        print(f"[smoke] the whole run took {time.perf_counter() - t_run:.1f} s")
        return 0

    # ---- 2. forward kernels against their plain versions at the main paths' shapes
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        # the kernels line reads the training pair, rows 2 and 3
        gru_rows = [
            check_gru("gru1 (height scan), eval batch", 16, BATCH * 64, 128, 64, 32, gen),
            check_gru("gru2 (width scan), eval batch", 64, BATCH * 16, 64, 64, 32, gen),
            check_gru("gru1, fused train batch 2B", 16, 2 * BATCH * 64, 128, 64, 32, gen),
            check_gru("gru2, fused train batch 2B", 64, 2 * BATCH * 16, 64, 64, 32, gen),
            check_gru("gru1 ragged rows", 16, BATCH * 64 + 3, 128, 64, 32, gen),
            check_gru("gru2 odd H=45, ragged rows", 64, BATCH * 16 + 5, 64, 64, 45, gen),
            check_gru("gru2 H=128", 64, BATCH * 16, 64, 64, 128, gen),
        ]
        lstm_rows = [] if args.gru_fwd_only else [
            check_lstm("student/teacher rnn0", 26, BATCH, 512, 256, gen),
            check_lstm("student/teacher rnn1", 26, BATCH, 256, 256, gen),
            check_lstm("judge rnn0 (H=64)", 26, BATCH, 128, 64, gen),
            check_lstm("judge rnn1 (H=64)", 26, BATCH, 64, 64, gen),
            check_lstm("student rnn0 ragged rows", 26, BATCH - 3, 512, 256, gen),
        ]
    for row in gru_rows + lstm_rows:
        print("[kernel] " + json.dumps(row))
        if not row["max_abs_err"] <= KERNEL_ATOL:
            fail(f"kernel {row['shape']}: err {row['max_abs_err']} > {KERNEL_ATOL}")
    for row in gru_rows:
        print_gru(row)
    for row in lstm_rows:
        print_lstm(row)
    if args.forward_kernels_only or args.gru_fwd_only:
        return 0
    if args.kernels_only:
        backward_kernels(gen)
        return 0

    # ---- 3. the eval path at full width
    generator = init_parameters(TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True), 1234)
    student = init_parameters(CRNN(), 1235)
    judge = load_judge()
    generator, student, judge = (m.to(DEV).eval() for m in (generator, student, judge))
    evaluator = Evaluator([generator], [student], judge, DEV, batch_size=BATCH, mask=True)
    ds = SyntheticTextDataset(n=256, seed=2)
    warm = SyntheticTextDataset(n=BATCH, seed=3)
    for d in (ds, warm):  # render (and cache) every sample up front
        for i in range(len(d)):
            d[i]
    evaluator.evaluate(warm)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    summary = evaluator.evaluate(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_launches = read_counts()
    n_batches = math.ceil(len(ds) / BATCH)
    print(
        f"[eval] images {summary['images']} psnr {summary['psnr_avg']:.4f} ssim "
        f"{summary['ssim_avg']:.5f} (bicubic LR: psnr {summary['psnr_avg_lr']:.4f} ssim "
        f"{summary['ssim_avg_lr']:.5f}) acc SR {summary['accuracy']:.4f} LR "
        f"{summary['accuracy_lr']:.4f} HR {summary['accuracy_hr']:.4f} "
        f"images/s {summary['images'] / wall:.1f}"
    )
    print(f"[eval] launches {json.dumps(eval_launches)} over {n_batches} batches of {BATCH}")
    # 10 GruBlocks per generator forward; 2 BiLSTMs per CRNN forward, 4
    # CRNN forwards per batch (student, then the judge on SR, LR, HR); no
    # backward kernel under no_grad
    if eval_launches != {"bigru_fwd": 10 * n_batches, "bigru_bwd": 0,
                         "bilstm_fwd": 8 * n_batches, "bilstm_bwd": 0}:
        fail(f"eval launches {eval_launches} (want 10 and 8 per batch, no backward)")
    for key in ("psnr_avg", "ssim_avg"):
        if not math.isfinite(summary[key]):
            fail(f"eval {key} = {summary[key]}")

    hr, lr, _ = next(evaluator.batches(ds))
    sr_gpu, aux = eval_step([generator], [student], lr)
    if sr_gpu.shape != (BATCH, 4, 32, 128) or not torch.isfinite(sr_gpu).all():
        fail(f"SR shape {tuple(sr_gpu.shape)} or non-finite values")
    gen_cpu, stu_cpu = generator.to("cpu"), student.to("cpu")
    t0 = time.perf_counter()
    sr_cpu, _ = eval_step([gen_cpu], [stu_cpu], lr.cpu())
    cpu_s = time.perf_counter() - t0
    generator, student = gen_cpu.to(DEV), stu_cpu.to(DEV)
    sr_err = (sr_gpu.cpu() - sr_cpu).abs().max().item()
    print(f"[eval] SR card vs CPU (plain recurrences): max abs diff {sr_err:.3e} tol {SR_ATOL} "
          f"(CPU batch took {cpu_s:.1f} s)")
    if not sr_err <= SR_ATOL:
        fail(f"SR card vs CPU {sr_err} > {SR_ATOL}")

    # ---- 4. the trained judge reads HR through the LSTM kernel
    jds = SyntheticTextDataset(n=64, seed=20260818)
    labels = [jds[i][2] for i in range(64)]
    before = bilstm_recurrence.launches

    def word_acc(k):
        imgs = np.stack([np.asarray(jds[i][k].convert("RGB"), np.float32) / 255.0 for i in range(64)])
        with torch.no_grad():
            logits = judge(parse_crnn_input(torch.from_numpy(imgs.transpose(0, 3, 1, 2)).to(DEV)))
        preds = ctc_greedy_decode(logits.cpu().numpy())
        return float(np.mean([str_filt(p, "lower") == str_filt(t, "lower") for p, t in zip(preds, labels)]))

    acc_hr, acc_lr = word_acc(0), word_acc(1)
    print(f"[judge] fixture judge word accuracy HR {acc_hr:.4f} LR {acc_lr:.4f} "
          f"(LSTM launches {bilstm_recurrence.launches - before})")
    if not (acc_hr > 0.85 and acc_hr > acc_lr + 0.2 and bilstm_recurrence.launches - before == 4):
        fail(f"judge HR {acc_hr} LR {acc_lr}")

    # ---- 5. where the device time goes in one eval batch
    with torch.no_grad():
        profile_window(lambda: evaluator.evaluate(warm), "one eval batch")
    del generator, student, judge, evaluator

    # ---- 6. backward kernels against their plain twins at the training path's shapes
    gru_bwd_rows, lstm_bwd_rows = backward_kernels(gen)

    # ---- 7. the training path at full width: Trainer.train, canonical recipe
    torch.manual_seed(0)
    generator = init_parameters(
        TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True, stn=True), 1234
    ).to(DEV)
    student = init_parameters(CRNN(), 1235).to(DEV)
    teacher = init_parameters(CRNN(), 1236).to(DEV)
    train_ds = SyntheticTextDataset(n=8 * BATCH, seed=1)
    for i in range(len(train_ds)):  # render (and cache) every sample up front
        train_ds[i]
    cfg = Config(args=Flags(STN=True, mask=True, use_distill=True, gradient=True, sr_share=True,
                            tssim_loss=True, rotate_train=5.0, batch_size=BATCH))
    cfg.TRAIN.VAL.valInterval = cfg.TRAIN.saveInterval = 0
    cfg.TRAIN.displayInterval = 10**9
    trainer = Trainer(cfg, [generator], [student], teacher, train_ds, DEV)
    t0 = time.perf_counter()
    first = trainer.train(max_iters=TRAIN_WARM)  # builds, cuDNN autotuning
    torch.cuda.synchronize()
    print(f"[train] warm-up: {TRAIN_WARM} steps in {time.perf_counter() - t0:.2f} s")
    reset_counts()
    t0 = time.perf_counter()
    timed = trainer.train(max_iters=TRAIN_WARM + TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = read_counts()
    per_step = {k: v / TRAIN_STEPS for k, v in train_launches.items()}
    losses = first["metrics"]["loss_total"] + timed["metrics"]["loss_total"]
    synthetic_ips = TRAIN_STEPS * BATCH / wall
    print(f"[train] {TRAIN_STEPS} steps at batch {BATCH}: {wall:.3f} s, "
          f"{wall / TRAIN_STEPS * 1e3:.2f} ms per step, images/s {synthetic_ips:.1f}")
    print(f"[train] launches per step {json.dumps(per_step)}")
    print(f"[train] loss_total by step {json.dumps([round(v, 4) for v in losses])}")
    last = {k: v[-1] for k, v in timed["metrics"].items()}
    print(f"[train] last step {json.dumps(last)}")
    if per_step != {k: float(v) for k, v in STEP_LAUNCHES.items()}:
        fail(f"train launches per step {per_step} (want {STEP_LAUNCHES})")
    if not all(math.isfinite(v) for vals in (first, timed) for m in vals["metrics"].values() for v in m):
        fail("non-finite training metrics")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"loss_total did not fall: {losses[:3]} -> {losses[-3:]}")

    # ---- 8. one train step at full width, batch 8: card (kernels) against CPU (plain twins)
    card_vs_cpu_step("step", StepConfig(), 1, 1, STEP_LAUNCHES)

    # ---- 9. where the device time goes over a few train steps
    profile_window(lambda: trainer.train(max_iters=trainer.iters + PROFILE_STEPS),
                   f"{PROFILE_STEPS} train steps")
    del trainer, generator, student, teacher

    # ---- 10. the real-data path through the CLI
    data_phase(synthetic_ips)

    # ---- 11. CTC pretraining of the CRNN
    pretrain_phase(smi)

    # ---- 12. the TATT step's flags
    flags_phase(smi, synthetic_ips)

    # ---- 13. the evaluation protocol: ASTER and MORAN judges, LPIPS, --vis, --demo, --test
    judge_lstm_rows = judges_phase(smi)

    # ---- 14. the TSRN family: factory archs, the plain step, the CLI
    tsrn_phase(smi)

    # ---- 15. the zoo: every other factory arch, PCAN through the BiGRU kernels
    zoo_phase(smi)

    # ---- 16. the Chinese path: the TPG recognizer, --CHNSR --tpg OPT
    chinese_lstm_rows = chinese_phase(smi)

    # ---- the kernels line: per launch, weighted by the training path's mix
    # (per step gru1 and gru2 five times each, forward and backward; the
    # student's and the teacher's rnn0 and rnn1 forward, the student's backward)
    def mix(rows):
        out = {k: float(np.mean([r[k] for r in rows])) for k in
               ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        out["bound_by"] = rows[int(np.argmax([r["bound_ms"] for r in rows]))]["bound_by"]
        return out

    kernels = []
    for name, src, rep, rows, checked in (
        ("bigru_fwd", "tatt_tpu_torch/csrc/bigru_fwd.cu", "tatt_tpu/kernels/pallas_gru.py:63",
         gru_rows[2:4], gru_rows),
        ("bigru_bwd", "tatt_tpu_torch/csrc/bigru_bwd.cu", "tatt_tpu/kernels/pallas_gru.py:132",
         gru_bwd_rows[:2], gru_bwd_rows),
        ("bilstm_fwd", "tatt_tpu_torch/csrc/bilstm_fwd.cu", "tatt_tpu/kernels/pallas_lstm.py:22",
         lstm_rows[:2], lstm_rows + judge_lstm_rows + chinese_lstm_rows),
        ("bilstm_bwd", "tatt_tpu_torch/csrc/bilstm_bwd.cu", "tatt_tpu/kernels/pallas_lstm.py:53",
         lstm_bwd_rows[:2], lstm_bwd_rows),
    ):
        m = mix(rows)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": train_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": m["kernel_ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    print(f"[smoke] the whole run took {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
