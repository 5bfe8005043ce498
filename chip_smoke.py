#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which raises (a non-zero exit, no result line) when it
fails:

1. environment: the card's name and power limit; TF32 off for matrix
   products and convolutions, so float32 means float32, and bfloat16
   products summed in float32;
2. build: every CUDA kernel of the port, from ``mxnet_tpu_torch/csrc``,
   one nvcc per source, all at once, with each kernel's registers and
   spills (none allowed in the backward kernels); the SASS of both
   bfloat16 attention kernels, forward and backward, must hold
   tensor-core (``HGMMA``) and TMA (``UTMALDG``) instructions; then one
   ``mt.rtc`` kernel compiled by NVRTC cold, and again from the module
   cache;
3. kernel check: each kernel against its plain PyTorch version on the
   card, at the serving shapes and at ragged, cross-shaped, single-row
   and other head-dim shapes, every case in float32 and bfloat16, with
   the inputs the wrapper must copy first (head_dim 20 in bfloat16)
   counted: the attention forward (K1) and its backward (B2), and in
   float32 the gradients through ``FlashAttention`` (K1 then B2) against
   torch autograd of the plain forward; then B2 launched twice on the
   serving shapes in each dtype, its gradients bitwise equal;
4. rtc check: each ``language="cuda"`` rtc kernel against its
   ``language="torch"`` plain version on the card: ``tests/test_rtc.py``'s
   three cases, explicit grid and block dims, bfloat16, outputs that are
   strided views or of another dtype, and a push at new shapes;
5. casts: float32 -> uint8/int8/int32 ``Cast`` and ``astype`` on the
   card, saturating with NaN to 0, exactly as the JAX package's;
6. serve: the transformer LM at GPT-2 small's published widths, random
   weights from a seed, saved as ``-symbol.json`` + ``.params`` and
   loaded by ``Predictor.from_checkpoint`` onto the card, which captures
   its forward in a CUDA graph; three requests of 4 x 1024 tokens, each
   a replay, the kernels of one counted in a ``torch.profiler`` trace,
   and the logits held against the port's own CPU run of one request;
   then serve_server: ResNet-50 (NHWC, 1000 classes, 224 x 224) and
   GPT-2 small's logits behind one ``ModelServer`` on the card, buckets
   1/4/8/16/32, one CUDA graph per (tenant, bucket) in one memory pool
   (peak memory also with a pool per graph): 10 captures and no retrace
   at start; bursts that fill every bucket or leave it padded, each
   request held against its tenant's eager unpadded forward and one per
   tenant against the CPU Predictor; a replayed GPT-2 batch's kernels
   from a trace; open-loop Poisson load (ResNet-50 at 0.5x and 2x its
   single-request capacity, GPT-2 at 0.5x, at once); fault drills
   (a poisoned request, a breaker, a drain); an overload probe; then
   serve_int8: the same two tenants quantized to int8 weights for
   bfloat16 compute (``contrib.quantization``: ResNet-50 calibrated over
   SERVE_CALIBRATION images at the 99.9th percentile, GPT-2 small
   weights-only) behind ``ModelServer(precision="int8")``: every int8
   weight one byte an element beside the tenant's bytes in bfloat16, 10
   captures with K1-bf16 in GPT-2's buckets, a burst of 4 rows a tenant
   against the port's CPU forward of the same quantized model and
   against the float32 tenant's top-1, a planted fault (a weight's
   scales doubled) read past the tolerance, and a replay's ms a bucket
   beside the float32 ones;
7. imperative: one GPT-2-small block built only from ``mt.nd`` calls on
   ``mt.gpu()`` NDArrays at 4 x 1024 tokens, its GELU an ``mt.rtc``
   CUDA kernel, with each kernel's launches counted and the result held
   against the same calls on ``mt.cpu()`` NDArrays; then one bfloat16
   ``_contrib_DotProductAttention`` call on ``mt.gpu()`` NDArrays at the
   serving shapes, recorded by ``mt.autograd`` and backpropagated, which
   launches the bfloat16 forward and backward kernels once each;
8. train: ``Module.fit`` trains the LM at GPT-2 small's widths and full
   depth on the card (Adam, batch 4 x 1024 tokens, TRAIN_EPOCHS epochs of
   TRAIN_BATCHES batches of memorizable cyclic token sequences) on the
   classic executor path (``MXTPU_MODULE_FUSED=never``), with 12 forward
   and 12 backward attention launches asserted each step, no input
   copied, and the perplexity asserted to fall; step time, tokens/s and
   peak device memory; then one step's every parameter gradient held
   against the port's CPU run of the same step (depth cut to 2 layers
   there);
9. train_fused: the same cell through Module's default policy on the
   card, the fused Trainer, whose step is captured once in a CUDA graph
   and replayed: one capture and a replay a step after it, the kernels'
   launches of a replayed step counted in a ``torch.profiler`` trace
   (12 K1 and 12 B2), the parameters after its first two steps held
   against the classic phase's, the perplexity's fall; then
   train_fused_bf16: the same with ``compute_dtype="bfloat16"``, the
   bfloat16 kernels in its replayed step, and its first step's float32
   gradients held against the float32 fused step's;
10. sentinel: the fused step's sentinel build through capture and
   replays (the LM, depth cut to 2 blocks), and GPT-2's MLP block with a
   Dropout: a NaN batch inside a replay leaves params and optimizer
   state bitwise as they were, and every replay draws fresh masks;
11. train_resnet_vs_cpu: one float32 step of ResNet-50 (NHWC, batch 4 of
   112 x 112, random weights) through the fused Trainer on the card and on
   the CPU, with cuDNN's TF32 flag at PyTorch's default (on): the head's
   gradients, the moving statistics and the outputs within RESNET_TOL,
   every gradient by median and largest error, the flag still on after;
12. train_resnet_bf16: ``Module.fit`` trains ResNet-50 at bench.py's
   configuration (batch 256 of 224 x 224, bfloat16 compute, SGD momentum)
   for 12 steps of one repeated batch made on the card: one capture and a
   replay a step, no input copied, none of the port's kernels launched,
   the first step's head gradients against float32 compute's, a falling
   cross-entropy; step ms, img/s and peak memory; then
   train_resnet_records: bench.py's record file (512 random 256 x 256
   JPEGs, quality 90) written to a temporary directory, the port's native
   loader built (libjpeg, else nvJPEG) and its batch held against
   Pillow's decode, decode img/s and one batch's pinned upload timed
   alone, the on-card augment held against plain crops and numpy slicing;
   then the cell trained RECORDS_STEPS steps by ``Module.fit`` with a
   ``dist_sync_tpu`` store through each of bench.py's pipelines, cached
   (``DeviceCacheIter``) and stream (loader -> ``DeviceUploadIter`` ->
   ``StreamAugmentIter``): every batch on the card and uncopied, int32
   labels, one capture and a replay a step, none of the port's kernels;
   img/s, step ms, the bound, efficiency, the uploader's stats, the
   device idle share of 3 traced steps, peak memory;
13. train_lstm_bucketing: examples/rnn/lstm_bucketing.py's bucketing LSTM
   LM (2 LSTM layers of 200, vocabulary 10,000, batch 32, buckets 10-60)
   through ``BucketingModule.fit`` for 2 epochs of the example's synthetic
   corpus: first one float32 forward and backward a bucket against the
   port's CPU run, and the ``RNN`` op at T 60 against the CPU's; then every
   bucket bound, one parameter storage shared by all, every batch on the
   card, the trained loss falling by epoch, none of the port's kernels;
   step ms a bucket, tokens/s, each bucket's first use, the memory the six
   buckets hold, the idle share and kernels of traced steps;
14. train_resume: the fused bfloat16 GPT-2 cell (its widths, RESUME_LAYERS
   deep, RESUME_EPOCHS epochs) trained by ``Module.fit`` with a
   ``CheckpointManager`` checkpoint every epoch, in three processes of
   its own: uninterrupted; killed inside its second save
   (``MXTPU_FAULTS="crash@ckpt_write:save=2"``: exit 137, a ``.tmp``
   left); restarted with ``resume=True``, which sweeps the ``.tmp``, and
   whose parameters must be bitwise the uninterrupted run's after every
   step and at the end; save ms, bytes a checkpoint, CRC ms, the scan's
   ms and the restart's time to its first step;
15. train_reshape: the same cell, two steps at batch 4, ``Module.reshape``
   to batch 8, two steps, back to 4, one step: each step after a reshape
   bitwise the step of a fresh module bound at that shape with the same
   parameters and optimizer state, one CUDA graph captured a shape; the
   capture ms and the memory the second graph holds;
16. train_monitor: ``Monitor(1, pattern=".*")`` on the classic float32
   cell for two steps, each bitwise (outputs and every gradient) an
   unmonitored module's step; the statistics of a step at GPT-2's widths
   against the port's CPU run; rows a step, step ms with and without the
   tap;
17. module_family: examples/module/python_loss.py (``SequentialModule`` +
   ``PythonLossModule``, the numpy gradient back on the card) and
   examples/module/mnist_mlp.py's MLP through ``FeedForward.create`` (the
   fused path), at the examples' sizes, each against the port's CPU run,
   train accuracy rising past the examples' bars;
18. train_zoo: examples/image-classification/common/fit.py's harness on
   each of the zoo's networks at full width (alexnet, vgg-16, googlenet,
   inception-bn, inception-v3, inception-resnet-v2, resnext-50; 1000
   classes, batch 128 of 224^2 or 299^2, NCHW, bfloat16 compute), each
   with one of the example's optimizers, ``Module.fit`` over 8 steps of one
   repeated batch with a MultiFactorScheduler stepping inside the run,
   Xavier("gaussian", "in", 2), accuracy and top-5 accuracy, a device
   store: one capture and a replay a step, the new lr read by the graph,
   a falling loss, none of the port's kernels; step ms, img/s, capture
   ms, peak memory; beside each, one float32 step at batch 2 held against
   the port's CPU run;
19. optimizers: every registered optimizer on mnist_mlp.py's MLP, three
   classic and three fused steps on the card against the port's CPU
   (SGLD on the classic path, its noise held by its moments and its
   determinism per seed), the five update ops against their CPU results,
   and a ``fit(checkpoint=, resume=True)`` with centered RMSProp crashed
   inside a save and resumed, bitwise the uninterrupted run;
20. train_fcn: FCN-8s (upstream example/fcn-xs) at VGG-16's widths, 21
   classes, batch 1 of 500 x 500 with a label border of 255 to ignore,
   through ``Module.fit`` (SGD momentum 0.99, wd 5e-4, Bilinear
   Deconvolutions, Xavier elsewhere) for 8 steps of one batch in float32
   and in bfloat16: one capture and a replay a step, a falling float32
   loss, none of the port's kernels; every Deconvolution and Crop output
   on the card; step ms, img/s, capture ms, peak memory and a replayed
   step's device time by kernel group; one float32 step at 64 x 64 held
   against the CPU;
21. loss_examples: the six loss-layer examples (fcn-xs, autoencoder,
   svm_mnist, nce-loss, recommenders, dec) at their own sizes on the card
   and on the port's CPU, on Module's fused path (the card's default) and
   on its classic one, each run passing its example's own assert, the
   card's parameters within EXAMPLE_PARAM_TOL of the CPU's on each path;
22. op_sweep_card: every case of ``tests/test_op_sweep.py``'s table (the
   port registers every op of it), forward and backward on the card
   against the CPU within the case's tolerance, the imperative
   ``_imdecode`` onto the card; then detection_ops: Proposal and
   ROIPooling on Faster R-CNN's 38 x 50 RPN map of a 600 x 800 image, and
   MultiBoxPrior, MultiBoxTarget and MultiBoxDetection at SSD-300's 8,732
   anchors, 21 classes, batch 32, forward and backward on the card
   against the CPU; then item8_examples: examples/numpy-ops,
   torch-interop, ssd, rcnn and warpctc unchanged under the port on the
   card (``tools/torch_run_example.py``), each to its own assert, the SSD
   toy's fused step captured once, the scripts with a Python node on the
   classic path naming it; and a Custom node through ``fit`` on the fused
   path (its steps uncaptured, the reason named) and behind a
   ``ModelServer`` (its forward eager), each against the CPU;
23. dist_one_rank_nccl: ``tools/launch.py -n 1`` starts one worker,
   which joins a one-rank ``torch.distributed`` group over NCCL at import
   and fits the ResNet cell of train_resnet_bf16 twice: without a store,
   and with ``dist_sync_tpu``, whose fused step spans the one-rank mesh:
   one capture, the NCCL all-reduce among a traced replay's kernels
   (printed), the parameters and moving statistics bitwise the run's
   without a store; step ms and img/s beside train_resnet_bf16's;
24. dist_two_ranks_shared_card: ``tools/launch.py -n 2``, two ranks over
   gloo, both on card 0: the classic ``dist_sync`` path on the MLP and
   LeNet, then the fused step over the two-rank mesh on ResNet-50 at
   full width (DIST_SHARED_BATCH rows a rank, bench.py's global batch,
   bfloat16) at zero=0, zero=1 and with the bfloat16 wire, uncaptured
   (the collectives are the host's): every run's parameters bitwise
   alike on both ranks; the classic runs within DIST_CLASSIC_TOL of one
   process over the same global batches, and ResNet-50 (BatchNorm over
   the whole global batch) within DIST_RESNET_TOL of one process
   stepping the global batch; zero=1 bitwise zero=0, the bfloat16 wire
   within 2^-8 an element; each step's ms and the collectives' share of
   it; then dist_across_cards, a rank a card over NCCL (the MLP's and a
   convolution-BatchNorm net's fused steps at zero 0 and 1 and with the
   bfloat16 wire, captured, against one process), which runs only where
   the machine has two cards or more;
25. multi_context: ``Module(context=[gpu(0), gpu(0)])`` on the classic
   path (two executors, half a batch each, the store merging their
   gradients) against one context over the same batches, MLP and LeNet;
26. remat: the fused bfloat16 step of GPT-2 small and of ResNet-50 at
   batch 256 under each remat policy (none, convs_dots, dots, nothing):
   the first step's gradients against none's, step ms, peak memory, K1
   and B2 launches a step; GPT-2's MLP block with a Dropout under
   ``nothing`` through capture and replays, where the recompute draws
   the forward's masks; and ``donate_batch=True`` fed the rows of one
   on-card dataset in turn (left as they were) and whole batch tensors
   (each emptied after its step), bitwise a trainer that keeps them;
27. integrity: the fused step's silent-data-corruption defence on
   GPT-2 small in bfloat16 (train_fused_bf16's cell) and on the ResNet-50
   cell: ``integrity="fp"`` at period 1 over 12 steps bitwise ``off``,
   its check a CUDA graph of its own; the device fingerprint of the
   state equal to the host's over the state copied off the card; the
   check's device time beside a step replay's and its share of a step at
   the default period of 100; the replay audit clean over 12 steps (5 on
   ResNet-50) and ``bitflip@step=6`` detected at step 6; ``Module.fit``
   with a ``CheckpointManager`` under the audit, a flip in its second
   epoch rolled back to the newest verified checkpoint, ending bitwise a
   run without the fault; K1-bf16 and B2-bf16 launched;
28. integrity_vote: ``tools/launch.py -n 2``, two gloo ranks on the
   card, GPT-2 small in bfloat16 at 4 rows a rank under ``vote``, at
   zero 0 and 1: a flip on rank 1 raises on both ranks at the next check
   with the blame undetermined, the replay from the start blames rank 1
   and ends bitwise a run without the fault (over NCCL, a rank a card,
   where the machine has two cards or more: the check captured, the
   majority blaming at detection);
29. elastic_shrink: ``tools/launch.py --local-elastic 2`` runs
   ``tests/torch_elastic_train.py --model gpt2`` (ELASTIC_LAYERS deep,
   ELASTIC_EPOCHS epochs) with rank 1 killed at
   its step-4 guard (``host_dead``): rank 0 publishes the shrink with
   rank 1 dead, the launcher relaunches one worker (``shrinking 2 ->
   1``), which resumes from the newest checkpoint; ``ELASTIC_RECOVERY_S``,
   each process's longest interpreter-lock stall, and the final
   parameters bitwise a one-process ``--replay`` from the same checkpoint
   epoch, started beside the drill;
30. times: each kernel, its plain version and the PyTorch library call
   that computes the same function, at the serving shapes, the
   attention forward and backward in each dtype; the
   Predictor's requests/s and tokens/s; rtc kernels at size (axpy over
   2^26 floats, the block's GELU) and the host cost of one push.

The script's whole time follows, then one JSON object with a record per
kernel; the last line names the device.
"""
import gc
import importlib.util
import hashlib
import json
import math
import os
import queue
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

if __name__ == "__main__" and "PYTHONPYCACHEPREFIX" not in os.environ:
    # bytecode cached in the checkout, for this process and every one it
    # starts: where the interpreter's packages ship no .pyc and cannot
    # hold one, each process would compile torch again (seconds a start)
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".pycache")
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.op.kernels import build
from mxnet_tpu_torch.op.kernels import flash_attention as fa
from mxnet_tpu_torch.rtc import Rtc

# openai-community/gpt2 config.json: n_embd 768, n_head 12, n_layer 12,
# n_positions 1024, vocab_size 50257
GPT2_SMALL = dict(seq_len=1024, num_hidden=768, num_heads=12, num_layers=12,
                  vocab_size=50257)
BATCH = 4
REQUESTS = 3
# the Predictor's timed requests (the REQUESTS batches in turn): the
# steady latency is their median after the first
PREDICTOR_REQUESTS = 20
SEED = 0
# the train phase: Module.fit over TRAIN_EPOCHS passes of TRAIN_BATCHES
# batches (the same batches each epoch), Adam at TRAIN_LR.  Each batch's
# sequences cover token ids no other batch has, so the first pass learns
# little that carries to its next batch; the later passes see again what
# the model learned from
TRAIN_EPOCHS = 3
TRAIN_BATCHES = 4
TRAIN_LR = 3e-4
# the last epoch's perplexity must fall below the first's by this factor
PPL_FALL = 2.0
# the one-step gradient comparison with the port's CPU run: the same
# widths and batch, depth cut to this many blocks on both sides (the CPU
# side's time and memory), every parameter's gradient held by relative
# norm.  float32 on both sides (TF32 off on the card), products and sums
# in another order: ~1e-6 apart, while a wrong gradient is off by 1e-2
CPU_LAYERS = 2
GRAD_REL_TOL = 1e-4
# the fused float32 step against the classic one on the card, from the
# same weights and batches, by relative norm per parameter after the
# first step, and after the second (the first replay of the captured
# step).  The same kernels; Adam's bias correction sqrt(1 - beta2^t) is
# float32 in the fused rule (as in the JAX package's rule) and float64 in
# the classic in-place update, 6.4e-6 apart at t = 1 (1 - 0.999 loses
# digits in float32), so a bias that starts at 0 is that far apart after
# one step and up to twice that after two (the CPU run: 6.7e-6, 9.3e-6)
FUSED_PARAM_TOL = (1e-5, 2e-5)
# one step's float32 master gradients with bfloat16 compute against the
# float32 fused step's, by relative norm per parameter.  The port's CPU
# run at GPT-2 small's widths: 1.3e-2 at worst with 2 blocks, 2.2e-2 with
# 12 (median 1.9e-2; 128 tokens, batch 1).  On the card the port's step
# sums bfloat16 products in float32; with cuBLAS's bfloat16 split sums
# (PyTorch's default) they were 6.3e-2 apart.  A wrong gradient is off by
# order 1
BF16_GRAD_TOL = 5e-2
# the sentinel phase: the LM at GPT-2 small's widths cut to this depth,
# and GPT-2's MLP block with a Dropout as a float-input model
SENTINEL_LAYERS = 2
DROPOUT_P = 0.1
# the ResNet cell: bench.py's _build_module (resnet-50, 1000 classes, NHWC,
# SGD momentum 0.9 at lr 0.1, rescale_grad 1/batch, Xavier gaussian "in"
# magnitude 2), bfloat16 compute, batch 256 of 224 x 224 x 3, on one card
# with the "local" kvstore; one staged batch repeated, RESNET_STEPS steps
RESNET = dict(num_classes=1000, layout="NHWC")
RESNET_INIT = dict(rnd_type="gaussian", factor_type="in", magnitude=2)
RESNET_SGD = {"learning_rate": 0.1, "momentum": 0.9}
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 256, 224, 12
RESNET_BN_MOMENTUM = 0.9          # resnet.get_symbol's BatchNorm momentum
# train_resnet_vs_cpu: one float32 step at a batch the CPU side can take
RESNET_CHECK_BATCH, RESNET_CHECK_IMAGE = 4, 112
# Tolerances, relative norm per array, fixed from the port's CPU run at
# RESNET_CHECK_* from SEED (tools/torch_resnet_tolerances.py).  This
# network's float32 parameter gradients are ill-conditioned at that
# batch: the port's step was a median 4.2e-2 (at most 0.16, bn0_gamma)
# from the JAX package's, while the head's gradients (fc1: 1.2e-4), the
# moving statistics (4.5e-5) and the outputs (7.5e-5) agreed.
# Convolutions rounded to TF32 move those three by the amounts the tool
# prints as tf32_vs_port.  So the card's float32 step is held to
# RESNET_TOL on the head's gradients, the moving statistics and the
# outputs, and to RESNET_GRAD_MEDIAN_TOL / RESNET_GRAD_MAX_TOL on the
# median / largest error of every parameter's gradient
RESNET_TOL = 1e-3
RESNET_GRAD_MEDIAN_TOL, RESNET_GRAD_MAX_TOL = 0.2, 1.0
# The bfloat16 step's float32 gradients against float32 compute's, on the
# CPU: the head's were RESNET_BF16_HEAD_GAP apart; every other
# parameter's a median 1.2 (at most 1.6e3), as in the JAX package's
# Trainer (1.2, at most 1.7e3: its residual stream and BatchNorms in
# bfloat16).  The head is held to 3 times its gap, every gradient to
# being finite
RESNET_BF16_HEAD_GAP = {"fc1_bias": 2.107e-3, "fc1_weight": 0.1705}
RESNET_BF16_HEAD_TOL = {n: 3 * g for n, g in RESNET_BF16_HEAD_GAP.items()}
# train_resnet_records: bench.py's real-data pipelines (bench.py:52-71,
# 165-300): its record file (RECORDS_IMAGES random 256 x 256 JPEGs at
# quality 90 from seed 0, labels i % 1000), the cached pipeline
# (DeviceCacheIter: storage 256^2, 224^2 random crops and mirrors, shuffled,
# seed 7) and the stream pipeline (the loader crops 224^2 on the host,
# DeviceUploadIter depth 2 in 4 chunks, StreamAugmentIter mirrors, seed
# 11), each training the ResNet cell RECORDS_STEPS steps through fit
RECORDS_IMAGES, RECORDS_SIDE, RECORDS_QUALITY = 512, 256, 90
RECORDS_STEPS, RECORDS_TRACED_STEPS = 12, 3
CACHE_SEED, STREAM_SEED = 7, 11
STREAM_DEPTH, STREAM_CHUNKS = 2, 4
# the loader's pixels against Pillow's decode of the same JPEGs (libjpeg,
# which the loader's libjpeg route matches bit for bit).  The nvJPEG route
# differs by its IDCT alone (it upsamples chroma and converts colour as
# libjpeg does): tools/torch_loader_probe.py measured at most 3 and a mean
# of 0.049 on bench.py's file, at most 3 on 4:4:4, 4:2:2 and 4:2:0 files
LOADER_TOL = {"libjpeg": {"max_abs": 0, "mean_abs": 0.0},
              "nvjpeg": {"max_abs": 4, "mean_abs": 0.1}}
# train_lstm_bucketing: examples/rnn/lstm_bucketing.py:27-43 (2 LSTM layers
# of 200, embed 200, batch 32, buckets 10-60, pad and invalid label 0,
# start label 1, SGD lr 0.01 momentum 0 wd 1e-5, a "device" store,
# Perplexity(0), Xavier "in" 2.34) at lstm_lm's default vocabulary, 10,000
# (PTB's), on the example's synthetic_corpus (:55-66) at that vocabulary:
# LSTM_SENTENCES sentences from SEED, LSTM_EPOCHS epochs
LSTM_LM = dict(num_hidden=200, num_embed=200, num_layers=2,
               vocab_size=10000)
LSTM_BUCKETS = [10, 20, 30, 40, 50, 60]
LSTM_BATCH, LSTM_INVALID, LSTM_START = 32, 0, 1
LSTM_SGD = {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-5}
LSTM_INIT = dict(factor_type="in", magnitude=2.34)
LSTM_SENTENCES, LSTM_EPOCHS, LSTM_TRACED_STEPS = 2000, 2, 3
# one float32 forward and backward a bucket, card against the port's CPU
# run from the same weights and batch (TF32 off on the card): outputs and
# every gradient by largest error over the array's largest magnitude.
# Measured on the H100: at most 1.03e-6 (bucket 40's pred_weight
# gradient), the RNN op's 6.9e-7; a wrong gradient is off by order 1
LSTM_CARD_TOL = 1e-5
# the RNN op alone at the cell's widths: T 60, N 32, I = H = 200, 2 layers
RNN_OP_SHAPE = dict(T=60, N=32, I=200, H=200, layers=2)
# train_resume: the fused bfloat16 cell (gpt2_train_cell) at GPT-2 small's
# widths, RESUME_LAYERS deep (the checkpoint is then mostly the 38.6 M
# parameter embedding and head: 1.1 GB, not 1.96 GB), RESUME_EPOCHS
# epochs, a checkpoint every epoch kept two deep, the run killed inside
# its second save (the params write of epoch 2), then restarted with
# resume=True
RESUME_KEEP, RESUME_FAULT = 2, "crash@ckpt_write:save=2"
RESUME_LAYERS, RESUME_EPOCHS = 2, 2
RESUME_CHILD_S = 600
# train_reshape: batch sizes in turn, RESHAPE_STEPS[i] steps at each
RESHAPE_BATCHES, RESHAPE_STEPS = (4, 8, 4), (2, 2, 1)
# train_monitor: monitored steps; the statistics of the card against the
# port's CPU run (GPT-2 small's widths, CPU_LAYERS deep, TF32 off), each
# within MONITOR_TOL of its own magnitude
MONITOR_STEPS, MONITOR_TOL = 2, 1e-4
# module_family: examples/module/python_loss.py (2,000 x 64 prototypes
# of 10 classes, batch 100, 8 epochs, SGD 0.2 momentum 0.9, Xavier) and
# examples/module/mnist_mlp.py's MLP (784-128-64-10 on 2,000 synthetic
# digits, batch 100, 5 epochs, SGD 0.1 momentum 0.9, Xavier) through
# FeedForward.create; the card against the port's CPU run by relative
# norm of each parameter
FAMILY_TOL = 1e-5
# train_zoo: examples/image-classification/common/fit.py's harness on each
# network of the zoo at full width: 1000 classes, NCHW as the builders
# write it, batch 128 (fit.py:81), bfloat16 compute, ZOO_STEPS steps of
# one batch (numpy, from SEED) repeated through Module.fit with a device
# store, a MultiFactorScheduler stepping the lr by 0.1 after ZOO_LR_STEP
# updates (fit.py:30), Xavier("gaussian", "in", 2) (fit.py:136), accuracy
# and top-5 accuracy (fit.py:138-141), and one of the example's
# optimizers each (fit.py:78,133; momentum 0.9 and wd 1e-4, fit.py's
# defaults).  The learning rates are the largest of those tried on the
# card whose loss fell over the run: vgg-16's NAG diverged at 1e-2 and
# resnext-50's SGD rose at fit.py's 0.1 (my chip runs 1-2)
ZOO_CLASSES, ZOO_BATCH, ZOO_STEPS, ZOO_LR_STEP = 1000, 128, 8, 4
ZOO_INIT = dict(rnd_type="gaussian", factor_type="in", magnitude=2)
ZOO = [
    ("alexnet", 224, "sgd",
     {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}),
    ("vgg-16", 224, "nag",
     {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4}),
    ("googlenet", 224, "adagrad", {"learning_rate": 0.01, "wd": 1e-4}),
    ("inception-bn", 224, "rmsprop",
     {"learning_rate": 1e-3, "centered": True, "wd": 1e-4}),
    ("inception-v3", 299, "adadelta", {"wd": 1e-4}),
    ("inception-resnet-v2", 299, "adam", {"learning_rate": 1e-3,
                                          "wd": 1e-4}),
    ("resnext-50", 224, "sgd",
     {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4}),
]
# each network's float32 step (TF32 off, Dropout at p = 0) on the card
# against the port's CPU run at ZOO_CHECK_BATCH, relative norm per array.
# Measured on the H100 (my chip runs 1-2, the same numbers in both): the
# step's output, the classifier's weight gradient and the moving
# statistics at most 4.5e-5 (inception-v3's head); every parameter's
# gradient a median of at most 2.5e-2 (resnext-50, inception-v3: their
# BatchNorms at batch 2 are ill-conditioned, as ResNet-50's at batch 4
# are, RESNET_TOL above; alexnet 9.2e-7), the largest weight gradient's
# 3.6e-2 (inception-v3's mixed0_proj_conv_weight).  A BatchNorm beta
# whose gradient cancels to near 0 is noise (inception-resnet-v2's
# b8_9_up_bn_beta: 1.48) and is printed, not held.  Held: the first
# three to ZOO_TOL, the median and the largest weight gradient to
# ZOO_GRAD_MEDIAN_TOL and ZOO_GRAD_MAX_TOL, each 4-11 times the gap
ZOO_CHECK_BATCH = 2
ZOO_TOL = 5e-4
ZOO_GRAD_MEDIAN_TOL, ZOO_GRAD_MAX_TOL = 0.1, 0.2
# optimizers: every registered optimizer on examples/module/mnist_mlp.py's
# MLP (784-128-64-10, batch 100, fc1's weight at lr_mult 0.5), OPT_STEPS
# classic and OPT_STEPS fused steps with wd, clip and rescale, the card
# against the port's CPU run by relative norm of each parameter (SGLD,
# whose noise the CPU's generator draws otherwise, against a second card
# run from the same seed, bitwise); the five update ops over OPT_OP_SIZE
# elements; SGLD's noise over OPT_OP_SIZE
OPT_STEPS, OPT_BATCH, OPT_OP_SIZE = 3, 100, 1 << 20
OPT_COMMON = {"wd": 1e-3, "clip_gradient": 0.05, "rescale_grad": 1.0 / 100}
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("sgld", {"learning_rate": 0.01}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3}),
    ("adagrad", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 1e-3}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True,
                 "clip_weights": 0.5}),
    ("adadelta", {}),
    ("ftrl", {"learning_rate": 0.1}),
    ("test", {}),
]
OPT_TOL, OPT_OP_TOL = 1e-5, 1e-6
# the bitwise resume: the MLP's fused path with centered RMSProp,
# OPT_RESUME_EPOCHS epochs of 4 batches, a checkpoint each, the run
# crashed (in process) inside its second save
OPT_RESUME_EPOCHS, OPT_RESUME_FAULT = 4, "crash@ckpt_write:save=2:soft"
# train_fcn: FCN-8s (upstream example/fcn-xs: symbol_fcnxs.py's
# get_fcn8s_symbol, fcn_xs.py's training) on VGG-16 at full width, 21
# PASCAL VOC classes, NCHW, batch 1 of 3 x 500 x 500, ignore label 255,
# SGD with momentum 0.99 and wd 5e-4 (fcn_xs.py), Mixed: Bilinear for the
# three Deconvolutions, Xavier (the zoo's) for the rest; FCN_STEPS steps
# of one synthetic batch through Module.fit, float32, and beside it the
# same in bfloat16.  FCN_LR is fcn_xs.py's lr (its loss is summed over
# 250,000 pixels), at which the float32 loss fell over the run, rising on
# the way (measured on an H100, PERF.md).  In bfloat16 no lr from 1e-4 to
# 1e-14 made it fall, in this port or in the JAX package on the CPU
# (tools/torch_fcn_bf16.py): Bilinear fills every channel pair, so the 21
# class maps start equal and only bigscore's weights (up to 0.88) get a
# gradient; their bfloat16 copies move by 2^-8 of themselves, and that
# step already overshoots
FCN_CLASSES, FCN_IMAGE, FCN_STEPS, FCN_IGNORE = 21, 500, 8, 255
FCN_LR = 1e-10
FCN_SGD = {"momentum": 0.99, "wd": 5e-4}
FCN_INIT = dict(rnd_type="gaussian", factor_type="in", magnitude=2)
FCN_BORDER = 12                  # the label's ignored border, in pixels
# beside it one float32 step (TF32 off, Dropout at p = 0) at 1 x 3 x
# FCN_CHECK_IMAGE^2, the card against the port's CPU, relative norms: the
# step's output, the score heads' and bigscore's gradients and every
# weight after the update to FCN_TOL
FCN_CHECK_IMAGE, FCN_TOL = 64, 1e-4
# loss_examples: the six loss-layer examples at their own sizes, each run
# from mt.random.seed(SEED) on the card and on the port's CPU, on Module's
# fused path and on its classic one: each example's own end-of-run assert
# in all four runs, and on each path the largest relative norm between
# the card's and the CPU's parameters to EXAMPLE_PARAM_TOL (measured on an
# H100: at most 2.9e-6 fused, fcn-xs's conv2_weight after 48 Adam steps,
# and 8.3e-7 classic; tools/torch_fused_divergence.py)
EXAMPLE_PARAM_TOL = 1e-5
# serve_server: the JAX package's documented serving cell
# (docs/how_to/serving.md:33-45, tools/serve_bench.py:131-142): buckets,
# the request rows mix (serve_bench's default), ResNet-50's image side,
# the calibration images behind its BatchNorm statistics, and the load:
# ResNet-50 at 0.5x and 2x its single-request capacity, GPT-2 small at
# 0.5x its own at the same time, SERVE_LOAD_S seconds a level
SERVE_BUCKETS = [1, 4, 8, 16, 32]
SERVE_ROWS = (1, 2, 4)
SERVE_IMAGE = 224
SERVE_CALIBRATION = 8
SERVE_RESNET_LOADS = (0.5, 2.0)
SERVE_LM_LOAD = 0.5
SERVE_LOAD_S = 2.0
SERVE_BREAKDOWN_S = 1.5
SERVE_CAPACITY_REQUESTS = {"resnet-50": 200, "gpt2-small": 20}
# what the card may still hold when the phase has dropped its servers
# (the cuBLAS workspaces of the replay and capture streams, 34 MiB each);
# the bucket graphs alone hold 15.7 GB
SERVE_HELD_AFTER_BYTES = 256 << 20
# a served request against its tenant's eager unpadded forward on the
# card, float32 with TF32 off: cuDNN picks its algorithms by batch size,
# so a padded row may round apart from the unpadded one.  Measured once,
# over every bucket full and padded: ResNet-50's probabilities (~1e-3
# each) 6.05e-8 apart at most, 2.06e-5 relative; GPT-2's logits bitwise
# equal (the CPU Predictor's are 6.9e-6 from the card's); a row of
# another request is off by far more than either
SERVE_PAD_TOL = {"resnet-50": dict(rtol=1e-4, atol=1e-8),
                 "gpt2-small": dict(rtol=1e-5, atol=1e-5)}
# H100 SXM peaks (NVIDIA data sheet; dense, at the full 700 W limit):
# device memory, and arithmetic per dtype (float32 on the CUDA cores,
# bfloat16 on the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Kernel vs plain version on the same inputs.  float32: both accumulate in
# float32 in another order, ~1e-6 apart; a wrong mask, tile or scale is
# off by 1e-1 or more.  bfloat16: both round O to bfloat16 (one ulp is
# 2^-8 relative) and the kernel rounds P to bfloat16 before P V as the
# TPU kernel does; lse is float32 from exact bfloat16 products.
KERNEL_TOL = {torch.float32: dict(rtol=1e-4, atol=5e-5),
              torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}
LSE_TOL = dict(rtol=1e-5, atol=1e-4)
# B2 vs its plain version on the same (q, k, v, o, lse, dO).  float32:
# both accumulate seven products in float32 in another order; a gradient
# of magnitude up to ~10 agrees to ~1e-5, while a wrong mask, scale or
# delta is off by 1e-1 or more.  bfloat16: both round q*scale, P and dS to
# bfloat16 at the same places and the outputs to bfloat16 (one ulp is
# 2^-8 relative), but P comes from the card's exp2f and torch's exp, so a
# few P or dS round the other way and an output may land one or two ulps
# apart.
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}
# GPU (kernels, cuBLAS without TF32) vs CPU (plain versions) float32
# logits after 12 blocks: products and sums in another order.  A bfloat16
# computation misses it: rounding the logits alone to bfloat16 breaks it,
# which the serve phase checks.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROB_TOL = dict(rtol=1e-4, atol=1e-9)

# (label, b, t_q, t_kv, h, d, causal), each run in both dtypes; the first
# is the serving shapes.  Where t_q == t_kv, q, k and v are the strided
# views of one fused qkv tensor, as the attention block hands them to the
# kernel: with head_dim 20 a bfloat16 view's head stride is 40 bytes, which
# TMA cannot describe, so the wrapper copies q, k and v once each
CHECKS = [
    ("serving", 4, 1024, 1024, 12, 64, True),
    ("ragged", 3, 300, 451, 5, 64, False),
    ("causal_tq_lt_tkv", 2, 130, 320, 4, 64, True),
    ("causal_tq_gt_tkv", 2, 320, 130, 4, 64, True),
    ("head_dim_128", 2, 512, 512, 4, 128, True),
    ("head_dim_16", 2, 100, 77, 3, 16, False),
    ("head_dim_32", 2, 96, 96, 3, 32, True),
    ("head_dim_40_padded", 2, 65, 65, 2, 40, True),
    ("head_dim_20_padded_copy", 2, 77, 77, 3, 20, True),
    ("t_1_causal", 2, 1, 1, 3, 64, True),
]
DTYPES = (torch.float32, torch.bfloat16)
# inputs the wrapper copies before the launch, by (label, dtype); none
# elsewhere.  K1 reads q, k, v by TMA (bfloat16) or 16-byte cp.async
# (float32); B2-bfloat16 reads k, v and dO by TMA (q and O by element)
COPIES = {("head_dim_20_padded_copy", torch.bfloat16): 3}
B2_COPIES = {("head_dim_20_padded_copy", torch.bfloat16): 3}
# the attention kernel's source and C entry for each dtype
K1_SOURCES = {torch.float32: "flash_attention_fwd_f32",
              torch.bfloat16: "flash_attention_fwd_bf16"}
# the backward's source, C entry and kernel name for each dtype
B2_SOURCES = fa.BWD_NAMES
# each kernel's main device function, by source: what a profiler trace
# names it (the preprocesses flash_bwd_delta_f32 and flash_bwd_prep_bf16
# have other names)
DEVICE_KERNELS = {K1_SOURCES[torch.float32]: "flash_fwd_f32",
                  K1_SOURCES[torch.bfloat16]: "flash_fwd_bf16",
                  B2_SOURCES[torch.float32]: "flash_bwd_f32",
                  B2_SOURCES[torch.bfloat16]: "flash_bwd_bf16"}
# float32 -> integer casts of the JAX package's astype (saturating, NaN
# to 0), as its CPU run gives them for CAST_INPUT
CAST_INPUT = [-1.7, 2.7, 300.0, float("nan"), 3e9, -3e9]
CAST_EXPECTED = {"uint8": [0, 2, 255, 0, 255, 0],
                 "int8": [-1, 2, 127, 0, 127, -128],
                 "int32": [-1, 2, 300, 0, 2147483647, -2147483648]}


# rtc kernel vs its torch-language version on the card: float32
# elementwise bodies, the same operations in the same order, the card's
# libm (sinf, tanhf) against torch's, 1-2 ulp apart; bfloat16 bodies
# compute in float32 and round once, exactly as torch's copy_ rounds
RTC_TOL = {torch.float32: dict(rtol=2e-6, atol=2e-6),
           torch.bfloat16: dict(rtol=0, atol=0)}
# a GPT-2-small block on the card (kernels, cuBLAS without TF32) against
# the same mt.nd calls on the CPU: PR 1's logits tolerance
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
AXPY_N = 1 << 26
# about 1 ms of the SM clock: longer than the host takes to issue any
# call that cuda_ms times
SLEEP_CYCLES = 2_000_000

_IDX = "long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;"
# (name, body) pairs in both languages; the CUDA body of a case with
# launch dims reads them, the others take one thread per output element
AXPY = ("    %s\n    if (i < y_size) y[i] = alpha_[0] * x[i] + 1.0f;" % _IDX,
        "y = alpha_ * x + 1")
AXPY_STRIDED = ("""
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < y_size; i += (long long)gridDim.x * blockDim.x)
        y[i] = alpha_[0] * x[i] + 1.0f;""", "y = alpha_ * x + 1")
SINCOS = ("    %s\n    if (i < s_size) { s[i] = sinf(x[i]); c[i] = cosf(x[i]); }"
          % _IDX, "s = torch.sin(x)\nc = torch.cos(x)")
SCALE2 = ("    %s\n    if (i < y_size) y[i] = x[i] * 2.0f;" % _IDX,
          "y = x * 2.0")
TRANSPOSE = ("""
    long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
    if (r < x_shape[0] && c < x_shape[1])
        y[c * y_shape[1] + r] = x[r * x_shape[1] + c];""", "y = x.t()")
BF16 = ("    %s\n    if (i < y_size) y[i] = __float2bfloat16("
        "__bfloat162float(x[i]) * 2.0f + 1.0f);" % _IDX,
        "y = x.float() * 2.0 + 1.0")
GELU = ("""
    %s
    if (i < y_size) {
        float v = x[i];
        y[i] = 0.5f * v * (1.0f + tanhf(0.7978845608028654f
                                        * (v + 0.044715f * (v * v * v))));
    }""" % _IDX,
        "y = 0.5 * x * (1.0 + torch.tanh(0.7978845608028654"
        " * (x + 0.044715 * (x * x * x))))")

# the same GELU, four elements per thread through 16-byte loads and
# stores: the body, not the launch path, sets what an elementwise rtc
# kernel reaches, and wider accesses keep more bytes in flight per thread
GELU_VEC4 = ("""
    auto g = [](float v) {
        return 0.5f * v * (1.0f + tanhf(0.7978845608028654f
                                        * (v + 0.044715f * (v * v * v))));
    };
    long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    if (i + 3 < y_size) {
        float4 v = reinterpret_cast<const float4*>(x)[i / 4];
        reinterpret_cast<float4*>(y)[i / 4] =
            make_float4(g(v.x), g(v.y), g(v.z), g(v.w));
    } else {
        for (; i < y_size; ++i) y[i] = g(x[i]);
    }""", GELU[1])


def vec4_dims(n):
    """Launch dims of a GELU_VEC4 body over ``n`` elements."""
    return dict(grid_dims=(-(-n // (4 * 256)), 1, 1), block_dims=(256, 1, 1))


def rtc_pair(name, inputs, outputs, bodies):
    """The same kernel in both languages, on the prototypes' device."""
    cuda_body, torch_body = bodies
    return (Rtc(name, inputs, outputs, cuda_body, language="cuda"),
            Rtc(name, inputs, outputs, torch_body, language="torch"))


def elementwise_bound(n_elems, n_arrays, ops_per_elem):
    """Least time (ms) for an elementwise float32 pass, and what bounds
    it: ``n_arrays`` arrays of ``n_elems`` floats read or written once,
    over the memory rate; ``ops_per_elem`` float32 operations per
    element over the CUDA cores' peak."""
    t_bytes = n_arrays * n_elems * 4 / PEAK_BYTES_PER_S
    t_ops = n_elems * ops_per_elem / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _emit(obj):
    print(json.dumps(obj), flush=True)


_T0 = time.perf_counter()


def _phase(name):
    """A phase's header, with the seconds since the script started."""
    print("== %s (%.1f s)" % (name, time.perf_counter() - _T0), flush=True)


def _qkv(b, t_q, t_kv, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if t_q == t_kv:
        qkv = torch.randn(b, t_q, 3, h, d, generator=g, device="cuda")
        qkv = qkv.to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = torch.randn(b, t_q, h, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, t_kv, h, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, t_kv, h, d, generator=g, device="cuda").to(dtype)
    return q, k, v


def attention_bound(b, t_q, t_kv, h, d, causal, dtype, backward=False):
    """Least time (ms) the card could take for one attention forward (or,
    with ``backward``, one backward), and what bounds it.  Forward: each
    of q, k, v read once and o, lse written once, over the memory rate;
    the multiply-adds of the live (unmasked) score entries, Q K^T and
    P V, over the dtype's peak.  Backward: q, k, v, o, dO and lse read
    once and dQ, dK, dV written once; the five products of the live
    entries (Q K^T, dO V^T, P^T dO, dS K, dS^T Q)."""
    live = sum(min(i + 1, t_kv) for i in range(t_q)) if causal \
        else t_q * t_kv
    flops = (10 if backward else 4) * d * live * b * h
    size = torch.empty((), dtype=dtype).element_size()
    per_q, per_kv = (4, 4) if backward else (2, 2)
    nbytes = (per_q * b * t_q + per_kv * b * t_kv) * h * d * size \
        + b * h * t_q * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, warmup=3, iters=20):
    """Median device time of one call (ms), by CUDA events around each.

    Before each call the stream spins for about a millisecond
    (``torch.cuda._sleep``) while the host enqueues the events and the
    call behind it, so the host's time to issue the call (tens of µs for
    an rtc push) does not fall between the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launch_counts():
    """Every kernel's launches since the counts were last set to 0, by
    name: the attention forward (K1) and backward (B2) kernels, and rtc
    pushes."""
    return {**fa.flash_attention_fwd.kernel_launches,
            **fa.flash_attention_bwd.kernel_launches, "rtc": Rtc.launches}


def reset_launch_counts():
    fa.reset_counts()
    Rtc.launches = 0


def expect_launches(path, launches, **nonzero):
    """Raise unless ``launches`` holds exactly ``nonzero`` (by kernel
    name) and 0 for every other kernel."""
    expected = {name: nonzero.get(name, 0) for name in launches}
    if launches != expected or set(nonzero) - set(launches):
        raise AssertionError("%s launched %s, expected %s"
                             % (path, launches, expected))


def environment():
    _phase("environment")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # PyTorch's own setting, left as a user has it: the port's step sums
    # bfloat16 products in float32 by itself (train() asserts it unchanged)
    _emit({"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "bf16_reduced_precision_reduction":
               torch.backends.cuda.matmul
               .allow_bf16_reduced_precision_reduction})
    return card


def ptxas_report(log):
    """{kernel symbol: {"registers": n, "spill_bytes": n}} from the
    ``-Xptxas -v`` lines of an nvcc log."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            report[name] = {"registers": None, "spill_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


def _cuobjdump():
    """The CUDA toolkit's cuobjdump, else the copy in Triton's package."""
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        for root in spec.submodule_search_locations:
            cand.append(os.path.join(root, "backends", "nvidia", "bin",
                                     "cuobjdump"))
    for path in cand:
        if os.access(path, os.X_OK):
            return path
    raise AssertionError("no cuobjdump in %s" % cand)


def sass_counts(library, opcodes=("HGMMA", "UTMALDG", "SYNCS", "FFMA",
                                  "LDGSTS", "MUFU.EX2")):
    """How often each opcode occurs in the SASS of a built library."""
    sass = subprocess.run([_cuobjdump(), "--dump-sass", str(library.path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     sass)
    return {op: sum(1 for o in ops if o == op or o.startswith(op + "."))
            for op in opcodes}


def build_kernels():
    _phase("build")
    t0 = time.perf_counter()
    build.build_all(fa.LIBRARIES)
    build_s = time.perf_counter() - t0
    for lib in fa.LIBRARIES:
        print(lib.build_log, flush=True)
    _emit({"build_s": build_s,
           "nvcc_s": {lib.name: lib.build_seconds for lib in fa.LIBRARIES},
           "ptxas": {lib.name: ptxas_report(lib.build_log)
                     for lib in fa.LIBRARIES}})
    sass = {lib.name: sass_counts(lib) for lib in fa.LIBRARIES}
    _emit({"sass": sass})
    for name in (K1_SOURCES[torch.bfloat16], B2_SOURCES[torch.bfloat16]):
        if not sass[name]["HGMMA"] or not sass[name]["UTMALDG"]:
            raise AssertionError("%s's SASS holds %d HGMMA and %d UTMALDG "
                                 "instructions" % (name, sass[name]["HGMMA"],
                                                   sass[name]["UTMALDG"]))
    # every backward kernel at every head dim it is built for (a library
    # an earlier process built has no log here)
    b2 = {lib.name: ptxas_report(lib.build_log) for lib in fa.LIBRARIES
          if lib.name in B2_SOURCES.values() and lib.build_seconds is not None}
    _emit({"b2_registers": b2})
    spills = {"%s:%s" % (lib, kern): rep["spill_bytes"]
              for lib, kernels in b2.items() for kern, rep in kernels.items()
              if rep["spill_bytes"]}
    if spills or not all(b2.values()):
        raise AssertionError("backward kernels spill %s (report %s)"
                             % (spills, b2))

    version = mt.rtc.nvrtc_version()
    x = mt.nd.ones((3, 4), ctx=mt.gpu())
    a = mt.nd.ones((1,), ctx=mt.gpu())
    y = mt.nd.zeros((3, 4), ctx=mt.gpu())
    args = ("axpy", [("x", x), ("alpha_", a)], [("y", y)], AXPY[0])
    t0 = time.perf_counter()
    cold = Rtc(*args)
    cold_ms = (time.perf_counter() - t0) * 1e3
    cached_runs = []
    for _ in range(20):
        t0 = time.perf_counter()
        cached = Rtc(*args)
        cached_runs.append((time.perf_counter() - t0) * 1e3)
        if cached.compile_ms is not None:
            raise AssertionError("a second construction compiled again")
    cached_ms = statistics.median(cached_runs)
    if cold.compile_ms is None:
        raise AssertionError("the first construction did not compile")
    _emit({"nvrtc": "%d.%d" % version, "arch": mt.rtc.ARCH,
           "rtc_cold_construct_ms": cold_ms,
           "rtc_compile_ms": cold.compile_ms, "rtc_load_ms": cold.load_ms,
           "rtc_cached_construct_ms": cached_ms})
    return {"compile_ms": cold.compile_ms, "load_ms": cold.load_ms,
            "cached_construct_ms": cached_ms, "nvrtc": "%d.%d" % version}


def _push_checked(cuda, plain, ins, outs, refs, tol, **dims):
    """Push ``cuda`` (counting one launch) and ``plain`` on the same
    inputs; returns the largest error."""
    before = Rtc.launches
    cuda.push(ins, outs, **dims)
    if Rtc.launches != before + 1:
        raise AssertionError("rtc %s: %d launches for one push"
                             % (cuda.name, Rtc.launches - before))
    plain.push(ins, refs)
    torch.cuda.synchronize()
    err = 0.0
    for o, r in zip(outs, refs):
        o = o.data if isinstance(o, mt.nd.NDArray) else o
        r = r.data if isinstance(r, mt.nd.NDArray) else r
        err = max(err, (o.float() - r.float()).abs().max().item())
        torch.testing.assert_close(o, r, check_dtype=False, **tol)
    return err


def check_rtc():
    """Each cuda rtc kernel against its torch-language version."""
    _phase("rtc check")
    g = torch.Generator(device="cuda").manual_seed(7)

    def arr(*shape, dtype=torch.float32):
        return mt.nd.NDArray(torch.randn(*shape, generator=g, device="cuda")
                             .to(dtype))

    f32 = RTC_TOL[torch.float32]
    results = {}
    x, a = arr(3, 4), arr(1)
    y, ry = mt.nd.zeros((3, 4), ctx=mt.gpu()), mt.nd.zeros((3, 4),
                                                           ctx=mt.gpu())
    k = rtc_pair("axpy", [("x", x), ("alpha_", a)], [("y", y)], AXPY)
    results["axpy"] = _push_checked(*k, [x, a], [y], [ry], f32)

    x = mt.nd.NDArray(torch.arange(6, dtype=torch.float32, device="cuda"))
    outs = [mt.nd.zeros((6,), ctx=mt.gpu()) for _ in range(4)]
    # not "sincos": the name is the kernel's C symbol, and CUDA's math
    # library has a sincos
    k = rtc_pair("sin_cos", [("x", x)], [("s", outs[0]), ("c", outs[1])],
                 SINCOS)
    results["sincos"] = _push_checked(*k, [x], outs[:2], outs[2:], f32)

    x = mt.nd.NDArray(torch.arange(64, dtype=torch.float32,
                                   device="cuda").reshape(8, 8))
    y, ry = mt.nd.zeros((8, 8), ctx=mt.gpu()), mt.nd.zeros((8, 8),
                                                           ctx=mt.gpu())
    scale2 = rtc_pair("scale2", [("x", x)], [("y", y)], SCALE2)
    results["scale2"] = _push_checked(*scale2, [x], [y], [ry], f32)

    # a push at other shapes compiles a second module, as jax.jit retraces
    x5 = arr(5, 5)
    y5, r5 = mt.nd.zeros((5, 5), ctx=mt.gpu()), mt.nd.zeros((5, 5),
                                                            ctx=mt.gpu())
    results["scale2_new_shape"] = _push_checked(*scale2, [x5], [y5], [r5],
                                                f32)
    if len(scale2[0]._functions) != 2:
        raise AssertionError("a push at new shapes did not compile anew")

    # explicit launch dims: a grid-stride loop over fewer threads than
    # elements, and a 2-D grid that reads the shape constants
    x, a = arr(1000, 37), arr(1)
    y, ry = (mt.nd.zeros((1000, 37), ctx=mt.gpu()) for _ in range(2))
    k = rtc_pair("axpy_strided", [("x", x), ("alpha_", a)], [("y", y)],
                 AXPY_STRIDED)
    results["grid_stride"] = _push_checked(
        *k, [x, a], [y], [ry], f32, grid_dims=(7, 1, 1),
        block_dims=(128, 1, 1))
    x = arr(100, 37)
    y, ry = (mt.nd.zeros((37, 100), ctx=mt.gpu()) for _ in range(2))
    k = rtc_pair("transpose2d", [("x", x)], [("y", y)], TRANSPOSE)
    results["grid_2d"] = _push_checked(*k, [x], [y], [ry], f32,
                                       grid_dims=(3, 7, 1),
                                       block_dims=(16, 16, 1))

    x = arr(33, 65, dtype=torch.bfloat16)
    y, ry = (mt.nd.zeros((33, 65), ctx=mt.gpu(), dtype="bfloat16")
             for _ in range(2))
    k = rtc_pair("affine_bf16", [("x", x)], [("y", y)], BF16)
    results["bfloat16"] = _push_checked(*k, [x], [y], [ry],
                                        RTC_TOL[torch.bfloat16])

    # outputs written through a contiguous temporary: a strided view of
    # a wider array (its other columns untouched), and another dtype
    x = arr(16, 4)
    base = mt.nd.zeros((16, 8), ctx=mt.gpu())
    view = mt.nd.NDArray(base.data[:, 2:6])
    ref = mt.nd.zeros((16, 4), ctx=mt.gpu())
    k = rtc_pair("scale2", [("x", x)], [("y", ref)], SCALE2)
    results["strided_view_output"] = _push_checked(*k, [x], [view], [ref],
                                                   f32)
    if base.data[:, :2].abs().sum().item() or \
            base.data[:, 6:].abs().sum().item():
        raise AssertionError("a strided output view wrote past its columns")
    wide = mt.nd.zeros((16, 4), ctx=mt.gpu(), dtype="float64")
    results["float64_output"] = _push_checked(*k, [x], [wide], [ref], f32)
    _emit({"rtc_check": results})
    return results


def check_casts():
    """Float32 -> integer ``Cast`` and ``astype`` on the card, against
    the JAX package's saturating results (CUDA's conversions are not the
    CPU's)."""
    _phase("casts")
    x = mt.nd.array(np.array(CAST_INPUT, np.float32), ctx=mt.gpu())
    got = {}
    for dtype, want in CAST_EXPECTED.items():
        for how, out in (("Cast", mt.nd.Cast(x, dtype=dtype)),
                         ("astype", x.astype(dtype))):
            if out.data.device.type != "cuda":
                raise AssertionError("%s ran on %s" % (how, out.data.device))
            got["%s %s" % (how, dtype)] = out.asnumpy().tolist()
            if got["%s %s" % (how, dtype)] != want:
                raise AssertionError("%s to %s gave %s, expected %s"
                                     % (how, dtype, got, want))
    _emit({"casts": CAST_INPUT, "results": got})


def imperative_block(ctx, weights, x, gelu):
    """One GPT-2-small block, x + Attn(LN(x)), then x + MLP(LN(x)),
    from ``mt.nd`` calls on ``ctx``'s NDArrays; the GELU is ``gelu``, a
    GELU_VEC4 rtc kernel."""
    nd = mt.nd
    b, t = BATCH, GPT2_SMALL["seq_len"]
    c, h = GPT2_SMALL["num_hidden"], GPT2_SMALL["num_heads"]
    w = weights
    ln1 = nd.LayerNorm(x, w["ln1_gamma"], w["ln1_beta"])
    qkv = nd.FullyConnected(ln1, w["qkv_weight"], w["qkv_bias"],
                            num_hidden=3 * c)
    qkv = nd.Reshape(qkv, shape=(b, t, 3, h, c // h))
    q, k, v = (nd.Reshape(nd.slice_axis(qkv, axis=2, begin=i, end=i + 1),
                          shape=(b, t, h, c // h)) for i in range(3))
    att = nd._contrib_DotProductAttention(q, k, v, causal=True)
    att = nd.Reshape(att, shape=(b * t, c))
    x = x + nd.FullyConnected(att, w["proj_weight"], w["proj_bias"],
                              num_hidden=c)
    ln2 = nd.LayerNorm(x, w["ln2_gamma"], w["ln2_beta"])
    hid = nd.FullyConnected(ln2, w["mlp1_weight"], w["mlp1_bias"],
                            num_hidden=4 * c)
    act = nd.empty(hid.shape, ctx=ctx)
    gelu.push([hid], [act], **vec4_dims(hid.size))
    return x + nd.FullyConnected(act, w["mlp2_weight"], w["mlp2_bias"],
                                 num_hidden=c)


def imperative():
    """The imperative path: the block on the card, each kernel's launches
    counted, held against its CPU run; returns (launches, the host ms of
    one block, the largest error)."""
    _phase("imperative")
    rng = np.random.default_rng(SEED + 1)
    c = GPT2_SMALL["num_hidden"]
    shapes = {"ln1_gamma": (c,), "ln1_beta": (c,), "qkv_weight": (3 * c, c),
              "qkv_bias": (3 * c,), "proj_weight": (c, c), "proj_bias": (c,),
              "ln2_gamma": (c,), "ln2_beta": (c,),
              "mlp1_weight": (4 * c, c), "mlp1_bias": (4 * c,),
              "mlp2_weight": (c, 4 * c), "mlp2_bias": (c,)}
    host = {n: (1.0 + rng.standard_normal(s, dtype=np.float32) * 0.1
                if n.endswith("gamma")
                else rng.standard_normal(s, dtype=np.float32) * 0.02)
            for n, s in shapes.items()}
    x_host = rng.standard_normal((BATCH * GPT2_SMALL["seq_len"], c),
                                 dtype=np.float32)
    runs = {}
    for ctx, language in ((mt.gpu(), "cuda"), (mt.cpu(), "torch")):
        with ctx:
            weights = {n: mt.nd.array(v) for n, v in host.items()}
            x = mt.nd.array(x_host)
            proto = mt.nd.empty((x.shape[0], 4 * c))
            gelu = Rtc("gelu_tanh_vec4", [("x", proto)], [("y", proto)],
                       GELU_VEC4[0] if language == "cuda" else GELU_VEC4[1],
                       language=language)
            if language == "cuda":
                reset_launch_counts()
                out = imperative_block(ctx, weights, x, gelu)
                mt.nd.waitall()
                launches = launch_counts()
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    imperative_block(ctx, weights, x, gelu).wait_to_read()
                    times.append((time.perf_counter() - t0) * 1e3)
            else:
                out = imperative_block(ctx, weights, x, gelu)
            runs[language] = out.asnumpy()
    expect_launches("the imperative block", launches,
                    **{K1_SOURCES[torch.float32]: 1, "rtc": 1})
    gpu, cpu = torch.from_numpy(runs["cuda"]), torch.from_numpy(runs["torch"])
    if gpu.shape != (BATCH * GPT2_SMALL["seq_len"], c) or \
            not torch.isfinite(gpu).all():
        raise AssertionError("imperative block output %s, finite: %s"
                             % (tuple(gpu.shape),
                                bool(torch.isfinite(gpu).all())))
    err = (gpu - cpu).abs().max().item()
    block_ms = statistics.median(times)
    _emit({"imperative": "gpt2-small block", "batch": BATCH,
           "seq_len": GPT2_SMALL["seq_len"], "launches": launches,
           "max_abs_err_vs_cpu": err, "max_abs": cpu.abs().max().item(),
           "block_host_ms": block_ms, "block_host_ms_runs": times})
    torch.testing.assert_close(gpu, cpu, **BLOCK_TOL)
    return launches, block_ms, err


def imperative_bf16():
    """One bfloat16 ``_contrib_DotProductAttention`` call on ``mt.gpu()``
    NDArrays at the serving shapes (the q, k, v of a block, cut from one
    fused projection by ``slice_axis``), recorded by ``mt.autograd`` with
    q, k, v marked, and backpropagated: it launches the bfloat16 forward
    and backward kernels once each.  The output and the gradients are
    held against the plain versions.  Returns the launches."""
    _phase("imperative bfloat16 attention")
    rng = np.random.default_rng(SEED + 2)
    b, t, h = BATCH, GPT2_SMALL["seq_len"], GPT2_SMALL["num_heads"]
    d = GPT2_SMALL["num_hidden"] // h
    qkv = mt.nd.array(rng.standard_normal((b, t, 3, h, d), dtype=np.float32),
                      ctx=mt.gpu(), dtype="bfloat16")
    q, k, v = (mt.nd.Reshape(mt.nd.slice_axis(qkv, axis=2, begin=i,
                                              end=i + 1), shape=(b, t, h, d))
               for i in range(3))
    for x in (q, k, v):
        x.attach_grad()
    mt.nd.waitall()
    reset_launch_counts()
    with mt.autograd.record():
        out = mt.nd._contrib_DotProductAttention(q, k, v, causal=True)
    out.backward()
    mt.nd.waitall()
    launches = launch_counts()
    copies = fa.flash_attention_fwd.padded_copies + fa.flash_attention_bwd.copies
    expect_launches("the bfloat16 attention call", launches,
                    **{K1_SOURCES[torch.bfloat16]: 1,
                       B2_SOURCES[torch.bfloat16]: 1})
    if copies:
        raise AssertionError("the bfloat16 attention call copied %d inputs"
                             % copies)
    if out.dtype != torch.bfloat16 or out.shape != (b, t, h, d):
        raise AssertionError("bfloat16 attention gave %s %s"
                             % (out.dtype, out.shape))
    with torch.no_grad():
        ref, lse = fa.attention_reference(q.data, k.data, v.data,
                                          causal=True)
        # the backward's plain version on the kernel's own output (a
        # missing head gradient is ones)
        refs = fa.attention_bwd_reference(q.data, k.data, v.data, out.data,
                                          lse, torch.ones_like(out.data),
                                          causal=True)
    grads = [x.grad.data for x in (q, k, v)]
    err = (out.data.float() - ref.float()).abs().max().item()
    grad_err = [(g.float() - r.float()).abs().max().item()
                for g, r in zip(grads, refs)]
    _emit({"imperative_bf16": "_contrib_DotProductAttention + backward",
           "shape": [b, t, t, h, d], "launches": launches,
           "max_abs_err": err,
           "grad_max_abs_err": dict(zip(("dq", "dk", "dv"), grad_err)),
           "grad_max_abs": max(r.float().abs().max().item() for r in refs)})
    torch.testing.assert_close(out.data.float(), ref.float(),
                               **KERNEL_TOL[torch.bfloat16])
    for g, r in zip(grads, refs):
        if g.dtype != torch.bfloat16:
            raise AssertionError("a bfloat16 gradient came back %s" % g.dtype)
        torch.testing.assert_close(g.float(), r.float(),
                                   **BWD_TOL[torch.bfloat16])
    return launches, max(grad_err)


def check_backward(label, q, k, v, o, lse, causal, seed):
    """Hold B2 against its plain version on the same (q, k, v, o, lse,
    dO); returns the largest error over dQ, dK, dV."""
    dtype = q.dtype
    g = torch.Generator(device="cuda").manual_seed(1000 + seed)
    do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
    fa.reset_counts()
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    counts = dict(fa.flash_attention_bwd.kernel_launches)
    copies = fa.flash_attention_bwd.copies
    refs = fa.attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    errs = [(x.float() - r.float()).abs().max().item()
            for x, r in zip(grads, refs)]
    _emit({"check_bwd": label, "shape": [q.shape[0], q.shape[1], k.shape[1],
                                         q.shape[2], q.shape[3]],
           "causal": causal, "dtype": str(dtype), "kernel": B2_SOURCES[dtype],
           "copies": copies, "max_abs_err": dict(zip(("dq", "dk", "dv"), errs)),
           "max_abs": max(r.float().abs().max().item() for r in refs)})
    if counts[B2_SOURCES[dtype]] != 1 or sum(counts.values()) != 1:
        raise AssertionError("%s %s backward launched %s"
                             % (label, dtype, counts))
    if copies != B2_COPIES.get((label, dtype), 0):
        raise AssertionError("%s %s: the backward copied %d inputs, expected "
                             "%d" % (label, dtype, copies,
                                     B2_COPIES.get((label, dtype), 0)))
    for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
        if x.dtype != dtype or x.shape != r.shape:
            raise AssertionError("%s %s: %s is %s %s" % (
                label, dtype, name, x.dtype, tuple(x.shape)))
        torch.testing.assert_close(x.float(), r.float(), **BWD_TOL[dtype])
    return max(errs)


def check_autograd(label, q, k, v, causal, seed):
    """Gradients through ``FlashAttention`` (K1 then B2) against torch
    autograd of the plain forward, float32; returns the largest error."""
    g = torch.Generator(device="cuda").manual_seed(2000 + seed)
    do = torch.randn(q.shape, generator=g, device="cuda")
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    plain = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fa.reset_counts()
    fa.flash_attention(*leaves, causal, None).backward(do)
    launches = (dict(fa.flash_attention_fwd.kernel_launches),
                dict(fa.flash_attention_bwd.kernel_launches))
    fa.attention_reference(*plain, causal=causal)[0].backward(do)
    torch.cuda.synchronize()
    if launches[0][K1_SOURCES[torch.float32]] != 1 or \
            launches[1][B2_SOURCES[torch.float32]] != 1:
        raise AssertionError("FlashAttention %s launched %s" % (label,
                                                                launches))
    errs = [(x.grad - y.grad).abs().max().item()
            for x, y in zip(leaves, plain)]
    _emit({"check_autograd": label, "dtype": "torch.float32",
           "max_abs_err": dict(zip(("dq", "dk", "dv"), errs))})
    for x, y in zip(leaves, plain):
        torch.testing.assert_close(x.grad, y.grad,
                                   **BWD_TOL[torch.float32])
    return max(errs)


def check_kernels():
    """Hold each attention kernel, forward (K1) and backward (B2), against
    its plain version; returns the largest errors at the serving shapes,
    ``({dtype: O error}, {dtype: gradient error})``."""
    _phase("kernel check")
    serving_err, serving_bwd_err = {}, {}
    for i, (label, b, t_q, t_kv, h, d, causal) in enumerate(CHECKS):
        for dtype in DTYPES:
            q, k, v = _qkv(b, t_q, t_kv, h, d, dtype, seed=i)
            name, _ = fa.kernel_route(q, k, v)
            fa.reset_counts()
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            counts = dict(fa.flash_attention_fwd.kernel_launches)
            copies = fa.flash_attention_fwd.padded_copies
            ro, rlse = fa.attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            _emit({"check": label, "shape": [b, t_q, t_kv, h, d],
                   "causal": causal, "dtype": str(dtype), "kernel": name,
                   "padded_copies": copies, "max_abs_err": err,
                   "lse_max_abs_err": lse_err})
            if name != K1_SOURCES[dtype] or counts[name] != 1 or \
                    sum(counts.values()) != 1:
                raise AssertionError("%s %s launched %s" % (label, dtype,
                                                            counts))
            if copies != COPIES.get((label, dtype), 0):
                raise AssertionError("%s %s: the wrapper copied %d inputs, "
                                     "expected %d" % (
                                         label, dtype, copies,
                                         COPIES.get((label, dtype), 0)))
            torch.testing.assert_close(o.float(), ro.float(),
                                       **KERNEL_TOL[dtype])
            torch.testing.assert_close(lse, rlse, **LSE_TOL)
            bwd_err = check_backward(label, q, k, v, o, lse, causal, i)
            if dtype == torch.float32:
                check_autograd(label, q, k, v, causal, i)
            if label == "serving":
                serving_err[dtype] = err
                serving_bwd_err[dtype] = bwd_err
    return serving_err, serving_bwd_err


def check_determinism():
    """B2 launched twice on the same inputs at the serving shapes, in each
    dtype: bitwise the same dQ, dK and dV (no float atomics, no order of
    sums that changes between launches)."""
    _phase("determinism")
    label, b, t_q, t_kv, h, d, causal = CHECKS[0]
    for dtype in DTYPES:
        q, k, v = _qkv(b, t_q, t_kv, h, d, dtype, seed=200)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        g = torch.Generator(device="cuda").manual_seed(201)
        do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
        fa.reset_counts()
        first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        second = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        launches = fa.flash_attention_bwd.kernel_launches[B2_SOURCES[dtype]]
        same = [torch.equal(x, y) for x, y in zip(first, second)]
        _emit({"determinism": label, "dtype": str(dtype),
               "kernel": B2_SOURCES[dtype], "launches": launches,
               "bitwise_equal": dict(zip(("dq", "dk", "dv"), same))})
        if launches != 2 or not all(same):
            raise AssertionError("%s backward launched %d times, bitwise "
                                 "equal: %s" % (dtype, launches, same))


def _random_params(symbol, shapes, rng):
    """GPT-2's initialisation scale: N(0, 0.02) weights, embeddings and
    biases; LayerNorm gamma 1 and beta 0."""
    params = {}
    for name, shape in zip(symbol.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            arr = np.ones(shape, np.float32)
        elif name.endswith("_beta"):
            arr = np.zeros(shape, np.float32)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * 0.02
        params[name] = torch.from_numpy(arr)
    return params


def resnet_params_and_batch(symbol, batch, image):
    """Random ResNet weights and one batch, all numpy from SEED: He-normal
    convolution and FullyConnected weights (fan-in from the HWIO or
    (out, in) shape), BatchNorm gamma 1 and beta 0, moving statistics 0
    and 1, and N(0, 1) images with float32 labels in [0, classes).
    Returns (params, aux states, images, labels)."""
    rng = np.random.default_rng(SEED)
    shape = (batch, image, image, 3)
    args, _, auxs = symbol.infer_shape(data=shape, softmax_label=(batch,))
    arg = {}
    for n, s in zip(symbol.list_arguments(), args):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            arg[n] = np.ones(s, np.float32)
        elif n.endswith(("_beta", "_bias")):
            arg[n] = np.zeros(s, np.float32)
        else:
            fan_in = np.prod(s[:-1]) if len(s) == 4 else s[1]
            arg[n] = (rng.standard_normal(s, dtype=np.float32)
                      * np.sqrt(2.0 / fan_in)).astype(np.float32)
    aux = {n: (np.ones(s, np.float32) if n.endswith("_var")
               else np.zeros(s, np.float32))
           for n, s in zip(symbol.list_auxiliary_states(), auxs)}
    x = rng.standard_normal(shape, dtype=np.float32)
    y = rng.integers(0, RESNET["num_classes"], batch).astype(np.float32)
    return arg, aux, x, y


def gpt2_small():
    """The served cell: the LM symbol at GPT-2 small's widths, its
    checkpoint (random weights from SEED) written in the reference format
    and loaded onto the card by ``Predictor.from_checkpoint``, and
    REQUESTS batches of token ids.  Returns (symbol, predictor, params
    blob, load seconds, requests)."""
    rng = np.random.default_rng(SEED)
    symbol = mt.models.transformer.get_symbol(**GPT2_SMALL)
    t, vocab = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    shapes, _, _ = symbol.infer_shape(data=(BATCH, t),
                                      softmax_label=(BATCH, t))
    params = _random_params(symbol, shapes, rng)
    requests = [rng.integers(0, vocab, (BATCH, t)) for _ in range(REQUESTS)]
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gpt2-small")
        symbol.save(prefix + "-symbol.json")
        mt.nd.save(prefix + "-0000.params",
                   {"arg:" + k: v for k, v in params.items()})
        del params
        t0 = time.perf_counter()
        pred = mt.Predictor.from_checkpoint(prefix, 0, {"data": (BATCH, t)})
        load_s = time.perf_counter() - t0
        with open(prefix + "-0000.params", "rb") as f:
            blob = f.read()
    if pred.device.type != "cuda":
        raise AssertionError("Predictor chose %s, not the card" % pred.device)
    return symbol, pred, blob, load_s, requests


def traced_launches(fn):
    """Run ``fn`` (work that replays CUDA graphs) under ``torch.profiler``;
    returns the attention kernels' launches in the trace by source name,
    counted by device kernel name (a wrapper counts a captured launch
    once, at capture, and never on a replay), and asserts that the
    wrappers counted nothing."""
    before = launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if launch_counts() != before:
        raise AssertionError("a traced replay launched through a wrapper: "
                             "%s then %s" % (before, launch_counts()))
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler recorded no device kernel")
    return {src: sum(e.count for e in events if kern in e.key)
            for src, kern in DEVICE_KERNELS.items()}


def serve():
    """Serve PREDICTOR_REQUESTS requests (the REQUESTS batches in turn)
    through the Predictor on the card, each a replay of the forward it
    captured at construction; returns the kernel launch counts (the
    construction's eager warm-up and capture), the request latencies (s)
    and a replayed request's launches."""
    _phase("serve")
    reset_launch_counts()
    symbol, pred, blob, load_s, requests = gpt2_small()
    t, vocab = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    layers = GPT2_SMALL["num_layers"]
    k1 = K1_SOURCES[torch.float32]

    latencies, mallocs, first = [], [], None
    for i in range(PREDICTOR_REQUESTS):
        torch.cuda.synchronize()
        segments = torch.cuda.memory_stats()["segment.all.allocated"]
        t0 = time.perf_counter()
        (probs,) = pred.predict(data=requests[i % REQUESTS])
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        # the device blocks the request took from the driver (its output
        # copy's, when the allocator held none free of its size)
        mallocs.append(torch.cuda.memory_stats()["segment.all.allocated"]
                       - segments)
        if probs.shape != (BATCH * t, vocab) or probs.device.type != "cuda":
            raise AssertionError("output %s on %s" % (tuple(probs.shape),
                                                      probs.device))
        if not torch.isfinite(probs).all():
            raise AssertionError("non-finite probabilities")
        torch.testing.assert_close(probs.sum(-1),
                                   torch.ones_like(probs[:, 0]),
                                   rtol=0, atol=1e-4)
        first = probs if first is None else first
    launches = launch_counts()
    # counted at construction: the eager warm-up and the capture
    expect_launches("serving", launches, **{k1: 2 * layers})
    # one more request, untimed, traced
    traced = traced_launches(lambda: pred.predict(data=requests[0]))
    expect_launches("a replayed request", traced, **{k1: layers})
    if pred._cf.counts()["graph_replays"] != PREDICTOR_REQUESTS + 1:
        raise AssertionError("the requests were not replays: %s"
                             % pred._cf.counts())
    _emit({"serve": "gpt2-small", "batch": BATCH, "seq_len": t,
           "requests": PREDICTOR_REQUESTS, "load_s": load_s,
           "latency_s": latencies, "device_mallocs": mallocs,
           "launches": launches,
           "replayed_request_launches": traced,
           "graph": pred._cf.counts()})

    # logits, not near-uniform probabilities, carry the comparison
    head = symbol.get_internals()["head_output"].tojson()
    gpu = mt.Predictor(head, blob, {"data": (BATCH, t)}) \
        .predict(data=requests[0])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = mt.Predictor(head, blob, {"data": (BATCH, t)}, dev_type="cpu") \
        .predict(data=requests[0])[0]
    cpu_s = time.perf_counter() - t0
    gpu = gpu.cpu()
    _emit({"logits_max_abs_err": (gpu - cpu).abs().max().item(),
           "logits_max_abs": cpu.abs().max().item(),
           "bf16_rounding_max_abs_err":
               (cpu.bfloat16().float() - cpu).abs().max().item(),
           "cpu_reference_s": cpu_s})
    torch.testing.assert_close(gpu, cpu, **LOGIT_TOL)
    if torch.allclose(cpu.bfloat16().float(), cpu, **LOGIT_TOL):
        raise AssertionError("the logit tolerance would pass bfloat16")
    torch.testing.assert_close(first.cpu(), torch.softmax(cpu, dim=-1),
                               **PROB_TOL)
    del pred, gpu, first, probs
    release_serving()
    return launches, latencies, traced


def release_serving():
    """Free what the dropped Predictors and servers held (their CUDA
    graphs, and the memory pool once no graph is left in it) before the
    next phase measures its own peak."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# serve_server: ResNet-50 and GPT-2 small behind one ModelServer
def lm_tenant():
    """GPT-2 small's logits, served batch-major: ``Reshape(head_output,
    (-1, 1024, 50257))`` of the LM symbol, its weights those of
    ``gpt2_small`` (N(0, 0.02) from SEED) on the card.  Returns (symbol,
    weights)."""
    rng = np.random.default_rng(SEED)
    lm = mt.models.transformer.get_symbol(**GPT2_SMALL)
    t, vocab = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    shapes, _, _ = lm.infer_shape(data=(BATCH, t), softmax_label=(BATCH, t))
    params = {k: v.cuda() for k, v in _random_params(lm, shapes, rng).items()}
    head = mt.sym.Reshape(lm.get_internals()["head_output"],
                          shape=(-1, t, vocab))
    return head, params


def resnet_tenant():
    """``models.get_symbol("resnet-50", num_classes=1000,
    layout="NHWC")`` with ``resnet_params_and_batch``'s random weights,
    and BatchNorm moving statistics that are the batch statistics of
    SERVE_CALIBRATION N(0, 1) images (a training forward on the card,
    each BatchNorm's update solved for the batch's statistic): aux
    states as a trained model holds them, far from 0 and 1, with a
    softmax that is not saturated, so a path that normalised by the
    served batch's own statistics would show.  Returns (symbol, weights,
    aux states), on the card."""
    symbol = mt.models.get_symbol("resnet-50", **RESNET)
    arg, aux, calib, _ = resnet_params_and_batch(
        symbol, SERVE_CALIBRATION, SERVE_IMAGE)
    arg = {k: torch.from_numpy(v).cuda() for k, v in arg.items()}
    old = {k: torch.from_numpy(v).cuda() for k, v in aux.items()}
    prog = mt.executor._GraphProgram(symbol)
    feed = {"data": torch.from_numpy(calib).cuda(),
            "softmax_label": torch.zeros(SERVE_CALIBRATION, device="cuda")}
    with torch.no_grad():
        _, new = prog._eval([feed[n] if n in feed else arg[n]
                             for n in prog.arg_names],
                            [old[n] for n in prog.aux_names],
                            torch.device("cuda"), is_train=True)
    m = RESNET_BN_MOMENTUM
    stats = {n: (v - m * old[n]) / (1 - m)
             for n, v in zip(prog.aux_names, new)}
    return symbol, arg, stats


def serve_tenants():
    """name -> (symbol, weights, aux states, per-example shape, a maker
    of ``n`` request rows from a numpy Generator)."""
    rsym, rarg, raux = resnet_tenant()
    lsym, larg = lm_tenant()
    t, vocab = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    image = (SERVE_IMAGE, SERVE_IMAGE, 3)
    return {
        "resnet-50": (rsym, rarg, raux, image, lambda r, n: torch.from_numpy(
            r.standard_normal((n,) + image, dtype=np.float32))),
        "gpt2-small": (lsym, larg, {}, (t,), lambda r, n: torch.from_numpy(
            r.integers(0, vocab, (n, t)))),
    }


def make_server(tenants, **kw):
    """The cell's server: SERVE_BUCKETS, a 2 ms window, on gpu(0)."""
    srv = mt.serving.ModelServer(buckets=SERVE_BUCKETS, max_wait_us=2000,
                                 ctx=mt.gpu(0), **kw)
    for name, (sym, arg, aux, example, _) in tenants.items():
        srv.add_model(name, sym, arg, aux, input_shapes={"data": example})
    return srv


class uncounted:
    """Kernel launches inside the block do not count: the launch counts
    are put back as they were (a reference forward beside a path)."""

    def __enter__(self):
        fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
        self.saved = (fwd.launches, dict(fwd.kernel_launches),
                      dict(bwd.kernel_launches), Rtc.launches)
        return self

    def __exit__(self, *exc):
        fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
        (fwd.launches, fwd.kernel_launches, bwd.kernel_launches,
         Rtc.launches) = self.saved
        return False


def burst_rows(bucket, padded):
    """Request rows from SERVE_ROWS, in turn, that fill ``bucket``
    exactly or (``padded``) leave it part-filled, above the bucket below
    it."""
    below = max([b for b in SERVE_BUCKETS if b < bucket], default=0)
    total = bucket if not padded else max(below + 1, bucket - 1 - bucket // 4)
    rows, i = [], 0
    while sum(rows) < total:
        r = SERVE_ROWS[i % len(SERVE_ROWS)]
        rows.append(min(r, total - sum(rows)))
        i += 1
    return rows


def started(srv):
    """``srv.start()`` timed, with the device memory it took: allocated
    (live tensors, the graphs' static outputs among them) and reserved
    (the allocator's and the graph pools' blocks, where the buckets'
    intermediates live), at the peak and held after."""
    cuda = torch.cuda
    cuda.synchronize()
    cuda.empty_cache()
    base = (cuda.memory_allocated(), cuda.memory_reserved())
    cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    # the warm-ups' cached blocks go back; the graphs' pools stay
    cuda.empty_cache()
    return {"start_s": start_s,
            "peak_allocated_bytes": cuda.max_memory_allocated() - base[0],
            "held_allocated_bytes": cuda.memory_allocated() - base[0],
            "peak_reserved_bytes": cuda.max_memory_reserved() - base[1],
            "held_reserved_bytes": cuda.memory_reserved() - base[1]}


class ClientDuringStart:
    """A client thread beside ``start()``: it submits (refused, "server
    not started", until start() returns) and runs CUDA work of its own
    (allocations, kernels, a synchronising read) while start() captures
    on the calling thread, which the captures' ``thread_local`` error
    mode lets it do.  ``refused`` and ``cuda_ops`` count what it did;
    ``error`` is whatever else it met."""

    def __init__(self, srv, model, request):
        self.refused = self.cuda_ops = 0
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(srv, model, request),
            name="client-during-start")

    def _run(self, srv, model, request):
        try:
            while not self._stop.is_set():
                try:
                    srv.submit({"data": request}, model=model).cancel()
                except mt.MXNetError as err:
                    if "not started" not in str(err):
                        raise
                    self.refused += 1
                x = torch.ones(1 << 16, device="cuda")
                self.cuda_ops += int((x * 2).sum().item() == 2 << 16)
                time.sleep(0.002)
        except Exception as err:        # noqa: BLE001 - reported, checked
            self.error = err

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def check_rows(name, got, ref, tol):
    """A request's host result against its reference forward (on the
    card); returns the largest absolute and relative gaps."""
    got = got.to("cuda", non_blocking=True)
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError("%s: %s %s, expected %s %s" % (
            name, tuple(got.shape), got.dtype, tuple(ref.shape), ref.dtype))
    gap = (got - ref).abs()
    torch.testing.assert_close(got, ref, **tol, msg=lambda m: name + ": " + m)
    return gap.max().item(), (gap / ref.abs().clamp_min(1e-30)).max().item()


def parity_burst(srv, tenants, cfs):
    """Per tenant and bucket, a burst that fills the bucket and (above
    bucket 1) one that leaves it padded, rows from SERVE_ROWS; every
    request held against its tenant's eager unpadded forward on the card
    (SERVE_PAD_TOL).  Returns the gaps by tenant and the burst's host
    copy of GPT-2's bucket-32 logits (bytes, seconds)."""
    rng = np.random.default_rng(SEED + 3)
    gaps = {}
    for name, (_, arg, aux, _, make) in tenants.items():
        worst = [0.0, 0.0]
        for bucket in SERVE_BUCKETS:
            for padded in ((False, True) if bucket > 1 else (False,)):
                a, r = burst_gaps(srv, name, cfs[name], arg, aux, [
                    make(rng, n) for n in burst_rows(bucket, padded)])
                worst = [max(worst[0], a), max(worst[1], r)]
        gaps[name] = {"max_abs": worst[0], "max_rel": worst[1]}
    return gaps


def burst_gaps(srv, name, cf, arg, aux, reqs):
    """One burst of ``reqs`` to tenant ``name``, each result held against
    its eager unpadded forward (``cf``); returns the largest gaps.  The
    results die with the call, so the next burst finds their pinned
    block free."""
    futs = [srv.submit({"data": x}, model=name) for x in reqs]
    m = srv._models[name]
    worst = [0.0, 0.0]
    for x, f in zip(reqs, futs):
        feed = {"data": x.to("cuda", m.input_dtypes["data"])}
        feed.update({n: torch.zeros((len(x),) + t, device="cuda")
                     for n, t in m.label_trailing.items()})
        with uncounted():
            (ref,) = cf.run(arg, aux, feed)
        a, r = check_rows("%s b%d" % (name, srv._bucket_for(
            sum(len(q) for q in reqs))), f.result(120)[0], ref,
            SERVE_PAD_TOL[name])
        worst = [max(worst[0], a), max(worst[1], r)]
    return worst


def logits_copy_rate(srv):
    """Eight rows of GPT-2's bucket-32 graph output (8 x 1024 x 50257
    float32) copied to the host, into pinned memory (the server's
    copy-out) and into pageable memory: (bytes, pinned s, pageable s)."""
    graphs = srv._models["gpt2-small"].graphs
    out = next(e.outputs[0] for k, e in graphs.items()
               if dict((n, s) for n, s, _ in k[0][1:])["data"][0] == 32)[:8]
    pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    rates = []
    for dst in (pinned, torch.empty(out.shape, dtype=out.dtype)):
        dst.copy_(out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(out, non_blocking=dst.is_pinned())
        torch.cuda.synchronize()
        rates.append(time.perf_counter() - t0)
    del pinned
    return out.numel() * out.element_size(), rates[0], rates[1]


def replay_ms(srv):
    """Device ms of one replay of each (tenant, bucket) graph."""
    out = {}
    for name, m in srv._models.items():
        for key, entry in m.graphs.items():
            b = dict((n, s) for n, s, _ in key[0][1:])["data"][0]
            out["%s/b%d" % (name, b)] = cuda_ms(entry.graph.replay,
                                                warmup=1, iters=5)
    return out


def params_blob(arg, aux):
    """A ``.params`` file's bytes (``arg:``/``aux:`` names)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.params")
        blob = {"arg:" + k: v for k, v in arg.items()}
        blob.update({"aux:" + k: v for k, v in aux.items()})
        mt.nd.save(path, blob)
        with open(path, "rb") as f:
            return f.read()


def capacity(tenants, blobs):
    """Each tenant's single-request rate through a Predictor on the
    card (1-row requests, each read back to the host): serve_bench's
    capacity."""
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for name, (sym, _, _, example, make) in tenants.items():
        pred = mt.Predictor(sym.tojson(), blobs[name],
                            {"data": (1,) + example})
        out[name] = single_request_rate(pred, make(rng, 1),
                                        SERVE_CAPACITY_REQUESTS[name])
        del pred
    return out


def payload_pool(make, rng, count, distinct=16):
    """``count`` request payloads, rows from SERVE_ROWS, drawn from
    ``distinct`` made payloads per row count (contents do not move a
    load's time; making thousands of ResNet images would)."""
    pool = {n: [make(rng, n) for _ in range(distinct)] for n in SERVE_ROWS}
    rows = rng.choice(SERVE_ROWS, size=count)
    return [pool[int(n)][i % distinct] for i, n in enumerate(rows)]


def pinned_host_bytes():
    """The caching host allocator's pinned memory, in use and held, now
    and at its peak (``torch.cuda.host_memory_stats``)."""
    stats = torch.cuda.host_memory_stats()
    return {k: v for k, v in stats.items()
            if "bytes" in k and k.split(".")[-1] in ("current", "peak")}


def load_level(srv, tenants, rates, seconds, seed):
    """Both tenants' open loops at once, ``rates`` requests/s each, for
    about ``seconds``; returns the level's record by tenant."""
    rng = np.random.default_rng(seed)
    runs, threads = {}, []
    before = srv.stats()
    torch.cuda.reset_peak_memory_stats()
    for i, (name, rate) in enumerate(sorted(rates.items())):
        payloads = payload_pool(tenants[name][4], rng,
                                max(8, int(rate * seconds)))

        def drive(name=name, payloads=payloads, rate=rate, i=i):
            runs[name] = open_loop(srv, payloads, rate, name, seed=seed + i)

        threads.append(threading.Thread(target=drive, name="load-" + name))
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    after = srv.stats()
    real = after["rows_real"] - before["rows_real"]
    padded = after["rows_padded"] - before["rows_padded"]
    occ = {b: v["batches"] - before["occupancy"].get(b, {}).get("batches", 0)
           for b, v in after["occupancy"].items()}
    level = {"runs": runs, "padding_frac": 1.0 - real / padded,
             "batches_by_bucket": occ,
             "latency_ms_by_bucket": {
                 n: after["per_model"][n]["latency_ms_by_bucket"]
                 for n in rates},
             "retraces": after["retraces"],
             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
             "pinned_host": pinned_host_bytes()}
    for name, run in runs.items():
        if not settled(run):
            raise AssertionError("%s: futures did not settle: %s"
                                 % (name, run))
    if after["retraces"]:
        raise AssertionError("the load retraced: %s" % after["retraces"])
    return level


def where_time_goes(srv, tenants, rates, seconds):
    """A load window (both tenants, ``rates``) under the span recorder
    and ``torch.profiler``: each (tenant, bucket)'s batches by segment
    (``serve.pad``: host assembly; ``serve.dispatch``: enqueueing the
    copy-in, the replay and the copy-out; ``serve.execute``: waiting for
    the card; ``serve.slice``: settling the futures), mean ms, and the
    card's busy time by kind (kernels, copies) and idle share."""
    with mt.obs.scoped() as rec, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        load_level(srv, tenants, rates, seconds, SEED + 30)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = rec.finished()
    by_sid = {sp.sid: sp for sp in spans}
    seg = {}
    for sp in spans:
        parent = by_sid.get(sp.parent)
        if parent is None or parent.name != "serve.batch":
            continue
        key = "%s/b%d" % (parent.attrs["model"], parent.attrs["padded"])
        seg.setdefault(key, {}).setdefault(sp.name, []).append(
            sp.duration_s * 1e3)
    batches = {k: {n: statistics.mean(v) for n, v in d.items()}
               for k, d in sorted(seg.items())}
    for k, d in batches.items():
        d["batches"] = len(seg[k]["serve.execute"])
    busy = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            kind = "copies" if e.key.startswith("Memcpy") else "kernels"
            busy[kind] = busy.get(kind, 0.0) \
                + e.self_device_time_total / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - sum(busy.values()) / wall,
            "batch_segments_ms": batches}


def fault_drills(srv, tenants):
    """A poisoned request fails alone; five injected batch errors open
    ResNet-50's breaker while GPT-2 keeps serving; stop(drain_s=2) serves
    the queue.  Returns what each drill saw."""
    rng = np.random.default_rng(SEED + 7)
    rmake, lmake = tenants["resnet-50"][4], tenants["gpt2-small"][4]
    out = {}
    with mt.faults.injected("poison_request@request=%d" % (srv._rid + 2)):
        futs = [srv.submit({"data": rmake(rng, 1)}, model="resnet-50")
                for _ in range(3)]
        excs = [f.exception(60) for f in futs]
    if not (excs[0] is None and excs[2] is None
            and isinstance(excs[1], mt.serving.ServeError)):
        raise AssertionError("poison drill: %s" % excs)
    out["poison"] = [None if e is None else type(e).__name__ for e in excs]
    with mt.faults.injected("batch_error@model=resnet-50:count=5"):
        excs = [srv.submit({"data": rmake(rng, 1)}, model="resnet-50")
                .exception(60) for _ in range(5)]
    state = srv.stats()["per_model"]["resnet-50"]["breaker_state"]
    try:
        srv.submit({"data": rmake(rng, 1)}, model="resnet-50")
        refused = False
    except mt.serving.ServeUnavailable:
        refused = True
    lm = srv.submit({"data": lmake(rng, 2)}, model="gpt2-small").exception(60)
    if state != "open" or not refused or lm is not None or not all(
            isinstance(e, mt.serving.ServeError) for e in excs):
        raise AssertionError("breaker drill: %s %s %s %s"
                             % (state, refused, lm, excs))
    out["breaker"] = {"state": state, "refused": refused,
                      "gpt2_small_served": True}
    time.sleep(srv.breaker_cooldown_s + 0.1)
    futs = [srv.submit({"data": rmake(rng, n)}, model="resnet-50")
            for n in SERVE_ROWS]
    futs += [srv.submit({"data": lmake(rng, n)}, model="gpt2-small")
             for n in SERVE_ROWS]
    t0 = time.perf_counter()
    srv.stop(drain_s=2)
    out["drain"] = {"s": time.perf_counter() - t0,
                    "served": sum(f.exception(0) is None for f in futs),
                    "requests": len(futs)}
    if out["drain"]["served"] != len(futs):
        raise AssertionError("drain drill: %s" % out["drain"])
    return out


def eval_stream_repeats():
    """The serving forward's private stream on the card: a forward that
    draws (``data + random_uniform``), captured and replayed three
    times, gives the same draws each replay (the JAX package's constant
    key); returns whether they also equal an eager run's."""
    data = mt.sym.Variable("data")
    probe = data + mt.sym.random_uniform(shape=(2, 3))
    zeros = torch.zeros(2, 3, device="cuda")
    cf = mt.serving.CompiledForward(probe, ["data"])
    graphs = {}
    cf.aot_compile({}, {}, {"data": (2, 3)}, device=zeros.device,
                   graphs=graphs)
    draws = [cf.run({}, {}, {"data": zeros}, graphs=graphs,
                    take=lambda outs: outs[0].clone()) for _ in range(3)]
    eager = mt.serving.CompiledForward(probe, ["data"]).run(
        {}, {}, {"data": zeros})[0]
    if cf.counts()["graph_replays"] != 3 or not all(
            torch.equal(d, draws[0]) for d in draws) \
            or draws[0].std().item() == 0:
        raise AssertionError("the captured forward's draws changed: %s"
                             % [d.tolist() for d in draws])
    return {"replays_equal": True, "equal_to_eager":
            torch.equal(draws[0], eager), "draws": draws[0][0].tolist()}


def serve_server(card):
    """The cell: ResNet-50 and GPT-2 small behind one ModelServer on the
    card, one CUDA graph per (tenant, bucket).  Returns the launch counts
    of the path (start and serving; the references' apart) and a record
    with the replayed batch's launches."""
    _phase("serve_server")
    seconds, last = {}, [time.perf_counter()]

    def mark(step):
        now = time.perf_counter()
        seconds[step] = now - last[0]
        last[0] = now

    tenants = serve_tenants()
    mark("tenants")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_reserved = torch.cuda.memory_reserved()
    layers = GPT2_SMALL["num_layers"]
    k1 = K1_SOURCES[torch.float32]
    record = {"card": card, "buckets": SERVE_BUCKETS,
              "eval_stream": eval_stream_repeats()}

    srv = make_server(tenants)
    reset_launch_counts()
    rng = np.random.default_rng(SEED + 1)
    with ClientDuringStart(srv, "resnet-50",
                           tenants["resnet-50"][4](rng, 1)) as client:
        record["shared_pool"] = started(srv)
    record["client_during_start"] = {"refused": client.refused,
                                     "cuda_ops": client.cuda_ops}
    if client.error is not None or not client.refused \
            or not client.cuda_ops:
        raise AssertionError("a client beside start(): %s, error %r"
                             % (record["client_during_start"],
                                client.error))
    mark("start")
    st = srv.stats()
    captured = {n: m.cf.counts()["graph_captures"]
                for n, m in srv._models.items()}
    # each LM bucket: 12 launches in the eager warm-up, 12 at capture
    expect_launches("serve_server start", launch_counts(),
                    **{k1: 2 * layers * len(SERVE_BUCKETS)})
    if st["aot_compiles"] != 10 or st["graph_captures"] != 10 \
            or st["retraces"] or captured != {n: 5 for n in tenants}:
        raise AssertionError("start: %s %s" % (st, captured))
    # the references: each tenant's eager forward (a CompiledForward of
    # its own, never registered), then one CPU Predictor request each
    cfs = {n: mt.serving.CompiledForward(
        m.symbol, list(m.example_shapes) + list(m.label_trailing))
        for n, m in srv._models.items()}

    record["parity_gaps"] = parity_burst(srv, tenants, cfs)
    mark("parity")
    occ = srv.stats()["occupancy"]
    if sorted(int(b) for b in occ) != SERVE_BUCKETS:
        raise AssertionError("occupancy %s misses a bucket" % occ)
    record["replay_ms"] = replay_ms(srv)
    nbytes, pinned_s, pageable_s = logits_copy_rate(srv)
    record["logits_copy"] = {"bytes": nbytes, "pinned_bytes_per_s":
                             nbytes / pinned_s, "pageable_bytes_per_s":
                             nbytes / pageable_s}

    # one request per tenant against the port's CPU Predictor
    rng = np.random.default_rng(SEED + 11)
    blobs = {n: params_blob(t[1], t[2]) for n, t in tenants.items()}
    cpu_gaps = {}
    for name, (sym, arg, aux, example, make) in tenants.items():
        x = make(rng, 1)
        (got,) = srv.predict({"data": x}, model=name)
        with uncounted():
            pred = mt.Predictor(sym.tojson(), blobs[name],
                                {"data": (1,) + example}, dev_type="cpu")
            (want,) = pred.predict(data=x)
        tol = LOGIT_TOL if name == "gpt2-small" else PROB_TOL
        torch.testing.assert_close(got, want, **tol)
        cpu_gaps[name] = (got - want).abs().max().item()
        del pred, got, want
    record["cpu_predictor_max_abs_err"] = cpu_gaps
    mark("replays_copies_cpu")

    # a replayed LM batch, traced
    ids = tenants["gpt2-small"][4](rng, 4)
    record["replayed_batch_launches"] = traced_launches(
        lambda: srv.predict({"data": ids}, model="gpt2-small"))
    expect_launches("a replayed gpt2-small batch",
                    record["replayed_batch_launches"], **{k1: layers})

    # open-loop Poisson load, both tenants at once
    with uncounted():
        cap = capacity(tenants, blobs)
    del blobs
    record["capacity"] = cap
    mark("trace_capacity")
    record["load"] = {}
    for level, factor in enumerate(SERVE_RESNET_LOADS):
        rates = {"resnet-50": factor * cap["resnet-50"]["rps"],
                 "gpt2-small": SERVE_LM_LOAD * cap["gpt2-small"]["rps"]}
        rec = load_level(srv, tenants, rates, SERVE_LOAD_S, SEED + 20 + level)
        record["load"]["resnet-50 x%g" % factor] = rec
        _emit({"serve_server_load": "resnet-50 x%g, gpt2-small x%g"
               % (factor, SERVE_LM_LOAD), **rec})
    record["breakdown"] = where_time_goes(srv, tenants, {
        "resnet-50": SERVE_RESNET_LOADS[0] * cap["resnet-50"]["rps"],
        "gpt2-small": SERVE_LM_LOAD * cap["gpt2-small"]["rps"]},
        SERVE_BREAKDOWN_S)
    mark("load")
    _emit({"serve_server_breakdown": record["breakdown"]})
    record["drills"] = fault_drills(srv, tenants)
    mark("drills")
    launches = launch_counts()
    record["graph_replays"] = srv.stats()["graph_replays"]
    record["stats"] = {k: v for k, v in srv.stats().items()
                       if k not in ("per_model", "policy", "obs_scope")}

    # overload: ResNet-50 alone at 1x and 4x capacity, reject policy
    with uncounted():
        rmake = tenants["resnet-50"][4]
        record["overload"] = overload_probe(
            lambda **kw: make_server({"resnet-50": tenants["resnet-50"]},
                                     **kw),
            "resnet-50", rmake, cap["resnet-50"]["rps"],
            load_factors=(1.0, 4.0),
            per_load=int(SERVE_LOAD_S * cap["resnet-50"]["rps"]))
    for run in record["overload"]["loads"]:
        if not settled(run):
            raise AssertionError("overload: futures did not settle: %s"
                                 % run)
    mark("overload")
    record["seconds"] = seconds
    record["phase_s"] = sum(seconds.values())
    _emit({"serve_server": {k: v for k, v in record.items()
                            if k not in ("load", "breakdown")}})
    # the servers' graphs die with them: what the phase still holds on
    # the card, beyond the tenants' weights, is SERVE_HELD_AFTER_BYTES at
    # most, not the 15.7 GB of the buckets' graphs
    del srv, cfs
    release_serving()
    held = torch.cuda.memory_reserved() - base_reserved
    _emit({"serve_server_held_after_bytes": held})
    if held > SERVE_HELD_AFTER_BYTES:
        raise AssertionError("the dropped servers left %d bytes reserved"
                             % held)
    return launches, record


def cyclic_tokens(n, rng, dtype=np.float32):
    """``n`` memorizable sequences of seq_len + 1 tokens, each counting up
    by one from a random start, modulo the vocabulary (the data of
    ``tests/test_models.py::test_transformer_lm_learns``); returns the
    inputs and the next tokens, float32 as NDArrayIter takes them (or
    ``dtype``)."""
    t, vocab = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    seqs = (rng.integers(0, vocab, n)[:, None] + np.arange(t + 1)) % vocab
    return seqs[:, :t].astype(dtype), seqs[:, 1:].astype(dtype)


TRAIN_INIT = dict(factor_type="in", magnitude=2.0)     # Xavier's


class _fused_policy:
    """``MXTPU_MODULE_FUSED`` set to ``policy`` inside the scope."""

    def __init__(self, policy):
        self.policy, self.saved = policy, None

    def __enter__(self):
        self.saved = os.environ.get("MXTPU_MODULE_FUSED")
        os.environ["MXTPU_MODULE_FUSED"] = self.policy

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("MXTPU_MODULE_FUSED")
        else:
            os.environ["MXTPU_MODULE_FUSED"] = self.saved


def gpt2_train_cell(fused=False, compute_dtype=None):
    """The trained cell: the LM at GPT-2 small's widths and full depth in
    a Module on the card, bound, initialized (Xavier, from SEED) and with
    Adam installed, and its NDArrayIter of TRAIN_BATCHES batches of
    cyclic tokens.  ``fused`` takes Module's default policy on a gpu
    context, the fused Trainer; else ``MXTPU_MODULE_FUSED=never``, the
    classic executor path.  Under a bfloat16 ``compute_dtype`` the tokens
    are int32: the step casts every floating input to the compute dtype,
    as the JAX package's does, and bfloat16 holds integers exactly only
    up to 256.  Returns (module, iterator, the inputs, the labels, set-up
    seconds)."""
    X, Y = cyclic_tokens(BATCH * TRAIN_BATCHES,
                         np.random.default_rng(SEED + 3),
                         np.int32 if compute_dtype else np.float32)
    symbol = mt.models.transformer.get_symbol(**GPT2_SMALL)
    data = mt.io.NDArrayIter(X, Y, batch_size=BATCH)     # on the card
    with _fused_policy("auto" if fused else "never"):
        mod = mt.mod.Module(symbol, context=mt.gpu(),
                            compute_dtype=compute_dtype)
    mt.random.seed(SEED)
    t0 = time.perf_counter()
    mod.bind(data.provide_data, data.provide_label)
    mod.init_params(mt.init.Xavier(**TRAIN_INIT))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": TRAIN_LR})
    torch.cuda.synchronize()
    if fused != (mod._trainer is not None):
        raise AssertionError("Module took the %s path"
                             % ("classic" if fused else "fused"))
    return mod, data, X, Y, time.perf_counter() - t0


def host_params(mod):
    """The module's parameters, copied to the host."""
    arg, _ = mod.get_params()
    return {n: v.data.clone() for n, v in arg.items()}


def fused_step_grads(mod, x, y):
    """One step's float32 gradients of the module's fused Trainer on the
    batch ``(x, y)``, on the host, the state untouched."""
    tr = mod._trainer
    batch = tr._device_batch({"data": x, "softmax_label": y})
    _, _, grads = tr._run_backward(tr.params, tr.aux, batch, None)
    return {n: g.cpu() for n, g in grads.items()}


def replayed_step_launches(mod, batch):
    """One more step of a fused module, a replay of its CUDA graph, traced
    by ``torch.profiler``; returns its attention kernel launches by source
    name (``traced_launches``)."""
    tr = mod._trainer
    replays = tr.graph_replays

    def step():
        mod.forward(batch, is_train=True)
        mod.update()

    launches = traced_launches(step)
    if tr.graph_replays != replays + 1:
        raise AssertionError("the traced step was not one replay: %d "
                             "replays" % (tr.graph_replays - replays))
    return launches


def _rel_errors(got, want, steps):
    """Relative error by parameter, the key third of each qkv bias apart:
    its gradient is 0 but for rounding (softmax ignores a shift common to
    a row's scores), and Adam divides that noise by its own size, so
    there each side may step by up to lr a step; returns (errors, the
    largest key-bias step)."""
    h, rel, key_step = GPT2_SMALL["num_hidden"], {}, 0.0
    for n, w in want.items():
        g = got[n]
        if n.endswith("_attn_qkv_bias"):
            key_step = max(key_step, g[h:2 * h].abs().max().item(),
                           w[h:2 * h].abs().max().item())
            g, w = torch.cat([g[:h], g[2 * h:]]), torch.cat([w[:h], w[2 * h:]])
        rel[n] = ((g - w).norm() / w.norm()).item()
    if key_step > TRAIN_LR * steps:
        raise AssertionError("a key bias moved %g in %d Adam steps of lr %g"
                             % (key_step, steps, TRAIN_LR))
    return rel, key_step


def train(name="train", compute_dtype=None, reference=None):
    """A training phase: ``Module.fit`` trains the LM at GPT-2 small's
    widths and full depth on the card, TRAIN_EPOCHS epochs of
    TRAIN_BATCHES batches.  ``train`` is the classic executor path,
    ``train_fused`` the fused Trainer (float32), ``train_fused_bf16`` the
    fused Trainer with bfloat16 compute.  Asserts 12 K1 and 12 B2
    launches of the dtype's kernels each step (a fused step: launched by
    its first step and captured by its second, then traced in a replay),
    one capture and a replay a step after it, no input copied, and a
    falling perplexity; the fused float32 phase's parameters after its
    first two steps against ``reference`` (the classic phase's), and the
    bfloat16 phase's first-step gradients against ``reference`` (the
    float32 fused phase's).  Returns (launches, the step record, the
    parameters after steps 1 and 2, the first step's gradients)."""
    _phase(name)
    mm = torch.backends.cuda.matmul
    user_flags = (mm.allow_bf16_reduced_precision_reduction,
                  mm.allow_fp16_reduced_precision_reduction)
    fused = name != "train"
    t, layers = GPT2_SMALL["seq_len"], GPT2_SMALL["num_layers"]
    dtype = torch.bfloat16 if compute_dtype else torch.float32
    k1, b2 = K1_SOURCES[dtype], B2_SOURCES[dtype]
    # bound and initialized ahead, so fit's first step is a step alone
    mod, data, X, Y, setup_s = gpt2_train_cell(fused, compute_dtype)
    grads = fused_step_grads(mod, X[:BATCH], Y[:BATCH]) if fused else None

    steps, snapshots = [], []
    last = {}

    def on_batch(param):
        """Synchronise, then the step's time, perplexity and launches;
        the parameters after the first two steps."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        m = param.eval_metric
        total, count = m.sum_metric, m.num_inst      # since the epoch began
        if param.nbatch == 0:
            last.update(total=0.0, count=0)
        counts = launch_counts()
        steps.append({
            "epoch": param.epoch, "s": now - last["t"],
            "perplexity": math.exp((total - last["total"])
                                   / (count - last["count"])),
            "launches": {n: counts[n] - last["counts"][n] for n in counts}})
        if len(steps) <= 2:
            snapshots.append(host_params(mod))
            torch.cuda.synchronize()
            now = time.perf_counter()
        last.update(t=now, total=total, count=count, counts=counts)

    metric = mt.metric.Perplexity(None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    last.update(t=time.perf_counter(), counts=launch_counts())
    mod.fit(data, num_epoch=TRAIN_EPOCHS, optimizer="adam",
            optimizer_params={"learning_rate": TRAIN_LR},
            initializer=mt.init.Xavier(**TRAIN_INIT), eval_metric=metric,
            batch_end_callback=on_batch)
    launches = launch_counts()
    copies = fa.flash_attention_fwd.padded_copies + fa.flash_attention_bwd.copies
    peak = torch.cuda.max_memory_allocated()
    n_steps = TRAIN_EPOCHS * TRAIN_BATCHES
    if copies:
        raise AssertionError("training copied %d attention inputs" % copies)
    # what the wrappers count: every step on the classic path; on the
    # fused path the eager first step and the capture of the second
    counted = 2 if fused else n_steps
    expect_launches(name, launches, **{k1: layers * counted,
                                       b2: layers * counted})
    for i, step in enumerate(steps):
        want = layers if i < counted else 0
        if step["launches"][k1] != want or step["launches"][b2] != want:
            raise AssertionError("step %d launched %s" % (i, step["launches"]))
    per_epoch = [math.exp(statistics.fmean(
        math.log(s["perplexity"]) for s in steps if s["epoch"] == e))
        for e in range(TRAIN_EPOCHS)]
    step_s = statistics.median(s["s"] for s in steps[1:])
    record = {name: "gpt2-small", "batch": BATCH, "seq_len": t,
              "layers": layers, "steps": n_steps, "optimizer": "adam",
              "lr": TRAIN_LR, "compute_dtype": str(dtype),
              "path": "fused" if fused else "classic", "setup_s": setup_s,
              "first_step_s": steps[0]["s"], "step_s": step_s,
              "step_s_runs": [s["s"] for s in steps],
              "tokens_per_s": BATCH * t / step_s,
              "peak_memory_bytes": peak,
              "perplexity_by_step": [s["perplexity"] for s in steps],
              "perplexity_by_epoch": per_epoch, "launches": launches}
    if fused:
        tr = mod._trainer
        record.update(capture_step_s=steps[1]["s"],
                      replay_step_s=statistics.median(
                          s["s"] for s in steps[2:]),
                      graph_captures=tr.graph_captures,
                      graph_replays=tr.graph_replays)
        if (tr.graph_captures, tr.graph_replays) != (1, n_steps - 1):
            raise AssertionError("%d captures and %d replays in %d steps"
                                 % (tr.graph_captures, tr.graph_replays,
                                    n_steps))
        data.reset()
        replayed = replayed_step_launches(mod, next(iter(data)))
        record["replayed_step_launches"] = replayed
        record["launch_count_method"] = (
            "a replayed step traced by torch.profiler, kernels counted by "
            "device name")
        expect_launches("a replayed %s step" % name, replayed,
                        **{k1: layers, b2: layers})
    _emit(record)
    if len(steps) != n_steps or not all(
            math.isfinite(p) for p in record["perplexity_by_step"]):
        raise AssertionError("training gave %s" % record)
    if not per_epoch[-1] * PPL_FALL < per_epoch[0]:
        raise AssertionError("perplexity fell from %g to %g, not by %gx"
                             % (per_epoch[0], per_epoch[-1], PPL_FALL))
    if reference is not None and not compute_dtype:
        # the fused step (first eager, then a replay of its graph) against
        # the classic path's, from the same weights and batches
        for i, (got, want) in enumerate(zip(snapshots, reference)):
            rel, key_step = _rel_errors(got, want, i + 1)
            worst = max(rel, key=rel.get)
            _emit({"fused_vs_classic_after_step": i + 1,
                   "param_rel_err_max": rel[worst], "worst": worst,
                   "key_bias_max_step": key_step})
            if not rel[worst] <= FUSED_PARAM_TOL[i]:
                raise AssertionError("after step %d the fused %s is %g from "
                                     "the classic path's" % (i + 1, worst,
                                                             rel[worst]))
    if reference is not None and compute_dtype:
        rel = {n: ((grads[n] - g).norm() / g.norm()).item()
               for n, g in reference.items()}
        worst = max(rel, key=rel.get)
        record["grad_rel_err_vs_float32_max"] = rel[worst]
        _emit({"bf16_grads_vs_float32": name, "grad_rel_err_max": rel[worst],
               "worst": worst, "median": statistics.median(rel.values()),
               "tolerance": BF16_GRAD_TOL})
        if not rel[worst] <= BF16_GRAD_TOL:
            raise AssertionError("bfloat16 gradients: %s is %g from float32"
                                 % (worst, rel[worst]))
    flags = (mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction)
    _emit({"reduced_precision_reduction": name, "bf16_fp16": flags})
    if flags != user_flags:
        raise AssertionError("%s left cuBLAS's reduced-precision flags at "
                             "%s (they were %s)" % (name, flags, user_flags))
    del mod, data
    torch.cuda.empty_cache()
    if not fused:
        record["max_grad_rel_err"] = train_step_vs_cpu(X[:BATCH], Y[:BATCH])
    return launches, record, snapshots, grads


def train_step_vs_cpu(x, y):
    """One training step's gradients on the card against the port's CPU
    run of the same step, at GPT-2 small's widths and batch with the
    depth cut to CPU_LAYERS on both sides; returns the largest relative
    error."""
    t = GPT2_SMALL["seq_len"]
    symbol = mt.models.transformer.get_symbol(
        **dict(GPT2_SMALL, num_layers=CPU_LAYERS))
    shapes, _, _ = symbol.infer_shape(data=(BATCH, t),
                                      softmax_label=(BATCH, t))
    params = _random_params(symbol, shapes, np.random.default_rng(SEED + 4))
    req = {n: "write" if n in params else "null"
           for n in symbol.list_arguments()}
    grads, secs = [], {}
    for ctx in (mt.gpu(), mt.cpu()):
        exe = symbol.simple_bind(ctx, grad_req=req, data=(BATCH, t),
                                 softmax_label=(BATCH, t))
        exe.copy_params_from({n: mt.nd.NDArray(v) for n, v in params.items()})
        reset_launch_counts()
        t0 = time.perf_counter()
        exe.forward(is_train=True, data=x, softmax_label=y)
        exe.backward()
        mt.nd.waitall()
        secs[str(ctx)] = time.perf_counter() - t0
        if ctx.device_type == "gpu":
            expect_launches("the compared step", launch_counts(), **{
                K1_SOURCES[torch.float32]: CPU_LAYERS,
                B2_SOURCES[torch.float32]: CPU_LAYERS})
        grads.append({n: exe.grad_dict[n].data.cpu() for n in params})
        del exe
    card, host = grads
    rel = {n: ((card[n] - host[n]).norm() / host[n].norm()).item()
           for n in params}
    worst = max(rel, key=rel.get)
    _emit({"train_step_vs_cpu": "gpt2-small widths", "layers": CPU_LAYERS,
           "batch": BATCH, "seq_len": t, "grad_rel_err_max": rel[worst],
           "worst": worst, "grad_rel_err": rel, "seconds": secs})
    if not all(math.isfinite(r) and r < GRAD_REL_TOL for r in rel.values()):
        raise AssertionError("gradients on the card and the CPU differ: %s "
                             "%g (tolerance %g)" % (worst, rel[worst],
                                                    GRAD_REL_TOL))
    return rel[worst]


def _mlp_block_symbol():
    """GPT-2 small's MLP block as a float-input classifier, with a
    Dropout: it draws random numbers inside the step, and a NaN batch
    gives NaN gradients (token ids cannot: the embedding clamps them)."""
    c = GPT2_SMALL["num_hidden"]
    h = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4 * c,
                              name="mlp1")
    h = mt.sym.Activation(h, act_type="gelu")
    h = mt.sym.Dropout(h, p=DROPOUT_P)
    h = mt.sym.FullyConnected(h, num_hidden=c, name="mlp2")
    return mt.sym.SoftmaxOutput(h, name="softmax")


def _state(tr):
    """Clones of a trainer's params and optimizer state."""
    return [v.clone() for v in list(tr.params.values()) + [
        x for s in tr.opt_state.values() for x in (s or ())]]


def sentinel():
    """The sentinel build of the fused step, through capture and replays
    on the card: the LM at GPT-2 small's widths with its depth cut to
    SENTINEL_LAYERS (clean steps: no skip, the update counter on the
    device advancing); then GPT-2's MLP block with a Dropout, where a NaN
    batch inside a replay must leave params and optimizer state bitwise
    as they were and count one skip, and where every replay must draw
    fresh Dropout masks.  Returns the record."""
    _phase("sentinel")
    t = GPT2_SMALL["seq_len"]
    rng = np.random.default_rng(SEED + 5)
    record = {"sentinel": "skip"}
    with mt.gpu():
        lm = mt.parallel.Trainer(
            mt.models.transformer.get_symbol(
                **dict(GPT2_SMALL, num_layers=SENTINEL_LAYERS)),
            mt.optimizer.Adam(learning_rate=TRAIN_LR,
                              rescale_grad=1.0 / BATCH), sentinel="skip")
    lm.bind({"data": (BATCH, t)}, {"softmax_label": (BATCH, t)})
    mt.random.seed(SEED)
    lm.init_params(mt.init.Xavier(**TRAIN_INIT))
    x, y = cyclic_tokens(BATCH, rng)
    for _ in range(4):
        out = lm.step({"data": x, "softmax_label": y})[0]
    torch.cuda.synchronize()
    record["lm"] = {"layers": SENTINEL_LAYERS, "steps": 4,
                    "captures": lm.graph_captures,
                    "replays": lm.graph_replays,
                    "skips": lm.sentinel_skips, "t": int(lm._sent["t"])}
    if record["lm"] != dict(record["lm"], captures=1, replays=3, skips=0,
                            t=4) or not torch.isfinite(out.data).all():
        raise AssertionError("sentinel LM steps gave %s" % record["lm"])
    del lm, out

    rows, c = BATCH * t, GPT2_SMALL["num_hidden"]
    xs = rng.standard_normal((rows, c), dtype=np.float32)
    labels = rng.integers(0, c, rows).astype(np.float32)
    clean = {"data": xs, "softmax_label": labels}
    nan = {"data": np.full_like(xs, np.nan), "softmax_label": labels}
    with mt.gpu():
        tr = mt.parallel.Trainer(_mlp_block_symbol(), mt.optimizer.Adam(
            learning_rate=1e-3, rescale_grad=1.0 / rows), sentinel="skip")
    tr.bind({"data": (rows, c)}, {"softmax_label": (rows,)})
    tr.init_params(mt.init.Xavier(**TRAIN_INIT))
    tr.step(clean)                                   # eager
    tr.step(clean)                                   # capture, replay
    before = _state(tr)
    out = tr.step(nan)[0]                            # replay
    torch.cuda.synchronize()
    unchanged = all(torch.equal(a, b) for a, b in zip(before, _state(tr)))
    skips, t_dev = tr.sentinel_skips, int(tr._sent["t"])
    outs = [tr.step(clean)[0].data for _ in range(2)]      # replays
    moved = not all(torch.equal(a, b) for a, b in zip(before, _state(tr)))
    record["dropout_block"] = {
        "captures": tr.graph_captures, "replays": tr.graph_replays,
        "nan_step_unchanged": unchanged, "skips": skips,
        "t_after_nan": t_dev, "nan_outputs": bool(torch.isnan(
            out.data).all()), "moved_after": moved}
    # every replay draws new masks: a zero-lr trainer's outputs differ
    # from replay to replay on the same batch
    with mt.gpu():
        frozen = mt.parallel.Trainer(_mlp_block_symbol(),
                                     mt.optimizer.SGD(learning_rate=0.0))
    frozen.bind({"data": (rows, c)}, {"softmax_label": (rows,)})
    frozen.init_params(mt.init.Xavier(**TRAIN_INIT))
    probs = [frozen.step(clean)[0].data for _ in range(4)]
    fresh = [not torch.equal(a, b) for a, b in zip(probs[1:], probs[2:])]
    record["dropout_block"].update(fresh_masks_by_replay=fresh,
                                   frozen_replays=frozen.graph_replays)
    _emit(record)
    if not (unchanged and skips == 1 and t_dev == 2 and moved
            and record["dropout_block"]["nan_outputs"]
            and tr.graph_captures == 1 and tr.graph_replays == 4
            and frozen.graph_replays == 3 and all(fresh)):
        raise AssertionError("sentinel phase gave %s" % record)
    del tr, frozen, outs, probs
    torch.cuda.empty_cache()
    return record


def _resnet_trainer(ctx, symbol, arg, aux, batch):
    """A float32 fused Trainer of ``symbol`` on ``ctx`` with bench.py's
    SGD, bound to ``batch`` images of RESNET_CHECK_IMAGE^2 and initialised
    from the numpy ``arg``/``aux``."""
    with ctx:
        tr = mt.parallel.Trainer(
            symbol, mt.optimizer.SGD(rescale_grad=1.0 / batch, **RESNET_SGD))
    image = RESNET_CHECK_IMAGE
    tr.bind({"data": (batch, image, image, 3)}, {"softmax_label": (batch,)})
    tr.init_params(
        arg_params={n: torch.from_numpy(v) for n, v in arg.items()},
        aux_params={n: torch.from_numpy(v) for n, v in aux.items()})
    return tr


def _rel_norms(got, want):
    return {n: ((got[n].double() - w.double()).norm()
                / w.double().norm().clamp(min=1e-30)).item()
            for n, w in want.items()}


def _batch_statistics(stepped, before):
    """The batch statistics of a training forward, by name, recovered
    from the moving statistics it made (``stepped``, in aux-name order)
    from ``before``: ``new = m old + (1 - m) batch``.  An eval forward on
    them normalises as training does; on the initial ones (mean 0, var 1)
    the deep network's activations run away and the softmax saturates."""
    m = RESNET_BN_MOMENTUM
    return {n: ((v.double().cpu() - m * before[n].double()) / (1 - m))
            .float() for n, v in zip(before, stepped)}


def train_resnet_vs_cpu():
    """One fused float32 step of ImageNet-form ResNet-50 (NHWC, batch
    RESNET_CHECK_BATCH of RESNET_CHECK_IMAGE^2 images, SGD momentum) on
    the card against the same step of the port on the CPU, from the same
    random weights: every parameter gradient (their median and largest
    error, and the head's), the step's output, both moving statistics of
    every BatchNorm after the step, and the eval output (``score``'s
    forward) on the batch's statistics.  Runs with cuDNN's TF32 flag at
    PyTorch's default (on), which the convolutions must turn off for
    themselves, and asserts the flag unchanged after.  Returns the kernel
    launches of the card's run."""
    _phase("train_resnet_vs_cpu")
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = True            # PyTorch's default, as users have it
    try:
        symbol = mt.models.get_symbol("resnet-50", **RESNET)
        b = RESNET_CHECK_BATCH
        arg, aux, x, y = resnet_params_and_batch(symbol, b,
                                                 RESNET_CHECK_IMAGE)
        batch = {"data": x, "softmax_label": y}
        before = {n: torch.from_numpy(v) for n, v in aux.items()}
        runs, secs = {}, {}
        for side, ctx in (("card", mt.gpu()), ("cpu", mt.cpu())):
            t0 = time.perf_counter()
            reset_launch_counts()
            tr = _resnet_trainer(ctx, symbol, arg, aux, b)
            dev = tr._device_batch(batch)
            _, stepped, grads = tr._run_backward(tr.params, tr.aux, dev,
                                                 None)
            # score's forward on moving statistics equal to this batch's,
            # with the weights the statistics came from; then the step
            tr.set_params({}, _batch_statistics(stepped, before))
            evals = tr.forward(batch)[0].data
            tr.set_params({}, before)
            out = tr.step(batch)[0].data
            moving = {n: v.cpu() for n, v in tr.aux.items()}
            if side == "card":
                torch.cuda.synchronize()
                launches = launch_counts()
            runs[side] = (
                {n: g.cpu() for n, g in grads.items()}, moving,
                {"step_output": out.cpu(), "eval_output": evals.cpu()})
            secs[side] = time.perf_counter() - t0
            del tr, dev, grads, out, evals
        flag = cudnn.allow_tf32
    finally:
        cudnn.allow_tf32 = saved
    expect_launches("train_resnet_vs_cpu", launches)
    (cg, cm, co), (hg, hm, ho) = runs["card"], runs["cpu"]
    grad, moving = _rel_norms(cg, hg), _rel_norms(cm, hm)
    outs = _rel_norms(co, ho)
    worst_g, worst_m = max(grad, key=grad.get), max(moving, key=moving.get)
    held = dict(outs, moving=moving[worst_m], fc1_weight=grad["fc1_weight"],
                fc1_bias=grad["fc1_bias"])
    # a saturated softmax (one-hot rows) would match at any precision
    top = co["eval_output"].max(dim=1).values
    record = {"train_resnet_vs_cpu": "resnet-50 NHWC float32", "batch": b,
              "image": RESNET_CHECK_IMAGE, "cudnn_allow_tf32": flag,
              "grad_rel_err_max": grad[worst_g], "worst_grad": worst_g,
              "grad_rel_err_median": statistics.median(grad.values()),
              "worst_moving": worst_m, "held_to_tolerance": held,
              "tolerance": RESNET_TOL,
              "grad_tolerance": {"median": RESNET_GRAD_MEDIAN_TOL,
                                 "max": RESNET_GRAD_MAX_TOL},
              "eval_top_probability": top.tolist(),
              "finite": all(bool(torch.isfinite(v).all()) for v in
                            list(cg.values()) + list(co.values())),
              "seconds": secs}
    _emit(record)
    if flag is not True:
        raise AssertionError("the ResNet step left cuDNN's TF32 flag at %s "
                             "(it was True)" % flag)
    if not record["finite"] or not all(
            math.isfinite(e) and e <= RESNET_TOL for e in held.values()) \
            or not float(top.max()) < 0.5 \
            or not record["grad_rel_err_median"] <= RESNET_GRAD_MEDIAN_TOL \
            or not grad[worst_g] <= RESNET_GRAD_MAX_TOL:
        raise AssertionError("the card's float32 ResNet step is off the "
                             "CPU's: %s" % record)
    torch.cuda.empty_cache()
    return launches


def resnet_cell(kvstore="local"):
    """The tentpole cell's module and data: a Module on ``gpu(0)`` with
    bfloat16 compute, bound, initialised (Xavier gaussian, from SEED) and
    with bench.py's SGD and ``kvstore`` installed; an NDArrayIter of
    RESNET_STEPS copies of one batch of N(0, 1) images and int32 labels,
    made on the card from SEED.  Returns (module, iterator, the batch's
    images and labels, set-up seconds)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
    x = torch.randn(shape, generator=gen, device="cuda")
    y = torch.randint(0, RESNET["num_classes"], (RESNET_BATCH,),
                      generator=gen, device="cuda", dtype=torch.int32)
    data = mt.io.NDArrayIter(
        mt.nd.NDArray(x.repeat(RESNET_STEPS, 1, 1, 1)),
        mt.nd.NDArray(y.repeat(RESNET_STEPS)), batch_size=RESNET_BATCH)
    symbol = mt.models.get_symbol("resnet-50", **RESNET)
    mod = mt.mod.Module(symbol, context=mt.gpu(), compute_dtype="bfloat16")
    mt.random.seed(SEED)
    t0 = time.perf_counter()
    mod.bind(data.provide_data, data.provide_label)
    mod.init_params(mt.init.Xavier(**RESNET_INIT))
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=RESNET_SGD)
    torch.cuda.synchronize()
    if mod._trainer is None:
        raise AssertionError("Module took the classic path")
    return mod, data, x, y, time.perf_counter() - t0


def train_resnet_bf16():
    """The ResNet cell: ``Module.fit`` trains ResNet-50 at bench.py's
    configuration (batch 256 of 224 x 224, bfloat16 compute, SGD momentum)
    on the fused path over RESNET_STEPS steps of one repeated batch.
    Asserts one capture and a replay each step after it, no input copied
    on its way into the step, the first step's float32 gradients finite
    and the head's within RESNET_BF16_HEAD_TOL of float32 compute's on the
    same weights and batch, and a falling cross-entropy.  Returns (launches, the step record)."""
    _phase("train_resnet_bf16")
    t_phase = time.perf_counter()
    mod, data, x, y, setup_s = resnet_cell()
    tr = mod._trainer
    dev = tr._device_batch({"data": x, "softmax_label": y})
    if dev["data"] is not x or dev["softmax_label"] is not y:
        raise AssertionError("the step copied its inputs")
    _, _, bf16 = tr._run_backward(tr.params, tr.aux, dev, None)
    tr.compute_dtype = None
    _, _, f32 = tr._run_backward(tr.params, tr.aux, dev, None)
    tr.compute_dtype = torch.bfloat16
    grad = _rel_norms(bf16, f32)
    finite = all(bool(torch.isfinite(g).all()) for g in bf16.values())
    del bf16, f32
    worst = max(grad, key=grad.get)
    head = {n: grad[n] for n in RESNET_BF16_HEAD_TOL}
    _emit({"resnet_bf16_grads_vs_float32": "first step", "finite": finite,
           "head": head, "head_tolerance": RESNET_BF16_HEAD_TOL,
           "grad_rel_err_max": grad[worst], "worst": worst,
           "median": statistics.median(grad.values())})
    if not finite or not all(head[n] <= tol for n, tol in
                             RESNET_BF16_HEAD_TOL.items()):
        raise AssertionError("bfloat16 ResNet gradients: head %s (tolerance "
                             "%s), finite %s" % (head, RESNET_BF16_HEAD_TOL,
                                                 finite))

    steps, last = [], {}

    def on_batch(param):
        """Synchronise; the step's time and cross-entropy; no batch copied
        on its way in."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        m = param.eval_metric
        staged = param.locals["data_batch"].data[0].data
        steps.append({"s": now - last["t"], "ce": (
            m.sum_metric - last["sum"]) / (m.num_inst - last["n"]),
            "on_card": staged.is_cuda})
        last.update(t=now, sum=m.sum_metric, n=m.num_inst)

    metric = mt.metric.CrossEntropy()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    last.update(t=time.perf_counter(), sum=0.0, n=0)
    mod.fit(data, num_epoch=1, kvstore="local", optimizer="sgd",
            optimizer_params=RESNET_SGD,
            initializer=mt.init.Xavier(**RESNET_INIT), eval_metric=metric,
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches("train_resnet_bf16", launches)
    replay_s = statistics.median(s["s"] for s in steps[2:])
    record = {"train_resnet_bf16": "resnet-50 NHWC", "batch": RESNET_BATCH,
              "image": RESNET_IMAGE, "compute_dtype": "bfloat16",
              "optimizer": "sgd", **RESNET_SGD, "steps": len(steps),
              "setup_s": setup_s, "first_step_s": steps[0]["s"],
              "capture_step_s": steps[1]["s"], "replay_step_s": replay_s,
              "step_ms": replay_s * 1e3,
              "img_per_s": RESNET_BATCH / replay_s,
              "step_s_runs": [s["s"] for s in steps],
              "cross_entropy_by_step": [s["ce"] for s in steps],
              "peak_memory_bytes": peak,
              "graph_captures": tr.graph_captures,
              "graph_replays": tr.graph_replays, "launches": launches,
              "phase_s": time.perf_counter() - t_phase}
    _emit(record)
    print("resnet-50 bf16 batch %d: step %.2f ms, %.1f img/s, peak %.2f GB, "
          "first step %.2f s, capture step %.2f s, phase %.1f s"
          % (RESNET_BATCH, record["step_ms"], record["img_per_s"], peak / 1e9,
             record["first_step_s"], record["capture_step_s"],
             record["phase_s"]), flush=True)
    ce = record["cross_entropy_by_step"]
    if len(steps) != RESNET_STEPS or not all(s["on_card"] for s in steps):
        raise AssertionError("ResNet training gave %s" % record)
    if (tr.graph_captures, tr.graph_replays) != (1, RESNET_STEPS - 1):
        raise AssertionError("%d captures and %d replays in %d steps"
                             % (tr.graph_captures, tr.graph_replays,
                                RESNET_STEPS))
    if not all(math.isfinite(c) for c in ce) or not ce[-1] < ce[0]:
        raise AssertionError("cross-entropy went from %g to %g"
                             % (ce[0], ce[-1]))
    del mod, data, tr, dev, x, y
    torch.cuda.empty_cache()
    return launches, record


# ----------------------------------------------------------------------
# train_resnet_records: ResNet-50 from a RecordIO file
def write_records(path):
    """bench.py's record file (``_ensure_rec``): RECORDS_IMAGES random
    RECORDS_SIDE^2 JPEGs at quality RECORDS_QUALITY from seed 0, labels
    ``i % 1000``; returns the JPEG bytes."""
    import io as pio
    from PIL import Image
    rng = np.random.RandomState(SEED)
    rec, jpegs = mt.recordio.MXRecordIO(path, "w"), []
    for i in range(RECORDS_IMAGES):
        buf = pio.BytesIO()
        Image.fromarray(rng.randint(0, 255, (RECORDS_SIDE, RECORDS_SIDE, 3),
                                    dtype=np.uint8)).save(
            buf, format="JPEG", quality=RECORDS_QUALITY)
        jpegs.append(buf.getvalue())
        rec.write(mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i % 1000), i, 0), buf.getvalue()))
    rec.close()
    return jpegs


def native_loader(rec, side, **kw):
    """``ImageRecordIter`` forced to the native loader: uint8 NHWC host
    batches of RESNET_BATCH, one decode thread a core."""
    it = mt.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, side, side), batch_size=RESNET_BATCH,
        layout="NHWC", dtype="uint8", output="numpy",
        preprocess_threads=os.cpu_count(), backend="native", **kw)
    if type(it) is not mt.io.NativeImageRecordIter:
        raise AssertionError("ImageRecordIter gave %s" % type(it).__name__)
    return it


def check_loader(rec, jpegs):
    """The loader's first batch against Pillow's decode of the same JPEGs
    (BGR), within its route's LOADER_TOL; its labels and failures."""
    import io as pio
    from PIL import Image
    from mxnet_tpu_torch import _native
    t0 = time.perf_counter()
    route = _native.jpeg_route()
    build_s = time.perf_counter() - t0
    it = native_loader(rec, RECORDS_SIDE)
    b = it.next()
    want = np.stack([np.asarray(Image.open(pio.BytesIO(j)).convert("RGB"))
                     [:, :, ::-1] for j in jpegs[:RESNET_BATCH]])
    diff = np.abs(b.data[0].astype(np.int32) - want.astype(np.int32))
    err = {"max_abs": int(diff.max()), "mean_abs": float(diff.mean())}
    tol = LOADER_TOL[route]
    record = {"jpeg_route": route, "png": bool(
        _native.dataloader_lib().mxt_loader_has_png()), "build_s": build_s,
              "vs_pillow": err, "tolerance": tol,
              "failures": it.failures()}
    _emit({"records_loader": record})
    if err["max_abs"] > tol["max_abs"] or err["mean_abs"] > tol["mean_abs"] \
            or it.failures() or not np.array_equal(
                b.label[0], np.arange(RESNET_BATCH, dtype=np.float32)):
        raise AssertionError("the native loader's batch is off: %s"
                             % record)
    return record


def decode_and_h2d(rec):
    """The stages alone (bench.py:250-283): decode img/s of the stream's
    loader (224^2 random crops, one thread a core) over 4 batches after a
    warm one, and the median ms of one 256 x 224 x 224 x 3 uint8 upload
    from a pinned slot."""
    it = native_loader(rec, RESNET_IMAGE, rand_crop=True)
    probe = it.next().data[0]
    t0, n = time.perf_counter(), 0
    while n < 4 * RESNET_BATCH:
        try:
            it.next()
            n += RESNET_BATCH
        except StopIteration:
            it.reset()
    decode = n / (time.perf_counter() - t0)
    pinned = torch.from_numpy(probe).pin_memory()
    dst = torch.empty(pinned.shape, dtype=torch.uint8, device="cuda")
    h2d_ms = cuda_ms(lambda: dst.copy_(pinned, non_blocking=True),
                     warmup=2, iters=7)
    return decode, h2d_ms, probe


class EndlessIter:
    """bench.py's ``_EndlessIter``: ``next()`` wraps epochs by resetting
    the inner iterator, so the stage ahead never sees an epoch's end."""

    def __init__(self, it):
        self.it = it
        self.batch_size = it.batch_size
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label

    def next(self):
        try:
            return self.it.next()
        except StopIteration:
            self.it.reset()
            return self.it.next()

    def reset(self):
        self.it.reset()


class Int32Labels(mt.io.DataIter):
    """The batches of ``inner`` with their float32 labels cast to int32 on
    the card: under bfloat16 compute float labels above 256 would round
    (ROADMAP §C).  ``changed`` counts, on the card, the labels that cast
    would have changed."""

    def __init__(self, inner):
        super().__init__(inner.batch_size)
        self.inner = inner
        self.provide_data = inner.provide_data
        self.provide_label = [mt.io.DataDesc(d.name, d.shape, np.int32)
                              for d in inner.provide_label]
        self.changed = torch.zeros((), dtype=torch.int64, device="cuda")

    def reset(self):
        self.inner.reset()

    def next(self):
        b = self.inner.next()
        label = b.label[0].data
        self.changed += (label.to(torch.bfloat16).float() != label).sum()
        b.label = [mt.nd.NDArray(label.to(torch.int32))]
        return b


def device_idle_share(prof, wall_s):
    """1 - (the union of the device's kernel and copy intervals) / wall."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    if not spans:
        raise AssertionError("the profiler recorded no device work")
    return 1.0 - busy_us / 1e6 / wall_s, len(spans)


def records_fit(name, train_data, compute_s):
    """``Module.fit`` of the ResNet cell (a fresh module, bench.py's
    _build_module with a ``dist_sync_tpu`` store) over ``train_data``
    (RECORDS_STEPS batches); then RECORDS_TRACED_STEPS more steps of the
    same batches under ``torch.profiler`` for the idle share.  Asserts
    every batch arrives on the card, enters the step uncopied and has
    int32 labels; one capture and a replay every step after it; a finite
    cross-entropy; none of the port's kernels launched.  Returns the
    record."""
    symbol = mt.models.get_symbol("resnet-50", **RESNET)
    mod = mt.mod.Module(symbol, context=mt.gpu(), compute_dtype="bfloat16")
    mt.random.seed(SEED)
    t0 = time.perf_counter()
    mod.bind(train_data.provide_data, train_data.provide_label)
    mod.init_params(mt.init.Xavier(**RESNET_INIT))
    store = mt.kvstore.create("dist_sync_tpu")
    mod.init_optimizer(kvstore=store, optimizer="sgd",
                       optimizer_params=dict(RESNET_SGD,
                                             rescale_grad=1.0 / RESNET_BATCH))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tr = mod._trainer
    if tr is None or store.type != "dist_sync_tpu" or store.num_workers != 1:
        raise AssertionError("the records cell left the fused path")
    steps, last, staged = [], {}, {}

    def on_batch(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        m, batch = param.eval_metric, param.locals["data_batch"]
        x, y = batch.data[0].data, batch.label[0].data
        dev = tr._device_batch({"data": x, "softmax_label": y})
        steps.append({"s": now - last["t"], "ce": (
            m.sum_metric - last["sum"]) / (m.num_inst - last["n"]),
            "on_card": x.is_cuda and y.is_cuda,
            "uncopied": dev["data"] is x and dev["softmax_label"] is y,
            "int32": y.dtype == torch.int32, "dtype": str(x.dtype)})
        staged["uploader"] = param.locals["train_data"]
        last.update(t=now, sum=m.sum_metric, n=m.num_inst)

    metric = mt.metric.CrossEntropy()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    last.update(t=time.perf_counter(), sum=0.0, n=0)
    mod.fit(train_data, num_epoch=1, kvstore=store, optimizer="sgd",
            eval_metric=metric, batch_end_callback=on_batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    captures, replays = tr.graph_captures, tr.graph_replays
    peak = torch.cuda.max_memory_allocated()
    uploader = staged["uploader"]
    fit_stats = uploader.stats() if hasattr(uploader, "stats") else None
    expect_launches(name, launches)
    train_data.reset()
    batches = [train_data.next() for _ in range(RECORDS_TRACED_STEPS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            mod.forward(b, is_train=True)
            mod.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, events = device_idle_share(prof, wall)
    replay = [s["s"] for s in steps[2:]]
    step_s = statistics.median(replay)
    record = {"train_resnet_records": name, "batch": RESNET_BATCH,
              "image": RESNET_IMAGE, "compute_dtype": "bfloat16",
              "kvstore": store.type, "steps": len(steps),
              "setup_s": setup_s, "first_step_s": steps[0]["s"],
              "capture_step_s": steps[1]["s"], "step_ms": step_s * 1e3,
              "step_ms_range": [min(replay) * 1e3, max(replay) * 1e3],
              "img_per_s": RESNET_BATCH / step_s,
              "bound_ms": compute_s * 1e3,
              "efficiency": compute_s / step_s,
              "cross_entropy_by_step": [s["ce"] for s in steps],
              "data_dtype": steps[0]["dtype"],
              "fit_uploader_stats": fit_stats,
              "traced_steps": len(batches), "traced_wall_s": wall,
              "device_idle_share": idle, "device_events": events,
              "peak_memory_bytes": peak, "graph_captures": captures,
              "graph_replays": replays, "launches": launches}
    if len(steps) != RECORDS_STEPS or not all(
            s["on_card"] and s["uncopied"] and s["int32"] for s in steps):
        raise AssertionError("%s: a batch reached the step off the card, "
                             "copied or with float labels: %s"
                             % (name, steps))
    if (captures, replays) != (1, RECORDS_STEPS - 1):
        raise AssertionError("%s: %d captures and %d replays in %d steps"
                             % (name, captures, replays, RECORDS_STEPS))
    if not all(math.isfinite(s["ce"]) for s in steps):
        raise AssertionError("%s: cross-entropy %s" % (
            name, record["cross_entropy_by_step"]))
    del mod, tr, batches, uploader, staged
    gc.collect()
    torch.cuda.empty_cache()
    return record


class OneBatch(mt.io.DataIter):
    """One batch of frames (host or card) and labels, once an epoch."""

    def __init__(self, frames, labels):
        super().__init__(frames.shape[0])
        self.frames, self.labels, self.done = frames, labels, False
        self.provide_data = [mt.io.DataDesc("data", tuple(frames.shape),
                                            np.uint8)]
        self.provide_label = [mt.io.DataDesc("softmax_label",
                                             tuple(labels.shape))]

    def next(self):
        if self.done:
            raise StopIteration
        self.done = True
        return mt.io.DataBatch([self.frames], [self.labels], pad=0)

    def reset(self):
        self.done = False


def check_augment(cache):
    """The on-card augment on the cached frames of ``cache`` (a
    DeviceCacheIter): with crops and mirrors off, the gather of a
    shuffled batch (DeviceCacheIter) and of a whole batch
    (StreamAugmentIter) against a plain PyTorch crop on the CPU of the
    same uint8 frames, bitwise; with them on, against numpy slicing at
    the offsets and flips the iterators drew."""
    frames = cache._data.cpu()
    labels = cache._label[:RESNET_BATCH].cpu()
    c = (RECORDS_SIDE - RESNET_IMAGE) // 2
    side = RESNET_IMAGE
    checked = {}
    for what, rand in (("off", False), ("on", True)):
        cached = mt.io.DeviceCacheIter(
            OneBatch(frames, torch.arange(len(frames)).float()),
            data_shape=(side, side), rand_crop=rand, rand_mirror=rand,
            shuffle=True, seed=CACHE_SEED, batch_size=RESNET_BATCH)
        stream = mt.io.StreamAugmentIter(
            OneBatch(frames[:RESNET_BATCH], labels),
            data_shape=(side, side), rand_crop=rand, rand_mirror=rand,
            seed=STREAM_SEED)
        for name, it in (("cache", cached), ("stream", stream)):
            b = it.next()
            got = b.data[0].data.cpu()
            rows = b.label[0].data.cpu().long() if name == "cache" \
                else torch.arange(RESNET_BATCH)
            if not rand:
                want = torch.stack([frames[r, c:c + side, c:c + side]
                                    for r in rows.tolist()])
                ok = torch.equal(got, want)
            else:
                oy, ox, flip = (t.cpu().numpy() for t in it.last_draw)
                host = frames.numpy()
                want = np.stack([
                    host[r, y:y + side, x:x + side][:, ::-1] if f
                    else host[r, y:y + side, x:x + side]
                    for r, y, x, f in zip(rows.tolist(), oy, ox, flip)])
                ok = np.array_equal(got.numpy(), want)
                checked["%s_flip_share" % name] = float(flip.mean())
            checked["%s_%s" % (name, what)] = ok
    _emit({"records_augment_check": checked})
    if not all(v for k, v in checked.items() if not k.endswith("share")):
        raise AssertionError("the on-card augment is off: %s" % checked)
    return checked


def train_resnet_records(card, synthetic):
    """ResNet-50 from bench.py's record file through both of its real-data
    pipelines, each trained RECORDS_STEPS steps by ``Module.fit`` with a
    ``dist_sync_tpu`` store; ``synthetic`` is train_resnet_bf16's record,
    whose replay step is the compute bound.  Returns (the launches of
    both pipelines' fits, the phase record)."""
    _phase("train_resnet_records")
    t_phase = time.perf_counter()
    compute_s = synthetic["replay_step_s"]
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "bench.rec")
        t0 = time.perf_counter()
        jpegs = write_records(rec)
        write_s = time.perf_counter() - t0
        loader = check_loader(rec, jpegs)
        decode, h2d_ms, _ = decode_and_h2d(rec)

        t0 = time.perf_counter()
        cache = mt.io.DeviceCacheIter(
            native_loader(rec, RECORDS_SIDE),
            data_shape=(RESNET_IMAGE, RESNET_IMAGE), rand_crop=True,
            rand_mirror=True, shuffle=True, seed=CACHE_SEED)
        torch.cuda.synchronize()
        cache_build_s = time.perf_counter() - t0
        augment = check_augment(cache)
        cached_labels = Int32Labels(mt.io.ResizeIter(cache, RECORDS_STEPS))
        cached = records_fit("cached", cached_labels, compute_s)
        cached.update(cache_build_s=cache_build_s,
                      cache_nbytes=cache.cache_nbytes(),
                      cache_images=cache.num_data,
                      labels_changed_by_bf16_cast=int(cached_labels.changed))
        del cache, cached_labels
        torch.cuda.empty_cache()

        up = mt.io.DeviceUploadIter(
            EndlessIter(native_loader(rec, RESNET_IMAGE, rand_crop=True)),
            depth=STREAM_DEPTH, chunks=STREAM_CHUNKS)
        stream_labels = Int32Labels(mt.io.ResizeIter(
            mt.io.StreamAugmentIter(up, rand_mirror=True, seed=STREAM_SEED),
            RECORDS_STEPS))
        bound_s = max(RESNET_BATCH / decode, h2d_ms / 1e3, compute_s)
        binding = ("decode", "h2d", "compute")[[
            RESNET_BATCH / decode, h2d_ms / 1e3, compute_s].index(bound_s)]
        stream = records_fit("stream", stream_labels, bound_s)
        up._shutdown_worker()
        stream.update(uploader_stats=up.stats(), binding_stage=binding,
                      labels_changed_by_bf16_cast=int(stream_labels.changed))
        del up, stream_labels
    record = {"card": card, "write_s": write_s, "loader": loader,
              "decode_img_per_s": decode, "decode_threads": os.cpu_count(),
              "decode_ms_per_batch": RESNET_BATCH / decode * 1e3,
              "h2d_ms_per_batch": h2d_ms,
              "compute_ms_per_batch": compute_s * 1e3,
              "synthetic_img_per_s": RESNET_BATCH / compute_s,
              "augment_check": augment, "cached": cached, "stream": stream,
              "phase_s": time.perf_counter() - t_phase}
    _emit({"train_resnet_records": record})
    for name in ("cached", "stream"):
        r = record[name]
        print("records %s: %.1f img/s, step %.2f ms (%.2f-%.2f), bound %.2f "
              "ms, efficiency %.3f, idle %.3f, peak %.2f GB"
              % (name, r["img_per_s"], r["step_ms"], *r["step_ms_range"],
                 r["bound_ms"], r["efficiency"], r["device_idle_share"],
                 r["peak_memory_bytes"] / 1e9), flush=True)
    print("records: %s decode %.1f img/s on %d threads, h2d %.3f ms a batch, "
          "phase %.1f s" % (loader["jpeg_route"], decode, os.cpu_count(),
                            h2d_ms, record["phase_s"]), flush=True)
    launches = {k: cached["launches"][k] + stream["launches"][k]
                for k in cached["launches"]}
    return launches, record


# ----------------------------------------------------------------------
# the bucketing LSTM LM: examples/rnn/lstm_bucketing.py's cell
def synthetic_corpus(vocab_size, n, seed):
    """examples/rnn/lstm_bucketing.py:55-66: Markov-ish random sentences
    (each token followed by one of 7) with a bucketable length spread."""
    rng = np.random.RandomState(seed)
    sents = []
    for _ in range(n):
        length = int(rng.choice(LSTM_BUCKETS)) - rng.randint(0, 5)
        state = rng.randint(LSTM_START, vocab_size)
        sent = []
        for _ in range(max(length, 2)):
            state = (state * 31 + rng.randint(0, 7)) % vocab_size
            sent.append(max(state, LSTM_START))
        sents.append(sent)
    return sents


def _rel_max(got, want):
    """The largest error over the reference array's largest magnitude."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def lstm_module(ctx):
    """The example's BucketingModule on ``ctx``, its default bucket the
    longest."""
    with ctx:
        return mt.mod.BucketingModule(
            mt.models.lstm_lm.sym_gen_factory(**LSTM_LM),
            default_bucket_key=max(LSTM_BUCKETS))


def _bind_lstm(mod):
    shape = (LSTM_BATCH, max(LSTM_BUCKETS))
    mod.bind([("data", shape)], [("softmax_label", shape)])
    mt.random.seed(SEED)
    mod.init_params(mt.init.Xavier(**LSTM_INIT))


def lstm_vs_cpu(batches):
    """One float32 forward and backward a bucket through the example's
    BucketingModule on the card and on the port's CPU, from the same
    weights and batch (``batches``: one card batch a bucket): the
    outputs and every parameter gradient by _rel_max, against
    LSTM_CARD_TOL.  Returns {bucket: record}."""
    card, host = lstm_module(mt.gpu()), lstm_module(mt.cpu())
    _bind_lstm(card)
    _bind_lstm(host)
    host.set_params(*card.get_params())
    errors = {}
    for key, batch in sorted(batches.items()):
        on_cpu = mt.io.DataBatch(
            [mt.nd.array(batch.data[0].asnumpy(), ctx=mt.cpu())],
            [mt.nd.array(batch.label[0].asnumpy(), ctx=mt.cpu())], pad=0,
            bucket_key=key, provide_data=batch.provide_data,
            provide_label=batch.provide_label)
        grads = []
        for mod, b in ((card, batch), (host, on_cpu)):
            mod.forward(b, is_train=True)
            mod.backward()
            exe = mod._buckets[key]._exec_group.execs[0]
            grads.append((mod.get_outputs()[0].data,
                          {n: exe.grad_dict[n].data
                           for n in mod._buckets[key]._param_names}))
        (out, g), (ref_out, ref_g) = grads
        by_name = {n: _rel_max(g[n], ref_g[n]) for n in ref_g}
        worst = max(by_name, key=by_name.get)
        errors[key] = {"output": _rel_max(out, ref_out),
                       "grad_max": by_name[worst], "grad_worst": worst}
        print("lstm card vs cpu, bucket %d: output %.3g, worst gradient "
              "%.3g (%s)" % (key, errors[key]["output"], by_name[worst],
                             worst), flush=True)
    bad = {k: e for k, e in errors.items()
           if max(e["output"], e["grad_max"]) > LSTM_CARD_TOL}
    if bad:
        raise AssertionError("lstm buckets off the CPU's step by more "
                             "than %g: %s" % (LSTM_CARD_TOL, bad))
    del card, host
    gc.collect()
    torch.cuda.empty_cache()
    return errors


def rnn_op_vs_cpu():
    """The fused ``RNN`` op (lstm, RNN_OP_SHAPE) forward and backward on
    the card against the CPU from the same inputs, and its card time
    (CUDA events, forward alone and forward with backward)."""
    from mxnet_tpu_torch.op.rnn_op import rnn_param_size
    d = RNN_OP_SHAPE
    op = mt.op.get("RNN")
    params = op.parse_params(dict(state_size=d["H"], num_layers=d["layers"],
                                  mode="lstm"))
    rng = np.random.RandomState(SEED)
    size = rnn_param_size("lstm", d["I"], d["H"], d["layers"], False)
    state = (d["layers"], d["N"], d["H"])
    host = [rng.normal(0, 1, (d["T"], d["N"], d["I"])),
            rng.uniform(-0.1, 0.1, size), rng.normal(0, 0.5, state),
            rng.normal(0, 0.5, state)]
    cot = torch.from_numpy(rng.normal(0, 1, (d["T"], d["N"], d["H"]))
                           .astype(np.float32))
    results, calls = {}, {}
    for dev in ("cuda", "cpu"):
        leaves = [torch.from_numpy(a.astype(np.float32)).to(dev)
                  .requires_grad_() for a in host]
        ctx = mt.op.OpContext(is_train=True, device=torch.device(dev))

        def forward(leaves=leaves, ctx=ctx):
            return op.apply(params, ctx, *leaves)[0][0]

        out = forward()
        results[dev] = [out] + list(torch.autograd.grad(
            out, leaves, cot.to(dev)))
        calls[dev] = (forward, leaves, cot.to(dev))
    errors = [_rel_max(a, b) for a, b in zip(results["cuda"],
                                             results["cpu"])]
    forward, leaves, dcot = calls["cuda"]
    record = {"shape": d, "output_err": errors[0],
              "grad_errs": dict(zip(("data", "parameters", "state",
                                     "state_cell"), errors[1:])),
              "forward_ms": cuda_ms(forward, iters=10),
              "forward_backward_ms": cuda_ms(
                  lambda: torch.autograd.grad(forward(), leaves, dcot),
                  iters=10)}
    print("rnn op (lstm, T %d, N %d, I = H = %d, %d layers) card vs cpu: "
          "output %.3g, gradients %.3g; %.3f ms forward, %.3f ms with "
          "backward" % (d["T"], d["N"], d["H"], d["layers"], errors[0],
                        max(errors[1:]), record["forward_ms"],
                        record["forward_backward_ms"]), flush=True)
    if max(errors) > LSTM_CARD_TOL:
        raise AssertionError("the RNN op is off the CPU's by more than %g: "
                             "%s" % (LSTM_CARD_TOL, record))
    return record


def traced_lstm_steps(mod, batch, n):
    """``n`` training steps of one bucket under ``torch.profiler``: the
    device idle share, and per step the wall ms, device events and
    kernels."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, events = device_idle_share(prof, wall)
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    return {"steps": n, "idle_share": idle, "wall_ms": wall / n * 1e3,
            "device_events": events / n, "kernels": kernels / n}


def lstm_step_parts(mod, batch, n):
    """Median host ms of forward, backward and update over ``n`` steps of
    one bucket, each part ended by a synchronise."""
    parts = {"forward": [], "backward": [], "update": []}
    for _ in range(n):
        for name, call in (("forward", lambda: mod.forward(batch, True)),
                           ("backward", mod.backward),
                           ("update", mod.update)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            parts[name].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def train_lstm_bucketing(card):
    """The bucketing LSTM LM of examples/rnn/lstm_bucketing.py through
    ``BucketingModule.fit`` on the card (the LSTM_* cell): each bucket's
    float32 step against the CPU's, the ``RNN`` op against the CPU's,
    then LSTM_EPOCHS epochs of the synthetic corpus.  Asserts every
    bucket bound and sharing one parameter storage, every batch on the
    card, the loss the module trains (the perplexity over every label,
    padding included) falling from epoch to epoch, none of the port's
    kernels launched.  Prints step ms a bucket, tokens/s, each bucket's
    first-use cost, the memory held with six buckets bound, and the idle
    share and kernels of traced steps.  Returns (launches, record)."""
    _phase("train_lstm_bucketing")
    t_phase = time.perf_counter()
    sents = synthetic_corpus(LSTM_LM["vocab_size"], LSTM_SENTENCES, SEED)
    np.random.seed(SEED)
    it = mt.rnn.BucketSentenceIter(sents, LSTM_BATCH, buckets=LSTM_BUCKETS,
                                   invalid_label=LSTM_INVALID)
    first = {}
    for batch in it:
        first.setdefault(batch.bucket_key, batch)
    it.reset()
    parity = lstm_vs_cpu(first)
    rnn_op = rnn_op_vs_cpu()

    mod = lstm_module(mt.gpu())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold, left out of this cell's memory
    base = torch.cuda.memory_allocated()
    host = {"load_avg": os.getloadavg(), "threads": threading.active_count(),
            "cpus": os.cpu_count()}
    t0 = time.perf_counter()
    _bind_lstm(mod)
    metric = mt.metric.CompositeEvalMetric(
        [mt.metric.Perplexity(LSTM_INVALID), mt.metric.Perplexity(None)])
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=LSTM_SGD)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps, epochs, last = [], {}, {}

    def on_batch(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        batch = param.locals["data_batch"]
        x, y = batch.data[0].data, batch.label[0].data
        steps.append({"bucket": batch.bucket_key, "s": now - last["t"],
                      "on_card": x.is_cuda and y.is_cuda,
                      "padded": x.numel(),
                      "real": int((x != LSTM_INVALID).sum().item())})
        epochs[param.epoch] = dict(zip(("perplexity", "perplexity_all"),
                                       param.eval_metric.get()[1]))
        last["t"] = now

    reset_launch_counts()
    last["t"] = time.perf_counter()
    mod.fit(it, eval_metric=metric, kvstore="device", optimizer="sgd",
            optimizer_params=LSTM_SGD, num_epoch=LSTM_EPOCHS,
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_launches("train_lstm_bucketing", launches)
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    execs = {k: c._exec_group.execs[0] for k, c in mod._buckets.items()}
    shared = all(
        execs[k].arg_dict[n].data.data_ptr()
        == execs[max(LSTM_BUCKETS)].arg_dict[n].data.data_ptr()
        and execs[k].grad_dict[n].data.data_ptr()
        == execs[max(LSTM_BUCKETS)].grad_dict[n].data.data_ptr()
        for k in execs for n in mod._buckets[k]._param_names)

    # a bucket's first use: its bind inside its first step, beyond the
    # bucket's median step (the default bucket binds before fit, in setup)
    by_bucket = {}
    for key in LSTM_BUCKETS:
        mine = [st for st in steps if st["bucket"] == key]
        median = statistics.median(st["s"] for st in mine[1:])
        by_bucket[key] = {
            "steps": len(mine), "step_ms": median * 1e3,
            "first_step_ms": mine[0]["s"] * 1e3,
            "first_use_ms": None if key == max(LSTM_BUCKETS)
            else (mine[0]["s"] - median) * 1e3}
    steady = [st for key in LSTM_BUCKETS
              for st in [x for x in steps if x["bucket"] == key][1:]]
    steady_s = sum(st["s"] for st in steady)
    traced = {"bucket_%d" % max(LSTM_BUCKETS): traced_lstm_steps(
        mod, first[max(LSTM_BUCKETS)], LSTM_TRACED_STEPS)}
    for key in LSTM_BUCKETS[:-1]:
        traced["bucket_%d" % key] = traced_lstm_steps(mod, first[key], 1)
    parts = lstm_step_parts(mod, first[max(LSTM_BUCKETS)], LSTM_TRACED_STEPS)
    record = {"card": card, "cell": dict(LSTM_LM, batch=LSTM_BATCH,
                                         buckets=LSTM_BUCKETS,
                                         sgd=LSTM_SGD,
                                         sentences=LSTM_SENTENCES),
              "parity": parity, "rnn_op": rnn_op, "setup_s": setup_s,
              "steps": len(steps), "by_bucket": by_bucket,
              "padded_tokens_per_s": sum(st["padded"] for st in steady)
              / steady_s,
              "real_tokens_per_s": sum(st["real"] for st in steady)
              / steady_s,
              "epochs": [epochs[e] for e in sorted(epochs)],
              "buckets_bound": sorted(mod._buckets),
              "one_parameter_storage": shared,
              "memory_held_bytes": held, "peak_memory_bytes": peak,
              "memory_before_bytes": base, "host": host,
              "traced": traced, "step_parts_ms": parts,
              "launches": launches,
              "phase_s": time.perf_counter() - t_phase}
    _emit({"train_lstm_bucketing": record})
    for key in LSTM_BUCKETS:
        b = by_bucket[key]
        first_use = "bound in setup (%.1f ms)" % (setup_s * 1e3) \
            if b["first_use_ms"] is None else "%.1f ms" % b["first_use_ms"]
        print("lstm bucket %d: %d steps, step %.2f ms (median after the "
              "first), first use %s, traced: %.0f kernels a step, idle "
              "%.3f" % (key, b["steps"], b["step_ms"], first_use,
                        traced["bucket_%d" % key]["kernels"],
                        traced["bucket_%d" % key]["idle_share"]),
              flush=True)
    print("lstm bucket %d step by part (ms, median of %d): %s"
          % (max(LSTM_BUCKETS), LSTM_TRACED_STEPS,
             {k: round(v, 2) for k, v in parts.items()}), flush=True)
    print("lstm fit: %d steps, %.0f padded / %.0f real tokens/s, "
          "perplexity by epoch %s (every label: %s), six buckets held %.3f "
          "GB, peak %.3f GB (beyond %.3f GB held before), launches %s, "
          "host %s, phase %.1f s"
          % (len(steps), record["padded_tokens_per_s"],
             record["real_tokens_per_s"],
             [round(e["perplexity"], 1) for e in record["epochs"]],
             [round(e["perplexity_all"], 1) for e in record["epochs"]],
             held / 1e9, peak / 1e9, base / 1e9, launches, host,
             record["phase_s"]), flush=True)
    falling = all(b["perplexity_all"] < a["perplexity_all"] for a, b in
                  zip(record["epochs"], record["epochs"][1:]))
    if (record["buckets_bound"] != LSTM_BUCKETS or not shared
            or not all(st["on_card"] for st in steps) or not falling
            or len(record["epochs"]) != LSTM_EPOCHS
            or not all(math.isfinite(v) for e in record["epochs"]
                       for v in e.values())):
        raise AssertionError("train_lstm_bucketing gave %s" % {
            k: record[k] for k in ("buckets_bound", "one_parameter_storage",
                                   "epochs")})
    del mod, execs, it, first
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


# ----------------------------------------------------------------------
# the rest of fit: checkpoints with resume, reshape, the monitor; the
# module family
def _param_fingerprint(params):
    """A bitwise fingerprint of device tensors, by name: the sum of each
    tensor's 32-bit words and their sum weighted by position (int64, in
    one host read)."""
    names = sorted(params)
    sums = []
    for n in names:
        w = params[n].detach().contiguous().view(-1).view(torch.int32)
        w = w.to(torch.int64)
        pos = torch.arange(1, w.numel() + 1, device=w.device,
                           dtype=torch.int64)
        sums.append(torch.stack([w.sum(), (w * pos).sum()]))
    return dict(zip(names, torch.stack(sums).tolist()))


def _params_digest(params):
    """sha256 of every tensor's bytes, in name order, on the host."""
    import hashlib
    h = hashlib.sha256()
    for n in sorted(params):
        h.update(n.encode())
        h.update(params[n].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


class _TimedManager(mt.resilience.CheckpointManager):
    """A CheckpointManager that times its saves and scans."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.save_ms, self.latest_ms, self.bytes, self.crc_ms = \
            [], [], [], []

    def save(self, module, epoch, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck = super().save(module, epoch, **kw)
        self.save_ms.append((time.perf_counter() - t0) * 1e3)
        files = ck.manifest["files"]
        self.bytes.append(sum(f["size"] for f in files.values()))
        t0 = time.perf_counter()
        for name in files:
            mt.resilience._crc32_file(os.path.join(
                os.path.dirname(os.path.abspath(self.prefix)), name))
        self.crc_ms.append((time.perf_counter() - t0) * 1e3)
        return ck

    def latest(self):
        t0 = time.perf_counter()
        ck = super().latest()
        self.latest_ms.append((time.perf_counter() - t0) * 1e3)
        return ck


def resume_child(prefix, mode):
    """One run of train_resume, in a process of its own: the fused
    bfloat16 cell trained by ``Module.fit`` for TRAIN_EPOCHS epochs with a
    checkpoint every epoch (``resume=True`` when ``mode`` is
    ``resumed``).  Prints a ``RESUME_STEP`` line with the parameters'
    fingerprint after each step and a ``RESUME_DONE`` line at the end."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    X, Y = cyclic_tokens(BATCH * TRAIN_BATCHES,
                         np.random.default_rng(SEED + 3), np.int32)
    data = mt.io.NDArrayIter(X, Y, batch_size=BATCH)
    mod = mt.mod.Module(mt.models.transformer.get_symbol(
        **dict(GPT2_SMALL, num_layers=RESUME_LAYERS)),
        context=mt.gpu(), compute_dtype="bfloat16")
    mgr = _TimedManager(prefix, keep=RESUME_KEEP)
    mt.random.seed(SEED)

    def on_batch(param):
        torch.cuda.synchronize()
        tr = mod._trainer
        _emit({"RESUME_STEP": tr.num_update, "wall": time.time(),
               "fingerprint": _param_fingerprint(tr.params)})

    reset_launch_counts()
    mod.fit(data, num_epoch=RESUME_EPOCHS, optimizer="adam",
            optimizer_params={"learning_rate": TRAIN_LR},
            initializer=mt.init.Xavier(**TRAIN_INIT),
            eval_metric=mt.metric.Perplexity(None), checkpoint=mgr,
            checkpoint_period=1, resume=mode == "resumed",
            batch_end_callback=on_batch)
    tr = mod._trainer
    _emit({"RESUME_DONE": mode, "launches": launch_counts(),
           "digest": _params_digest(tr.params),
           "graph_captures": tr.graph_captures,
           "graph_replays": tr.graph_replays, "save_ms": mgr.save_ms,
           "bytes": mgr.bytes, "crc_ms": mgr.crc_ms,
           "latest_ms": mgr.latest_ms})


def _start_resume_child(prefix, mode, fault=None):
    """Start a resume_child run: (the process, its start time)."""
    env = dict(os.environ)
    env.pop("MXTPU_FAULTS", None)
    if fault:
        env["MXTPU_FAULTS"] = fault
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "resume_child", prefix,
         mode], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, t0


def _finish_resume_child(proc, t0):
    """Wait for a resume_child run: (exit code, its steps by update
    count, its RESUME_DONE record or None, seconds from start to its
    first step, the output's tail)."""
    try:
        out, err = proc.communicate(timeout=RESUME_CHILD_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    steps, done = {}, None
    for line in out.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if "RESUME_STEP" in rec:
            steps[rec["RESUME_STEP"]] = rec
        elif "RESUME_DONE" in rec:
            done = rec
    first = min(steps.values(), key=lambda r: r["RESUME_STEP"])["wall"] \
        if steps else None
    return proc.returncode, steps, done, \
        None if first is None else first - t0, (out[-2000:], err[-4000:])


def train_resume(card):
    """Crash-consistent checkpoints with resume on the fused bfloat16
    cell: an uninterrupted run and a run killed inside its second save
    (RESUME_FAULT: exit 137, a ``.tmp`` left), side by side, then that
    run restarted with ``resume=True``, each a process of its own.  Asserts the kill,
    the ``.tmp`` swept by the restart, the restarted run's parameters
    bitwise the uninterrupted run's after every step (naming the first
    that differs) and at the end, and K1-bf16 and B2-bf16 launched on the
    restarted run.  Prints save ms, bytes a checkpoint, CRC ms, the
    ``latest()`` scan ms and the time from the restart to its first
    step.  Returns (the restarted run's launches, record)."""
    import shutil
    _phase("train_resume")
    t_phase = time.perf_counter()
    symbol = mt.models.transformer.get_symbol(
        **dict(GPT2_SMALL, num_layers=RESUME_LAYERS))
    shapes, _, _ = symbol.infer_shape(
        data=(BATCH, GPT2_SMALL["seq_len"]),
        softmax_label=(BATCH, GPT2_SMALL["seq_len"]))
    n_params = sum(int(np.prod(shape)) for name, shape in
                   zip(symbol.list_arguments(), shapes)
                   if name not in ("data", "softmax_label"))
    # params, Adam's m and v, float32; RESUME_KEEP saves and one more
    # before the prune, and a torn save's .tmp; two runs at once
    need = 2 * 12 * n_params * (RESUME_KEEP + 2)
    tmp = tempfile.mkdtemp(prefix="mxtpu_resume_")
    try:
        free = shutil.disk_usage(tmp).free
        _emit({"train_resume_disk": tmp, "free_bytes": free,
               "need_bytes": need, "params": n_params})
        if free < need:
            raise AssertionError("train_resume needs %d bytes free in %s, "
                                 "has %d" % (need, tmp, free))
        # the uninterrupted and the killed run side by side on the card
        # (each process's own fixed-shape steps; they share nothing),
        # then the restart
        full_dir = os.path.join(tmp, "full")
        os.makedirs(full_dir)
        prefix = os.path.join(tmp, "run", "ckpt")
        os.makedirs(os.path.dirname(prefix))
        started = {"full": _start_resume_child(
            os.path.join(full_dir, "ckpt"), "full"),
            "killed": _start_resume_child(prefix, "killed", RESUME_FAULT)}
        runs = {mode: _finish_resume_child(*started[mode])
                for mode in ("full", "killed")}
        shutil.rmtree(full_dir)
        leaked = sorted(n for n in os.listdir(os.path.dirname(prefix))
                        if n.endswith(".tmp"))
        runs["resumed"] = _finish_resume_child(
            *_start_resume_child(prefix, "resumed"))
        left = sorted(n for n in os.listdir(os.path.dirname(prefix))
                      if n.endswith(".tmp"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for mode, want_rc in (("full", 0), ("killed", 137), ("resumed", 0)):
        rc, _, done, _, tail = runs[mode]
        if rc != want_rc or (done is None) != (mode == "killed"):
            raise AssertionError("train_resume's %s run exited %d (want "
                                 "%d): %s" % (mode, rc, want_rc, tail))
    full, killed, resumed = (runs[m][1] for m in ("full", "killed",
                                                   "resumed"))
    n_steps = RESUME_EPOCHS * TRAIN_BATCHES
    if sorted(full) != list(range(1, n_steps + 1)):
        raise AssertionError("the uninterrupted run took steps %s"
                             % sorted(full))
    first_diff = None
    for step in sorted(set(killed) | set(resumed)):
        got = (resumed.get(step) or killed[step])["fingerprint"]
        if got != full[step]["fingerprint"]:
            first_diff = step
            break
    resumed_from = min(resumed)
    done_full, done = runs["full"][2], runs["resumed"][2]
    counts = done["launches"]
    record = {
        "train_resume": "gpt2-small fused bfloat16, %d layers, %d epochs"
        % (RESUME_LAYERS, RESUME_EPOCHS), "params": n_params,
        "fault": RESUME_FAULT, "killed_steps": sorted(killed),
        "resumed_steps": sorted(resumed), "leaked_tmp": leaked,
        "tmp_after_restart": left, "first_differing_step": first_diff,
        "final_digest_equal": done["digest"] == done_full["digest"],
        "save_ms": done_full["save_ms"], "bytes_per_checkpoint":
        done_full["bytes"], "crc_ms": done_full["crc_ms"],
        "latest_ms": done["latest_ms"],
        "restart_to_first_step_s": runs["resumed"][3],
        "fresh_start_to_first_step_s": runs["full"][3],
        "graph_captures": done["graph_captures"],
        "graph_replays": done["graph_replays"], "launches": counts,
        "launches_uninterrupted": done_full["launches"],
        "phase_s": time.perf_counter() - t_phase, "card": card}
    _emit(record)
    print("train_resume: killed after step %d (exit 137, %s left), resumed "
          "from step %d, first differing step %s, final digest equal %s; "
          "save %s ms, %s bytes, CRC %s ms, latest() %s ms, restart to "
          "first step %.1f s" % (max(killed), leaked, resumed_from - 1,
                                 first_diff, record["final_digest_equal"],
                                 [round(x) for x in record["save_ms"]],
                                 record["bytes_per_checkpoint"][0],
                                 [round(x) for x in record["crc_ms"]],
                                 [round(x, 1) for x in record["latest_ms"]],
                                 record["restart_to_first_step_s"]),
          flush=True)
    k1, b2 = K1_SOURCES[torch.bfloat16], B2_SOURCES[torch.bfloat16]
    layers = RESUME_LAYERS
    if not leaked or left or resumed_from != TRAIN_BATCHES + 1 \
            or sorted(resumed) != list(range(resumed_from, n_steps + 1)) \
            or first_diff is not None or not record["final_digest_equal"]:
        raise AssertionError("train_resume gave %s" % record)
    # the restarted run: its eager first step and the capture of its
    # second, as the uninterrupted run's
    expect_launches("train_resume", counts, **{k1: 2 * layers,
                                               b2: 2 * layers})
    return counts, record


def _fused_step(mod, x, y):
    """One fused step of the module on the card batch ``(x, y)``."""
    mod.forward(mt.io.DataBatch([mt.nd.array(x)], [mt.nd.array(y)]),
                is_train=True)
    mod.update()


def _fresh_bf16_module(batch, arg, blob, rescale):
    """The fused bfloat16 GPT-2 module bound at ``batch``, with the given
    parameters and optimizer-state blob."""
    mod = mt.mod.Module(mt.models.transformer.get_symbol(**GPT2_SMALL),
                        context=mt.gpu(), compute_dtype="bfloat16")
    t = GPT2_SMALL["seq_len"]
    mod.bind([("data", (batch, t))], [("softmax_label", (batch, t))])
    mod.init_params(arg_params=arg)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": TRAIN_LR,
                                         "rescale_grad": rescale})
    mod._trainer.set_opt_states(blob)
    return mod


def train_reshape(card):
    """``Module.reshape`` on the fused bfloat16 cell: RESHAPE_STEPS steps
    at each of RESHAPE_BATCHES in turn.  Each step after a reshape must be
    bitwise the step of a fresh module bound at that shape with the same
    parameters and optimizer state; one capture a shape (the return to a
    shape replays its graph).  Prints the captures, the capture ms and
    the memory the second shape's graph holds.  Returns (launches,
    record)."""
    _phase("train_reshape")
    t_phase = time.perf_counter()
    t = GPT2_SMALL["seq_len"]
    mod, _, X, Y, _ = gpt2_train_cell(True, "bfloat16")
    tr = mod._trainer
    rescale = 1.0 / BATCH
    start = {}          # the state each shape's first step starts from
    snaps, steps = [], []
    reset_launch_counts()
    row = 0
    for batch, n in zip(RESHAPE_BATCHES, RESHAPE_STEPS):
        if steps:
            arg, _ = mod.get_params()
            start[len(steps)] = (batch, {k: v.copy() for k, v in
                                         arg.items()}, tr.get_opt_states())
            mod.reshape([("data", (batch, t))],
                        [("softmax_label", (batch, t))])
        for _ in range(n):
            rows = np.arange(row, row + batch) % len(X)
            x, y = X[rows], Y[rows]
            row += batch
            captures = tr.graph_captures
            torch.cuda.synchronize()
            alloc, reserved = (torch.cuda.memory_allocated(),
                               torch.cuda.memory_reserved())
            t0 = time.perf_counter()
            _fused_step(mod, x, y)
            torch.cuda.synchronize()
            steps.append({"batch": batch, "x": x, "y": y,
                          "ms": (time.perf_counter() - t0) * 1e3,
                          "captured": tr.graph_captures > captures,
                          "allocated_delta": torch.cuda.memory_allocated()
                          - alloc, "reserved_delta":
                          torch.cuda.memory_reserved() - reserved})
            snaps.append({n_: v.clone() for n_, v in tr.params.items()})
    counts = launch_counts()
    captures, replays = tr.graph_captures, tr.graph_replays
    del mod, tr
    gc.collect()
    torch.cuda.empty_cache()
    # the fresh modules, each from the state its shape's first step
    # started from (their launches are not the path's)
    equal, fresh_steps = [], 0
    for i, (batch, arg, blob) in sorted(start.items()):
        fresh = _fresh_bf16_module(batch, arg, blob, rescale)
        j = i
        while j < len(steps) and steps[j]["batch"] == batch and \
                (j == i or j not in start):
            _fused_step(fresh, steps[j]["x"], steps[j]["y"])
            same = all(torch.equal(fresh._trainer.params[n], v)
                       for n, v in snaps[j].items())
            equal.append({"step": j + 1, "batch": batch, "bitwise": same})
            fresh_steps += 1
            j += 1
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
    second = next((s for s in steps if s["captured"] and s["batch"] !=
                   RESHAPE_BATCHES[0]), {"allocated_delta": 0,
                                         "reserved_delta": 0})
    record = {"train_reshape": "gpt2-small fused bfloat16",
              "batches": RESHAPE_BATCHES, "steps_each": RESHAPE_STEPS,
              "graph_captures": captures, "graph_replays": replays,
              "step_ms": [s["ms"] for s in steps],
              "captured": [s["captured"] for s in steps],
              "capture_ms": [s["ms"] for s in steps if s["captured"]],
              "second_graph_allocated_bytes": second["allocated_delta"],
              "second_graph_reserved_bytes": second["reserved_delta"],
              "post_reshape_vs_fresh": equal, "launches": counts,
              "phase_s": time.perf_counter() - t_phase, "card": card}
    _emit(record)
    print("train_reshape: batches %s, captures %d, capture ms %s, second "
          "graph %.3f GB allocated / %.3f GB reserved, post-reshape steps "
          "bitwise %s" % (
              [s["batch"] for s in steps], captures,
              [round(x, 1) for x in record["capture_ms"]],
              second["allocated_delta"] / 1e9,
              second["reserved_delta"] / 1e9,
              [e["bitwise"] for e in equal]), flush=True)
    shapes = len(set(RESHAPE_BATCHES))
    if captures != shapes or not equal or not all(
            e["bitwise"] for e in equal) or \
            fresh_steps != sum(RESHAPE_STEPS[1:]):
        raise AssertionError("train_reshape gave %s" % {
            k: record[k] for k in ("graph_captures", "captured",
                                   "post_reshape_vs_fresh")})
    k1, b2 = K1_SOURCES[torch.bfloat16], B2_SOURCES[torch.bfloat16]
    layers = GPT2_SMALL["num_layers"]
    # a new shape's eager step and capture; a shape seen before replays
    expect_launches("train_reshape", counts, **{k1: 2 * shapes * layers,
                                                b2: 2 * shapes * layers})
    return counts, record


class _StatMonitor(mt.monitor.Monitor):
    """A Monitor that keeps its rows, each statistic as a float."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rows = []

    @staticmethod
    def _render(stat):
        return float(stat.asnumpy().reshape(-1)[0])

    def toc(self):
        rows = super().toc()
        self.rows.append(rows)
        return rows


def monitor_vs_cpu():
    """The monitor's statistics of one float32 training forward of GPT-2
    small's widths (CPU_LAYERS deep, random weights) on the card against
    the port's CPU run of the same step: the same rows, each statistic
    within MONITOR_TOL of its magnitude; returns the largest error."""
    t = GPT2_SMALL["seq_len"]
    symbol = mt.models.transformer.get_symbol(
        **dict(GPT2_SMALL, num_layers=CPU_LAYERS))
    shapes, _, _ = symbol.infer_shape(data=(BATCH, t),
                                      softmax_label=(BATCH, t))
    params = _random_params(symbol, shapes, np.random.default_rng(SEED + 5))
    x, y = cyclic_tokens(BATCH, np.random.default_rng(SEED + 6))
    req = {n: "write" if n in params else "null"
           for n in symbol.list_arguments()}
    rows = []
    for ctx in (mt.gpu(), mt.cpu()):
        exe = symbol.simple_bind(ctx, grad_req=req, data=(BATCH, t),
                                 softmax_label=(BATCH, t))
        exe.copy_params_from({n: mt.nd.NDArray(v) for n, v in params.items()})
        mon = _StatMonitor(1, pattern=".*")
        mon.install(exe)
        mon.tic()
        exe.forward(is_train=True, data=x, softmax_label=y)
        exe.backward()
        rows.append(mon.toc())
        del exe
    card_rows, cpu_rows = rows
    if [r[1] for r in card_rows] != [r[1] for r in cpu_rows]:
        raise AssertionError("the monitor's rows differ between the card "
                             "and the CPU")
    err = {name: abs(a - b) / max(abs(b), 1e-30)
           for (_, name, a), (_, _, b) in zip(card_rows, cpu_rows)}
    worst = max(err, key=err.get)
    _emit({"monitor_vs_cpu": "gpt2-small widths", "layers": CPU_LAYERS,
           "rows": len(card_rows), "stat_rel_err_max": err[worst],
           "worst": worst, "tolerance": MONITOR_TOL})
    if not all(math.isfinite(e) and e <= MONITOR_TOL for e in err.values()):
        raise AssertionError("monitor statistics on the card and the CPU "
                             "differ: %s %g" % (worst, err[worst]))
    return err[worst], len(card_rows)


def train_monitor(card):
    """``Monitor(1, pattern=".*")`` on the classic float32 cell: MONITOR_STEPS
    steps of a monitored module and of an unmonitored one from the same
    weights, their outputs and every gradient bitwise equal after each
    step; then the statistics against the CPU (``monitor_vs_cpu``).
    Prints rows a step and the step ms with and without the tap.
    Returns (launches, record)."""
    _phase("train_monitor")
    t_phase = time.perf_counter()
    watched, _, X, Y, _ = gpt2_train_cell(False)
    plain, _, _, _, _ = gpt2_train_cell(False)
    mon = _StatMonitor(1, pattern=".*")
    watched.install_monitor(mon)
    counts = {k: 0 for k in launch_counts()}
    steps = []
    for i in range(MONITOR_STEPS):
        batch = mt.io.DataBatch([mt.nd.array(X[i * BATCH:(i + 1) * BATCH])],
                                [mt.nd.array(Y[i * BATCH:(i + 1) * BATCH])])
        rec, outs = {}, []
        for name, mod in (("monitored", watched), ("plain", plain)):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mod is watched:
                mon.tic()
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            rec[name + "_ms"] = (time.perf_counter() - t0) * 1e3
            if mod is watched:
                for k, v in launch_counts().items():
                    counts[k] += v
                t0 = time.perf_counter()
                mon.toc()
                rec["toc_ms"] = (time.perf_counter() - t0) * 1e3
            exe = mod._exec_group.execs[0]
            outs.append([o.data for o in mod.get_outputs()] +
                        [exe.grad_dict[n].data for n in sorted(
                            exe.grad_dict)])
        rec["bitwise"] = all(torch.equal(a, b) for a, b in zip(*outs))
        rec["rows"] = len(mon.rows[-1])
        steps.append(rec)
        del outs
    err, cpu_rows = monitor_vs_cpu()
    record = {"train_monitor": "gpt2-small classic float32",
              "steps": steps, "rows_per_step": [s["rows"] for s in steps],
              "stat_rel_err_max_vs_cpu": err, "cpu_rows": cpu_rows,
              "launches": counts, "phase_s": time.perf_counter() - t_phase,
              "card": card}
    _emit(record)
    print("train_monitor: rows a step %s, step ms monitored %s / plain %s, "
          "toc ms %s, bitwise %s, statistics vs CPU %.3g" % (
              record["rows_per_step"],
              [round(s["monitored_ms"], 1) for s in steps],
              [round(s["plain_ms"], 1) for s in steps],
              [round(s["toc_ms"], 1) for s in steps],
              [s["bitwise"] for s in steps], err), flush=True)
    names = {name for _, name, _ in mon.rows[-1]}
    if not all(s["bitwise"] for s in steps) or not all(
            s["rows"] for s in steps) or "softmax_output" not in names:
        raise AssertionError("train_monitor gave %s" % steps)
    layers = GPT2_SMALL["num_layers"]
    expect_launches("train_monitor", counts, **{
        K1_SOURCES[torch.float32]: MONITOR_STEPS * layers,
        B2_SOURCES[torch.float32]: MONITOR_STEPS * layers})
    del watched, plain
    gc.collect()
    torch.cuda.empty_cache()
    return counts, record


def _hinge_grad(scores, labels):
    """examples/module/python_loss.py's multi-class hinge gradient, in
    numpy."""
    s = scores.asnumpy()
    y = labels.asnumpy().astype(int)
    n = s.shape[0]
    margin = 1.0 + s - s[np.arange(n), y][:, None]
    margin[np.arange(n), y] = 0.0
    pred = margin.argmax(1)
    grad = np.zeros_like(s)
    viol = margin[np.arange(n), pred] > 0
    grad[viol, y[viol]] -= 1.0
    grad[viol, pred[viol]] += 1.0
    return grad / n


def python_loss_run(ctx):
    """examples/module/python_loss.py on ``ctx``: a SequentialModule of
    the MLP and a PythonLossModule, trained by ``fit``; returns (the
    parameters on the host, train accuracy by epoch, scored accuracy)."""
    rng = np.random.RandomState(0)
    protos = rng.normal(0, 1, (10, 64))
    y = rng.randint(0, 10, 2000)
    x = (protos[y] + rng.normal(0, 0.6, (2000, 64))).astype("f")
    mt.random.seed(SEED)
    with mt.Context(ctx):
        it = mt.io.NDArrayIter(x, y.astype("f"), 100, shuffle=True)
        data = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(data, name="fc1", num_hidden=64)
        net = mt.sym.Activation(net, name="relu1", act_type="relu")
        scores = mt.sym.FullyConnected(net, name="fc2", num_hidden=10)
        mlp = mt.mod.Module(scores, label_names=(), context=ctx)
        loss = mt.mod.PythonLossModule(grad_func=_hinge_grad)
        mod = mt.mod.SequentialModule().add(mlp).add(
            loss, take_labels=True, auto_wiring=True)
        accs = []
        mod.fit(it, num_epoch=8, optimizer="sgd",
                optimizer_params={"learning_rate": 0.2, "momentum": 0.9},
                initializer=mt.init.Xavier(), eval_metric="acc",
                batch_end_callback=[
                    mt.callback.Speedometer(100, 10),
                    lambda p: p.nbatch == 19 and accs.append(
                        p.eval_metric.get()[1])])
        it.reset()
        acc = mod.score(it, "acc")[0][1]
    assert mlp._exec_group is not None, "the chain's module fused"
    arg, _ = mod.get_params()
    return {n: v.data.cpu() for n, v in arg.items()}, accs, acc, \
        loss.get_input_grads()[0].context


def mnist_mlp_run(ctx):
    """examples/module/mnist_mlp.py's MLP and data through
    ``FeedForward.create`` on ``ctx`` (on the card, the fused path);
    returns (the parameters on the host, train accuracy by epoch,
    validation predictions, validation accuracy)."""
    protos = np.random.RandomState(42).normal(0, 1, (10, 784))

    def digits(n, seed):
        rng = np.random.RandomState(seed)
        y = rng.randint(0, 10, n)
        return (protos[y] + rng.normal(0, 0.8, (n, 784))).astype("f"), \
            y.astype("f")

    xt, yt = digits(2000, 0)
    xv, yv = digits(500, 1)
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, name="fc1", num_hidden=128)
    net = mt.sym.Activation(net, name="relu1", act_type="relu")
    net = mt.sym.FullyConnected(net, name="fc2", num_hidden=64)
    net = mt.sym.Activation(net, name="relu2", act_type="relu")
    net = mt.sym.FullyConnected(net, name="fc3", num_hidden=10)
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    mt.random.seed(SEED)
    accs = []
    model = mt.model.FeedForward.create(
        net, xt, yt, ctx=ctx, num_epoch=5, optimizer="sgd",
        initializer=mt.init.Xavier(), numpy_batch_size=100,
        learning_rate=0.1, momentum=0.9,
        batch_end_callback=lambda p: p.nbatch == 19 and accs.append(
            p.eval_metric.get()[1]))
    pred = model.predict(xv)
    fused = model._module._trainer is not None
    return ({n: v.data.cpu() for n, v in model.arg_params.items()}, accs,
            pred, float((pred.argmax(1) == yv).mean()), fused)


def _family_errors(card_params, cpu_params):
    rel = {n: ((card_params[n] - w).norm() / w.norm()).item()
           for n, w in cpu_params.items()}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def module_family(card):
    """The module family at the examples' own sizes and settings, on the
    card and on the port's CPU: python_loss.py's SequentialModule and
    PythonLossModule (the loss's numpy gradient back on the card), and
    mnist_mlp.py's MLP through ``FeedForward.create`` (the fused path on
    the card, ``MXTPU_MODULE_FUSED=always`` on the CPU).  Asserts every
    parameter within FAMILY_TOL of the CPU's, train accuracy rising and
    the examples' bars.  Returns (launches, record)."""
    _phase("module_family")
    t_phase = time.perf_counter()
    reset_launch_counts()
    t0 = time.perf_counter()
    card_loss = python_loss_run(mt.gpu())
    loss_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_mlp = mnist_mlp_run(mt.gpu())
    mlp_s = time.perf_counter() - t0
    counts = launch_counts()
    cpu_loss = python_loss_run(mt.cpu())
    with _fused_policy("always"):
        cpu_mlp = mnist_mlp_run(mt.cpu())
    loss_err, loss_worst = _family_errors(card_loss[0], cpu_loss[0])
    mlp_err, mlp_worst = _family_errors(card_mlp[0], cpu_mlp[0])
    pred_err = float(np.abs(card_mlp[2] - cpu_mlp[2]).max())
    record = {
        "module_family": "python_loss + mnist_mlp", "card": card,
        "python_loss": {"train_acc_by_epoch": card_loss[1],
                        "score_acc": card_loss[2],
                        "cpu_train_acc_by_epoch": cpu_loss[1],
                        "param_rel_err_max": loss_err, "worst": loss_worst,
                        "grad_context": str(card_loss[3]), "s": loss_s},
        "mnist_mlp_feedforward": {
            "train_acc_by_epoch": card_mlp[1], "val_acc": card_mlp[3],
            "cpu_train_acc_by_epoch": cpu_mlp[1], "fused": card_mlp[4],
            "param_rel_err_max": mlp_err, "worst": mlp_worst,
            "val_prob_max_abs_err": pred_err, "s": mlp_s},
        "tolerance": FAMILY_TOL, "launches": counts,
        "phase_s": time.perf_counter() - t_phase}
    _emit(record)
    print("module_family: python_loss acc %s -> score %.3f, params %.3g "
          "from the CPU; mnist_mlp FeedForward acc %s, val %.3f, params "
          "%.3g from the CPU" % (
              [round(a, 3) for a in card_loss[1]], card_loss[2], loss_err,
              [round(a, 3) for a in card_mlp[1]], card_mlp[3], mlp_err),
          flush=True)
    rising = all(a[-1] > a[0] for a in (card_loss[1], card_mlp[1]))
    if not (rising and card_loss[2] > 0.9 and card_mlp[1][-1] > 0.9
            and card_mlp[3] > 0.85 and card_mlp[4]
            and card_loss[3] == mt.gpu() and loss_err <= FAMILY_TOL
            and mlp_err <= FAMILY_TOL):
        raise AssertionError("module_family gave %s" % record)
    expect_launches("module_family", counts)
    return counts, record


# ----------------------------------------------------------------------
# train_zoo: the image-classification zoo through fit.py's harness
def _no_dropout(symbol):
    """``symbol`` with every Dropout at p = 0 (through its JSON): the
    card's and the CPU's generators draw other masks."""
    graph = json.loads(symbol.tojson())
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node["attrs"]["p"] = "0.0"
    return mt.sym.load_json(json.dumps(graph))


def _head(symbol):
    """The classifier's weight: the FullyConnected weight of
    ZOO_CLASSES rows."""
    args, _, _ = symbol.infer_shape(data=(1, 3, 299, 299))
    return [n for n, s in zip(symbol.list_arguments(), args)
            if n.endswith("_weight") and len(s) == 2
            and s[0] == ZOO_CLASSES][0]


def zoo_params_and_batch(symbol, batch, image):
    """Random weights and one batch, numpy from SEED: He-normal weights
    (the classifier's at 1e-2 of it, so the softmax is not saturated),
    gamma 1, beta and biases 0, moving statistics 0 and 1, N(0, 1)
    images and labels in [0, classes)."""
    rng = np.random.default_rng(SEED)
    shape = (batch, 3, image, image)
    args, _, auxs = symbol.infer_shape(data=shape, softmax_label=(batch,))
    head = _head(symbol)
    arg = {}
    for n, s in zip(symbol.list_arguments(), args):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            arg[n] = np.ones(s, np.float32)
        elif n.endswith(("_beta", "_bias")):
            arg[n] = np.zeros(s, np.float32)
        else:
            scale = np.sqrt(2.0 / np.prod(s[1:])) * (1e-2 if n == head else 1)
            arg[n] = (rng.standard_normal(s, dtype=np.float32)
                      * scale).astype(np.float32)
    aux = {n: (np.ones(s, np.float32) if n.endswith("_var")
               else np.zeros(s, np.float32))
           for n, s in zip(symbol.list_auxiliary_states(), auxs)}
    x = rng.standard_normal(shape, dtype=np.float32)
    y = rng.integers(0, ZOO_CLASSES, batch).astype(np.float32)
    return arg, aux, x, y


def zoo_step_vs_cpu(network, image, optimizer, params):
    """One fused float32 step of ``network`` (Dropout at p = 0, TF32 off)
    at ZOO_CHECK_BATCH on the card and on the port's CPU, from the same
    random weights, with the network's optimizer: every gradient, the
    step's output, the moving statistics and the parameters after the
    step, as relative norms."""
    symbol = _no_dropout(mt.models.get_symbol(network,
                                              num_classes=ZOO_CLASSES))
    b = ZOO_CHECK_BATCH
    arg, aux, x, y = zoo_params_and_batch(symbol, b, image)
    batch = {"data": x, "softmax_label": y}
    runs, secs = {}, {}
    for side, ctx in (("card", mt.gpu()), ("cpu", mt.cpu())):
        t0 = time.perf_counter()
        with ctx:
            tr = mt.parallel.Trainer(symbol, mt.optimizer.create(
                optimizer, rescale_grad=1.0 / b, **params))
        tr.bind({"data": x.shape}, {"softmax_label": y.shape})
        tr.init_params(
            arg_params={n: torch.from_numpy(v) for n, v in arg.items()},
            aux_params={n: torch.from_numpy(v) for n, v in aux.items()})
        _, _, grads = tr._run_backward(tr.params, tr.aux,
                                       tr._device_batch(batch), None)
        out = tr.step(batch)[0].data
        runs[side] = ({n: g.cpu() for n, g in grads.items()},
                      {"step_output": out.cpu()},
                      {n: v.cpu() for n, v in tr.aux.items()},
                      {n: v.cpu() for n, v in tr.params.items()})
        secs[side] = time.perf_counter() - t0
        del tr, grads, out
    (cg, co, cm, cp), (hg, ho, hm, hp) = runs["card"], runs["cpu"]
    grad = _rel_norms(cg, hg)
    worst = max(grad, key=grad.get)
    weights = {n: e for n, e in grad.items() if n.endswith("_weight")}
    worst_w = max(weights, key=weights.get)
    head = _head(symbol)
    moving = _rel_norms(cm, hm) if hm else {"none": 0.0}
    stepped = _rel_norms(cp, hp)
    held = {"step_output": _rel_norms(co, ho)["step_output"],
            head + "_grad": grad[head],
            "moving": max(moving.values())}
    record = {"network": network, "batch": b, "image": image,
              "optimizer": optimizer, "held_to_tolerance": held,
              "grad_rel_err_median": statistics.median(grad.values()),
              "grad_rel_err_max": grad[worst], "worst_grad": worst,
              "weight_grad_rel_err_max": weights[worst_w],
              "worst_weight_grad": worst_w,
              "params_after_step_rel_err_max": max(stepped.values()),
              "params_after_step_rel_err_median":
                  statistics.median(stepped.values()),
              "finite": all(bool(torch.isfinite(v).all()) for v in
                            list(cg.values()) + list(co.values())),
              "seconds": secs}
    torch.cuda.empty_cache()
    ok = record["finite"] and all(math.isfinite(e) and e <= ZOO_TOL
                                  for e in held.values()) \
        and record["grad_rel_err_median"] <= ZOO_GRAD_MEDIAN_TOL \
        and record["weight_grad_rel_err_max"] <= ZOO_GRAD_MAX_TOL
    return record, ok


def zoo_fit(network, image, optimizer, params):
    """``Module.fit`` of ``network`` at full width on the card: bfloat16
    compute, ZOO_BATCH images of ``image``^2, ZOO_STEPS steps of one
    repeated batch, fit.py's scheduler, initializer, metrics and store.
    Returns its record."""
    rng = np.random.default_rng(SEED)
    shape = (ZOO_BATCH, 3, image, image)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) \
        .cuda()
    y = torch.from_numpy(rng.integers(0, ZOO_CLASSES, ZOO_BATCH)
                         .astype(np.int32)).cuda()
    data = mt.io.NDArrayIter(
        mt.nd.NDArray(x.repeat(ZOO_STEPS, 1, 1, 1)),
        mt.nd.NDArray(y.repeat(ZOO_STEPS)), batch_size=ZOO_BATCH)
    symbol = mt.models.get_symbol(network, num_classes=ZOO_CLASSES)
    mod = mt.mod.Module(symbol, context=mt.gpu(), compute_dtype="bfloat16")
    metric = mt.metric.create(["accuracy", mt.metric.create(
        "top_k_accuracy", top_k=5)])
    sched = mt.lr_scheduler.MultiFactorScheduler(step=[ZOO_LR_STEP],
                                                 factor=0.1)
    steps, last = [], {}

    def on_batch(param):
        """Synchronise; the step's time, its lr and the cross-entropy of
        the batch's outputs (the step's forward)."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        probs = param.locals["self"].get_outputs()[0].data
        label = param.locals["data_batch"].label[0].data.long()
        ce = -probs.gather(1, label[:, None]).clamp(min=1e-30).log().mean()
        steps.append({"s": now - last["t"], "ce": float(ce),
                      "lr": param.locals["self"]._trainer._lr_cache})
        last["t"] = time.perf_counter()

    mt.random.seed(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = last["t"] = time.perf_counter()
    mod.fit(data, num_epoch=1, kvstore="device", optimizer=optimizer,
            optimizer_params=dict(params, lr_scheduler=sched),
            initializer=mt.init.Xavier(**ZOO_INIT), eval_metric=metric,
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    tr = mod._trainer
    if tr is None:
        raise AssertionError("%s took the classic path" % network)
    replay_s = statistics.median(s["s"] for s in steps[2:])
    names, values = metric.get()
    record = {
        "network": network, "batch": ZOO_BATCH, "image": image,
        "compute_dtype": "bfloat16", "optimizer": optimizer,
        "optimizer_params": params, "steps": len(steps),
        "first_step_s": steps[0]["s"], "capture_step_s": steps[1]["s"],
        "replay_step_s": replay_s, "step_ms": replay_s * 1e3,
        "img_per_s": ZOO_BATCH / replay_s,
        "step_s_runs": [s["s"] for s in steps],
        "lr_by_step": [s["lr"] for s in steps],
        "lr_in_graph": float(tr._lr),
        "cross_entropy_by_step": [s["ce"] for s in steps],
        "loss_fell": steps[-1]["ce"] < steps[0]["ce"],
        "metrics": dict(zip(names, values)),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "graph_captures": tr.graph_captures,
        "graph_replays": tr.graph_replays, "launches": launches,
        "fit_s": fit_s}
    del mod, tr, data, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return record


def train_zoo(card):
    """The image-classification zoo on the card: for each network of ZOO,
    ``Module.fit`` at full width (zoo_fit) and one float32 step against
    the port's CPU (zoo_step_vs_cpu).  Asserts the fused path, one
    capture and a replay a step after it, the scheduler's lr change read
    by the captured graph, a falling loss, finite metrics, none of the
    port's kernels launched, and each float32 step within its
    tolerances.  Prints step ms, img/s, capture ms and peak memory a
    network.  Returns (launches, records)."""
    _phase("train_zoo")
    t_phase = time.perf_counter()
    total = {}
    records = []
    for network, image, optimizer, params in ZOO:
        fit = zoo_fit(network, image, optimizer, params)
        check, ok = zoo_step_vs_cpu(network, image, optimizer, params)
        fit["vs_cpu"] = check
        fit["card"] = card
        _emit({"train_zoo": fit})
        print("train_zoo %s (%s, %s): step %.2f ms, %.1f img/s, capture "
              "step %.0f ms, peak %.2f GB, loss %.3f -> %.3f, K1/B2/K2 "
              "launches %s; float32 step vs CPU %s (grad median %.2e, max "
              "%.2e)" % (
                  network, optimizer, card, fit["step_ms"], fit["img_per_s"],
                  fit["capture_step_s"] * 1e3,
                  fit["peak_memory_bytes"] / 1e9,
                  fit["cross_entropy_by_step"][0],
                  fit["cross_entropy_by_step"][-1],
                  sum(fit["launches"].values()),
                  {k: "%.2e" % v for k, v in
                   check["held_to_tolerance"].items()},
                  check["grad_rel_err_median"], check["grad_rel_err_max"]),
              flush=True)
        records.append(fit)
        for k, v in fit["launches"].items():
            total[k] = total.get(k, 0) + v
        base_lr = params.get("learning_rate", 0.01)
        ce = fit["cross_entropy_by_step"]
        if not ok or (fit["graph_captures"], fit["graph_replays"]) != (
                1, ZOO_STEPS - 1) or fit["steps"] != ZOO_STEPS \
                or not all(math.isfinite(c) for c in ce) \
                or not fit["loss_fell"] \
                or not all(math.isfinite(v) for v in
                           fit["metrics"].values()) \
                or not math.isclose(fit["lr_in_graph"], base_lr * 0.1,
                                    rel_tol=1e-6):
            raise AssertionError("train_zoo %s gave %s" % (network, fit))
        expect_launches("train_zoo " + network, fit["launches"])
    _emit({"train_zoo_s": time.perf_counter() - t_phase})
    print("train_zoo: %d networks in %.1f s" % (
        len(records), time.perf_counter() - t_phase), flush=True)
    return total, records


# ----------------------------------------------------------------------
# optimizers: every registered optimizer, the update ops, a resume
def _opt_mlp():
    """examples/module/mnist_mlp.py's MLP, fc1's weight at lr_mult 0.5."""
    data = mt.sym.Variable("data")
    w = mt.sym.Variable("fc1_weight", lr_mult=0.5)
    net = mt.sym.FullyConnected(data, weight=w, name="fc1", num_hidden=128)
    net = mt.sym.Activation(net, name="relu1", act_type="relu")
    net = mt.sym.FullyConnected(net, name="fc2", num_hidden=64)
    net = mt.sym.Activation(net, name="relu2", act_type="relu")
    net = mt.sym.FullyConnected(net, name="fc3", num_hidden=10)
    return mt.sym.SoftmaxOutput(net, name="softmax")


def _opt_data(n_batches):
    """MLP batches and initial weights, numpy from SEED."""
    rng = np.random.default_rng(SEED)
    batches = [(rng.standard_normal((OPT_BATCH, 784), dtype=np.float32),
                rng.integers(0, 10, OPT_BATCH).astype(np.float32))
               for _ in range(n_batches)]
    shapes, _, _ = _opt_mlp().infer_shape(data=(OPT_BATCH, 784))
    init = {n: (rng.standard_normal(s, dtype=np.float32)
                * np.float32(0.05))
            for n, s in zip(_opt_mlp().list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    return batches, init


def opt_steps(ctx, policy, name, params, batches, init):
    """OPT_STEPS forward/backward/update steps of the MLP with optimizer
    ``name`` on ``ctx`` under ``policy``; returns (the parameters on the
    host, whether the fused path ran, graph captures)."""
    mt.random.seed(SEED)
    with _fused_policy(policy), mt.Context(ctx):
        mod = mt.mod.Module(_opt_mlp(), context=ctx)
        mod.bind(data_shapes=[("data", (OPT_BATCH, 784))],
                 label_shapes=[("softmax_label", (OPT_BATCH,))])
        mod.init_params(arg_params={n: mt.nd.array(v)
                                    for n, v in init.items()})
        mod.init_optimizer(optimizer=name,
                           optimizer_params=dict(OPT_COMMON, **params))
        for x, y in batches[:OPT_STEPS]:
            mod.forward(mt.io.DataBatch([mt.nd.array(x)], [mt.nd.array(y)]),
                        is_train=True)
            mod.backward()
            mod.update()
    arg, _ = mod.get_params()
    tr = mod._trainer
    return ({n: v.data.cpu() for n, v in arg.items()}, tr is not None,
            tr.graph_captures if tr is not None else 0)


def _opt_ops(gen):
    """The five update ops on the card and on the CPU, from the same
    inputs; the largest relative error of any output."""
    shape = (OPT_OP_SIZE,)
    w, g = (torch.randn(shape, generator=gen, device="cuda")
            for _ in range(2))
    s = [torch.rand(shape, generator=gen, device="cuda") for _ in range(3)]
    s_alex = [s[0] + s[1] ** 2, s[1], s[2]]
    cases = [("sgd_update", [], {}),
             ("sgd_mom_update", s[:1], {"momentum": 0.9}),
             ("adam_update", s[:2], {"t": 3}),
             ("rmsprop_update", s[:1], {"clip_weights": 0.5}),
             ("rmspropalex_update", s_alex, {})]
    errs = {}
    for name, states, kw in cases:
        kw = dict(kw, lr=0.01, wd=1e-3, rescale_grad=0.5, clip_gradient=1.0)
        outs = {}
        for side, dev in (("card", "cuda"), ("cpu", "cpu")):
            arrs = [mt.nd.NDArray(a.to(dev)) for a in [w, g] + states]
            res = getattr(mt.nd, name)(*arrs, **kw)
            outs[side] = [r.data.cpu() for r in (
                res if isinstance(res, list) else [res])]
        errs[name] = max(((a.double() - b.double()).norm()
                          / b.double().norm()).item()
                         for a, b in zip(outs["card"], outs["cpu"]))
    return errs


def _sgld_noise(seed):
    """SGLD's update of OPT_OP_SIZE zeros by a zero gradient on the card
    (lr 0.04): sqrt(lr) standard normal noise from the device's
    generator."""
    mt.random.seed(seed)
    opt = mt.optimizer.SGLD(learning_rate=0.04)
    w = mt.nd.NDArray(torch.zeros(OPT_OP_SIZE, device="cuda"))
    opt.update(0, w, mt.nd.NDArray(torch.zeros(OPT_OP_SIZE, device="cuda")),
               None)
    return w.data.cpu()


def opt_resume(tmp):
    """``fit`` of the MLP on the card's fused path with centered RMSProp,
    a checkpoint each epoch: uninterrupted; crashed inside its second
    save (OPT_RESUME_FAULT); restarted with ``resume=True``.  Returns
    (whether the restart ends bitwise where the uninterrupted run ends,
    the state tree kept for fc1's weight in the last states file)."""
    import pickle
    batches, init = _opt_data(4)
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    opt = dict(OPT_COMMON, learning_rate=1e-3, centered=True)

    def run(prefix, resume=False):
        mt.random.seed(SEED)
        it = mt.io.NDArrayIter(x, y, batch_size=OPT_BATCH)
        mod = mt.mod.Module(_opt_mlp(), context=mt.gpu())
        mod.fit(it, num_epoch=OPT_RESUME_EPOCHS, optimizer="rmsprop",
                optimizer_params=opt,
                arg_params={n: mt.nd.array(v) for n, v in init.items()},
                checkpoint=mt.resilience.CheckpointManager(prefix, keep=2),
                resume=resume)
        assert mod._trainer is not None
        return {n: v.data.cpu() for n, v in mod.get_params()[0].items()}

    want = run(os.path.join(tmp, "full"))
    prefix = os.path.join(tmp, "run")
    mt.faults.configure(OPT_RESUME_FAULT)
    crashed = False
    try:
        run(prefix)
    except mt.faults.InjectedCrash:
        crashed = True
    finally:
        mt.faults.clear()
    got = run(prefix, resume=True)
    ck = mt.resilience.CheckpointManager(prefix).latest()
    with open(ck.states_path, "rb") as f:
        _, state, _, _ = pickle.loads(f.read())
    tree = [tuple(t.shape) for t in state["fc1_weight"]]
    same = sorted(got) == sorted(want) and all(
        torch.equal(got[n], want[n]) for n in want)
    return crashed, same, ck.epoch, tree


def optimizers(card):
    """Every registered optimizer on the card against the port's CPU (the
    MLP, OPT_STEPS classic and fused steps; SGLD on the classic path,
    held by its noise's moments and determinism per seed), the five
    update ops against their CPU results, and the bitwise resume with
    centered RMSProp.  Returns (launches, record)."""
    import shutil
    _phase("optimizers")
    t_phase = time.perf_counter()
    reset_launch_counts()
    batches, init = _opt_data(OPT_STEPS)
    rows = []
    for name, params in OPTIMIZERS:
        row = {"optimizer": name, "params": params}
        for path, card_policy, cpu_policy in (("classic", "never", "never"),
                                              ("fused", "auto", "always")):
            if name == "sgld" and path == "fused":
                continue
            got, fused, captures = opt_steps(mt.gpu(), card_policy, name,
                                             params, batches, init)
            # SGLD's noise: the card's generator against itself (the
            # CPU's draws other numbers)
            want, _, _ = opt_steps(
                mt.gpu() if name == "sgld" else mt.cpu(),
                card_policy if name == "sgld" else cpu_policy, name, params,
                batches, init)
            rel = _rel_norms(got, want)
            moved = min(((got[n] - torch.from_numpy(init[n])).norm()
                         / torch.from_numpy(init[n]).norm()).item()
                        for n in init)
            row[path] = {"rel_err_max": max(rel.values()),
                         "fused": fused, "graph_captures": captures,
                         "moved_min": moved}
        rows.append(row)
    a, b, c = _sgld_noise(5), _sgld_noise(5), _sgld_noise(6)
    sgld = {"same_seed_bitwise": bool(torch.equal(a, b)),
            "other_seed_differs": not bool(torch.equal(a, c)),
            "mean": a.mean().item(), "std": a.std().item(),
            "expected_std": 0.2}
    op_errs = _opt_ops(torch.Generator(device="cuda").manual_seed(SEED))
    tmp = tempfile.mkdtemp(prefix="mxtpu_opt_resume_")
    try:
        crashed, same, epoch, tree = opt_resume(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = launch_counts()
    record = {"optimizers": rows, "sgld_noise": sgld,
              "update_ops_rel_err": op_errs, "tolerance": OPT_TOL,
              "op_tolerance": OPT_OP_TOL,
              "resume": {"crashed": crashed, "bitwise": same,
                         "latest_epoch": epoch, "fc1_weight_state": tree},
              "launches": counts, "phase_s": time.perf_counter() - t_phase,
              "card": card}
    _emit(record)
    print("optimizers: %d runs, card vs CPU worst %.2e; update ops worst "
          "%.2e; SGLD std %.4f (want 0.2), bitwise per seed %s; centered "
          "RMSProp resume bitwise %s, state %s; %.1f s" % (
              sum(1 for r in rows for p in ("classic", "fused") if p in r),
              max(r[p]["rel_err_max"] for r in rows
                  for p in ("classic", "fused") if p in r),
              max(op_errs.values()), sgld["std"],
              sgld["same_seed_bitwise"], same, tree, record["phase_s"]),
          flush=True)
    bad = [(r["optimizer"], p) for r in rows for p in ("classic", "fused")
           if p in r and not (
               r[p]["rel_err_max"] <= (0 if r["optimizer"] == "sgld"
                                       else OPT_TOL)
               and r[p]["moved_min"] > 0
               and r[p]["fused"] == (p == "fused")
               and r[p]["graph_captures"] == (1 if p == "fused" else 0))]
    if bad or not (sgld["same_seed_bitwise"] and sgld["other_seed_differs"]
                   and abs(sgld["mean"]) < 0.01
                   and abs(sgld["std"] - 0.2) < 0.002) \
            or not all(e <= OPT_OP_TOL for e in op_errs.values()) \
            or not (crashed and same and epoch == OPT_RESUME_EPOCHS
                    and tree == [(128, 784)] * 3):
        raise AssertionError("optimizers gave %s (failed: %s)"
                             % (record, bad))
    expect_launches("optimizers", counts)
    return counts, record


# ----------------------------------------------------------------------
# train_fcn: FCN-8s semantic segmentation (Deconvolution, Crop, the
# per-pixel softmax with an ignore label) through Module.fit
def fcn8s_symbol(sym, num_classes=FCN_CLASSES,
                 widths=(64, 128, 256, 512, 512), fc=4096, dropout=0.5):
    """FCN-8s from ``sym`` (either package's; upstream ``symbol_fcnxs.py``
    ``get_fcn8s_symbol``): VGG-16 at stage widths ``widths`` with
    ``pad=(100, 100)`` on conv1_1, fc6 a 7x7 and fc7 a 1x1 convolution of
    ``fc``, a 1x1 score head, three Deconvolutions (4x4/2, 4x4/2, 16x16/8,
    ``adj = stride - 1``, no bias), Crop at (5, 5), (9, 9) and (31, 31)
    against score_pool4, score_pool3 and data, and SoftmaxOutput over
    every pixel ignoring label FCN_IGNORE."""
    data = sym.Variable("data")
    x = data
    pools = []
    for stage, (width, depth) in enumerate(zip(widths, (2, 2, 3, 3, 3))):
        for i in range(depth):
            name = "conv%d_%d" % (stage + 1, i + 1)
            pad = (100, 100) if name == "conv1_1" else (1, 1)
            x = sym.Convolution(x, kernel=(3, 3), pad=pad, num_filter=width,
                                workspace=1024, name=name)
            x = sym.Activation(x, act_type="relu",
                               name="relu%d_%d" % (stage + 1, i + 1))
        x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="pool%d" % (stage + 1))
        pools.append(x)
    pool3, pool4, pool5 = pools[2:]
    x = sym.Convolution(pool5, kernel=(7, 7), num_filter=fc, name="fc6")
    x = sym.Activation(x, act_type="relu", name="relu6")
    x = sym.Dropout(x, p=dropout, name="drop6")
    x = sym.Convolution(x, kernel=(1, 1), num_filter=fc, name="fc7")
    x = sym.Activation(x, act_type="relu", name="relu7")
    x = sym.Dropout(x, p=dropout, name="drop7")
    score = sym.Convolution(x, kernel=(1, 1), num_filter=num_classes,
                            name="score")
    score2 = sym.Deconvolution(score, kernel=(4, 4), stride=(2, 2),
                               adj=(1, 1), num_filter=num_classes,
                               no_bias=True, name="score2")
    score_pool4 = sym.Convolution(pool4, kernel=(1, 1),
                                  num_filter=num_classes, name="score_pool4")
    score_pool4c = sym.Crop(score_pool4, score2, offset=(5, 5),
                            name="score_pool4c")
    score4 = sym.Deconvolution(score2 + score_pool4c, kernel=(4, 4),
                               stride=(2, 2), adj=(1, 1),
                               num_filter=num_classes, no_bias=True,
                               name="score4")
    score_pool3 = sym.Convolution(pool3, kernel=(1, 1),
                                  num_filter=num_classes, name="score_pool3")
    score_pool3c = sym.Crop(score_pool3, score4, offset=(9, 9),
                            name="score_pool3c")
    bigscore = sym.Deconvolution(score4 + score_pool3c, kernel=(16, 16),
                                 stride=(8, 8), adj=(7, 7),
                                 num_filter=num_classes, no_bias=True,
                                 name="bigscore")
    upscore = sym.Crop(bigscore, data, offset=(31, 31), name="upscore")
    return sym.SoftmaxOutput(upscore, multi_output=True, use_ignore=True,
                             ignore_label=FCN_IGNORE, name="softmax")


FCN_DECONV_CROP = ("score2", "score4", "bigscore", "score_pool4c",
                   "score_pool3c", "upscore")


def fcn_batch(shape, num_classes=FCN_CLASSES, seed=SEED, border=FCN_BORDER):
    """One synthetic segmentation batch of ``shape`` (n, c, h, w) from
    ``seed``: labels of class 0 with five rectangles of random classes
    each and a border of FCN_IGNORE ``border`` pixels wide; images N(0, 1)
    noise plus a brightness a class in each channel."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    y = np.zeros((n, h, w), np.int32)
    for i in range(n):
        for _ in range(5):
            r0, c0 = rng.integers(0, (h // 2, w // 2))
            hh, ww = rng.integers((h // 8, w // 8), (h // 2, w // 2))
            y[i, r0:r0 + hh, c0:c0 + ww] = rng.integers(1, num_classes)
    tint = rng.uniform(-1, 1, (num_classes, c)).astype(np.float32)
    x = rng.standard_normal(shape, dtype=np.float32) \
        + tint[y].transpose(0, 3, 1, 2)
    if border:
        y[:, :border] = y[:, -border:] = FCN_IGNORE
        y[:, :, :border] = y[:, :, -border:] = FCN_IGNORE
    return x, y


def fcn_initializer():
    return mt.init.Mixed([".*(score2|score4|bigscore)_weight", ".*"],
                         [mt.init.Bilinear(), mt.init.Xavier(**FCN_INIT)])


def fcn_params(symbol, data_shape, seed=SEED):
    """Random weights for a float32 check, numpy from ``seed``: He-normal
    convolutions, the Deconvolutions at 0.1 of it, biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    args, _, _ = symbol.infer_shape(data=data_shape)
    out = {}
    for n, s in zip(symbol.list_arguments(), args):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_bias"):
            out[n] = rng.normal(0, 0.1, s).astype(np.float32)
            continue
        scale = np.sqrt(2.0 / np.prod(s[1:]))
        if n.startswith(("score2", "score4", "bigscore", "up2")):
            scale *= 0.1
        out[n] = (rng.standard_normal(s) * scale).astype(np.float32)
    return out


def fcn_step_vs_cpu(lr):
    """One fused float32 step of FCN-8s (Dropout at p = 0, TF32 off) at
    1 x 3 x FCN_CHECK_IMAGE^2 on the card and on the port's CPU from the
    same weights, SGD as train_fcn's: the step's output, the gradients,
    and every weight after the update, as relative norms."""
    symbol = fcn8s_symbol(mt.sym, dropout=0.0)
    shape = (1, 3, FCN_CHECK_IMAGE, FCN_CHECK_IMAGE)
    arg = fcn_params(symbol, shape)
    x, y = fcn_batch(shape, border=4)
    batch = {"data": x, "softmax_label": y.astype(np.float32)}
    runs = {}
    for side, ctx in (("card", mt.gpu()), ("cpu", mt.cpu())):
        with ctx:
            tr = mt.parallel.Trainer(symbol, mt.optimizer.create(
                "sgd", learning_rate=lr, **FCN_SGD))
        tr.bind({"data": x.shape}, {"softmax_label": y.shape})
        tr.init_params(arg_params={n: torch.from_numpy(v)
                                   for n, v in arg.items()}, aux_params={})
        _, _, grads = tr._run_backward(tr.params, tr.aux,
                                       tr._device_batch(batch), None)
        out = tr.step(batch)[0].data
        runs[side] = ({n: g.cpu() for n, g in grads.items()},
                      out.cpu(), {n: v.cpu() for n, v in tr.params.items()})
        del tr, grads, out
    (cg, co, cp), (hg, ho, hp) = runs["card"], runs["cpu"]
    grad = _rel_norms(cg, hg)
    stepped = _rel_norms(cp, hp)
    worst = max(stepped, key=stepped.get)
    held = {"step_output": _rel_norms({"o": co}, {"o": ho})["o"],
            "score_weight_grad": grad["score_weight"],
            "score_pool4_weight_grad": grad["score_pool4_weight"],
            "bigscore_weight_grad": grad["bigscore_weight"],
            "worst_weight_after_step": stepped[worst]}
    torch.cuda.empty_cache()
    return {"image": FCN_CHECK_IMAGE, "lr": lr, "held_to_tolerance": held,
            "tolerance": FCN_TOL, "worst_weight": worst,
            "grad_rel_err_median": statistics.median(grad.values()),
            "grad_rel_err_max": max(grad.values()),
            "finite": bool(torch.isfinite(co).all())}


def fcn_cross_entropy(probs, label):
    """Mean -log p(label) over the pixels not labelled FCN_IGNORE."""
    label = label.long()
    valid = label != FCN_IGNORE
    picked = probs.float().gather(1, label.clamp(max=FCN_CLASSES - 1)
                                  .unsqueeze(1)).squeeze(1)
    return float(-picked.clamp(min=1e-30).log()[valid].mean())


def fcn_fit(lr, compute_dtype=None, profile_steps=0):
    """``Module.fit`` of FCN-8s on the card (float32 compute, or
    ``compute_dtype``), FCN_STEPS steps of one batch at lr ``lr``; the
    replayed steps' kernels in a profiler trace when ``profile_steps``.
    Returns its record and the module."""
    x, y = fcn_batch((1, 3, FCN_IMAGE, FCN_IMAGE))
    xs = torch.from_numpy(x).cuda()
    ys = torch.from_numpy(y).cuda()
    data = mt.io.NDArrayIter(mt.nd.NDArray(xs.repeat(FCN_STEPS, 1, 1, 1)),
                             mt.nd.NDArray(ys.repeat(FCN_STEPS, 1, 1)),
                             batch_size=1)
    mod = mt.mod.Module(fcn8s_symbol(mt.sym), context=mt.gpu(),
                        compute_dtype=compute_dtype)
    steps, last = [], {}

    def on_batch(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        probs = param.locals["self"].get_outputs()[0].data
        steps.append({"s": now - last["t"],
                      "ce": fcn_cross_entropy(probs, ys)})
        last["t"] = time.perf_counter()

    mt.random.seed(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = last["t"] = time.perf_counter()
    mod.fit(data, num_epoch=1, kvstore="device", optimizer="sgd",
            optimizer_params=dict(FCN_SGD, learning_rate=lr),
            initializer=fcn_initializer(), eval_metric="acc",
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    tr = mod._trainer
    if tr is None:
        raise AssertionError("FCN-8s took the classic path")
    replay_s = statistics.median(s["s"] for s in steps[2:])
    ignored = float((ys == FCN_IGNORE).float().mean())
    record = {"lr": lr, "steps": len(steps), "batch": 1,
              "image": FCN_IMAGE, "compute_dtype": compute_dtype or "float32",
              "first_step_s": steps[0]["s"], "capture_step_s": steps[1]["s"],
              "replay_step_s": replay_s, "step_ms": replay_s * 1e3,
              "img_per_s": 1.0 / replay_s,
              "step_s_runs": [s["s"] for s in steps],
              "cross_entropy_by_step": [s["ce"] for s in steps],
              "loss_fell": steps[-1]["ce"] < steps[0]["ce"],
              "ignored_label_frac": ignored,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "graph_captures": tr.graph_captures,
              "graph_replays": tr.graph_replays, "launches": launches,
              "fit_s": time.perf_counter() - t0}
    if profile_steps:
        record["profile"] = fcn_step_profile(mod, xs, ys, profile_steps)
    return record, mod


# kernel-name groups of FCN-8s's replayed step; a name goes to the first
# group whose pattern it matches.  cuDNN runs a transposed convolution's
# forward as a convolution's data gradient, so Deconvolution shares the
# convolution kernels' names and is not a group of its own
FCN_KERNEL_GROUPS = (
    ("softmax", re.compile(r"softmax", re.I)),
    ("convolution (cuDNN, Deconvolution included)",
     re.compile(r"conv|cudnn|xmma|implicit|dgrad|wgrad|fprop|gemm|sm90",
                re.I)),
    ("pooling", re.compile(r"pool", re.I)),
    ("SGD and other elementwise passes",
     re.compile(r"elementwise|vectorized|foreach|multi_tensor|unrolled",
                re.I)),
)


def fcn_step_profile(mod, xs, ys, n):
    """``n`` replayed fused steps traced by ``torch.profiler``: device
    ms a step by kernel group, the largest kernels, the idle share."""
    batch = {"data": mt.nd.NDArray(xs), "softmax_label": mt.nd.NDArray(ys)}
    tr = mod._trainer
    tr.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tr.step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, spans = device_idle_share(prof, wall)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / n
    groups = {}
    for name, ms in by_name.items():
        group = next((g for g, pat in FCN_KERNEL_GROUPS if pat.search(name)),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": n, "wall_ms_a_step": wall / n * 1e3,
            "device_ms_a_step": sum(by_name.values()),
            "idle_share": idle, "device_events": spans,
            "groups_ms": groups,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def fcn_nodes_on_card(mod):
    """One eager float32 forward of the fused module's symbol through an
    executor on the card with the module's weights, every op output
    tapped: the device of each Deconvolution and Crop node's output."""
    symbol = fcn8s_symbol(mt.sym)
    ex = symbol.simple_bind(mt.gpu(), grad_req="null",
                            data=(1, 3, FCN_IMAGE, FCN_IMAGE),
                            softmax_label=(1, FCN_IMAGE, FCN_IMAGE))
    arg, aux = mod.get_params()
    ex.copy_params_from(arg, aux, allow_extra_params=True)
    seen = {}

    def tap(name, arr):
        node = name.rsplit("_output", 1)[0]
        if node in FCN_DECONV_CROP:
            seen[node] = (str(arr.data.device), tuple(arr.shape))

    ex.install_monitor(tap)
    x, _ = fcn_batch((1, 3, FCN_IMAGE, FCN_IMAGE))
    ex.forward(is_train=False, data=x)
    torch.cuda.synchronize()
    del ex
    torch.cuda.empty_cache()
    return seen


def train_fcn(card, lrs=None):
    """FCN-8s on the card: ``Module.fit`` at full width (fcn_fit) in
    float32 at FCN_LR, or first at each of ``lrs`` in turn, then the same
    fit in bfloat16; the Deconvolution and Crop nodes' outputs on the
    card; one float32 step against the port's CPU.  Asserts the fused
    path, one capture and a replay a step in both dtypes, a finite loss
    in both, falling in float32 (in bfloat16 it falls at no lr, in the
    JAX package as here: it is reported), none of the port's kernels,
    every node on
    the card and the float32 step within FCN_TOL.  Returns (launches,
    record)."""
    _phase("train_fcn")
    t_phase = time.perf_counter()
    sweep = []
    for lr, dtype in lrs or ():
        rec, mod = fcn_fit(lr, dtype)
        del mod
        sweep.append({k: rec[k] for k in ("lr", "compute_dtype",
                                          "cross_entropy_by_step",
                                          "loss_fell", "step_ms")})
        print("train_fcn lr %.0e %s: loss %s" % (
            lr, rec["compute_dtype"],
            ["%.5f" % c for c in rec["cross_entropy_by_step"]]), flush=True)
    record, mod = fcn_fit(FCN_LR, profile_steps=3)
    nodes = fcn_nodes_on_card(mod)
    del mod
    bf16, mod = fcn_fit(FCN_LR, "bfloat16", profile_steps=3)
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    check = fcn_step_vs_cpu(FCN_LR)
    record.update(lr_sweep=sweep, deconv_crop_nodes=nodes, vs_cpu=check,
                  bfloat16=bf16, card=card,
                  phase_s=time.perf_counter() - t_phase)
    _emit({"train_fcn": record})
    for rec in (record, bf16):
        ce = rec["cross_entropy_by_step"]
        print("train_fcn %s (%s): batch 1 of %d^2, lr %g, step %.2f ms, "
              "%.2f img/s, capture step %.0f ms, peak %.2f GB, loss %.5f "
              "-> %.5f, ignored %.3f of the label, K1/B2/K2 launches %d; "
              "device ms a step by group %s, idle %.3f" % (
                  rec["compute_dtype"], card, FCN_IMAGE, FCN_LR,
                  rec["step_ms"], rec["img_per_s"],
                  rec["capture_step_s"] * 1e3,
                  rec["peak_memory_bytes"] / 1e9, ce[0], ce[-1],
                  rec["ignored_label_frac"], sum(rec["launches"].values()),
                  {k: round(v, 2) for k, v in
                   rec["profile"]["groups_ms"].items()},
                  rec["profile"]["idle_share"]), flush=True)
    print("train_fcn: Deconvolution and Crop outputs %s; float32 step at "
          "%d^2 vs CPU %s (tolerance %g)" % (
              {k: v[0] for k, v in nodes.items()}, FCN_CHECK_IMAGE,
              {k: "%.2e" % v for k, v in check["held_to_tolerance"].items()},
              FCN_TOL), flush=True)
    ok = all((r["graph_captures"], r["graph_replays"], r["steps"])
             == (1, FCN_STEPS - 1, FCN_STEPS)
             and all(math.isfinite(c) for c in r["cross_entropy_by_step"])
             for r in (record, bf16))
    if not ok or not record["loss_fell"] \
            or set(nodes) != set(FCN_DECONV_CROP) \
            or not all(d.startswith("cuda") for d, _ in nodes.values()) \
            or nodes["upscore"][1] != (1, FCN_CLASSES, FCN_IMAGE, FCN_IMAGE) \
            or not check["finite"] \
            or not all(math.isfinite(e) and e <= FCN_TOL
                       for e in check["held_to_tolerance"].values()):
        raise AssertionError("train_fcn gave %s" % record)
    launches = {k: record["launches"][k] + bf16["launches"][k]
                for k in record["launches"]}
    expect_launches("train_fcn", launches)
    return launches, record


# ----------------------------------------------------------------------
# loss_examples: the loss-layer examples at their own sizes, each symbol
# rebuilt on mt, on the card and on the port's CPU
def _example_params(mod):
    arg, aux = mod.get_params()
    return {n: v.data.float().cpu() for n, v in {**arg, **aux}.items()}


def fcnxs_toy_symbol(sym, nclass=2):
    """examples/fcn-xs/train_fcnxs_toy.py's ``fcnxs_symbol`` from ``sym``
    (either package's): two pool stages down, two Deconvolutions back up
    with the FCN-8s skip fusion, a per-pixel softmax."""
    data = sym.Variable("data")
    c1 = sym.Convolution(data, num_filter=16, kernel=(3, 3), pad=(1, 1),
                         name="conv1")
    p1 = sym.Pooling(sym.Activation(c1, act_type="relu"), kernel=(2, 2),
                     stride=(2, 2), pool_type="max", name="pool1")
    c2 = sym.Convolution(p1, num_filter=32, kernel=(3, 3), pad=(1, 1),
                         name="conv2")
    p2 = sym.Pooling(sym.Activation(c2, act_type="relu"), kernel=(2, 2),
                     stride=(2, 2), pool_type="max", name="pool2")
    score2 = sym.Convolution(p2, num_filter=nclass, kernel=(1, 1),
                             name="score2")
    score_pool1 = sym.Convolution(p1, num_filter=nclass, kernel=(1, 1),
                                  name="score_pool1")
    up2 = sym.Deconvolution(score2, kernel=(4, 4), stride=(2, 2),
                            adj=(1, 1), num_filter=nclass, no_bias=True,
                            name="up2")
    fused = sym.Crop(up2, score_pool1, name="up2c") + score_pool1
    bigscore = sym.Deconvolution(fused, kernel=(4, 4), stride=(2, 2),
                                 adj=(1, 1), num_filter=nclass,
                                 no_bias=True, name="bigscore")
    return sym.SoftmaxOutput(sym.Crop(bigscore, data, name="upscore"),
                             multi_output=True, normalization="valid",
                             name="softmax")


def autoencoder_symbol(sym, layer_dims, out_dim):
    """examples/autoencoder/train_autoencoder_toy.py's ``ae_symbol``: an
    encoder stack, its mirrored decoder, LinearRegressionOutput."""
    h = sym.Variable("data")
    for i, d in enumerate(layer_dims):
        h = sym.Activation(sym.FullyConnected(h, num_hidden=d,
                                              name="enc%d" % i),
                           act_type="relu")
    for i, d in enumerate(tuple(reversed(layer_dims[:-1])) + (out_dim,)):
        h = sym.FullyConnected(h, num_hidden=d, name="dec%d" % i)
        if i < len(layer_dims) - 1:
            h = sym.Activation(h, act_type="relu")
    return sym.LinearRegressionOutput(h, sym.Variable("label"), name="recon")


def svm_symbol(sym, use_linear=False):
    """examples/svm_mnist/svm_toy.py's ``svm_mlp``."""
    net = sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                            num_hidden=48, name="fc1"),
                         act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SVMOutput(net, name="svm", regularization_coefficient=1.0,
                         use_linear=use_linear)


def nce_symbol(sym, vocab=100, hidden=32):
    """examples/nce-loss/train_nce_toy.py's ``get_net``: Embedding-gathered
    candidate vectors against an FC representation, a
    LogisticRegressionOutput over [true, noise...]."""
    pred = sym.FullyConnected(sym.Variable("data"), num_hidden=hidden,
                              name="fc")
    embed = sym.Embedding(sym.Variable("label"), input_dim=vocab,
                          weight=sym.Variable("embed_weight"),
                          output_dim=hidden, name="label_embed")
    pred = sym.broadcast_mul(sym.Reshape(pred, shape=(-1, 1, hidden)), embed)
    return sym.LogisticRegressionOutput(sym.sum(pred, axis=2),
                                        sym.Variable("label_weight"),
                                        name="nce")


def matrix_fact_symbol(sym, users=40, items=30, rank=6):
    """examples/recommenders/matrix_fact_toy.py's ``mf_symbol``."""
    u = sym.Flatten(sym.Embedding(sym.Variable("user"), input_dim=users,
                                  output_dim=rank, name="user_embed"))
    v = sym.Flatten(sym.Embedding(sym.Variable("item"), input_dim=items,
                                  output_dim=rank, name="item_embed"))
    return sym.LinearRegressionOutput(sym.sum(u * v, axis=1, keepdims=True),
                                      sym.Variable("score_label"),
                                      name="score")


def dec_encoder_symbol(sym, latent=2):
    """examples/dec/dec_toy.py's ``encoder_symbol``."""
    h = sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                          num_hidden=16, name="enc1"),
                       act_type="relu")
    return sym.FullyConnected(h, num_hidden=latent, name="enc2")


def dec_symbol(sym, centers=3, latent=2, alpha=1.0):
    """examples/dec/dec_toy.py's ``dec_symbol``: the Student-t soft
    assignment Q of the encoder's embeddings to the centroids, KL(P || Q)
    under MakeLoss, and Q (BlockGrad'd) in one Group."""
    z = dec_encoder_symbol(sym, latent)
    mu = sym.Variable("dec_mu_weight", shape=(centers, latent))
    p = sym.Variable("p_label")
    dist2 = sym.sum(sym.square(sym.broadcast_sub(
        sym.Reshape(z, shape=(-1, 1, latent)),
        sym.Reshape(mu, shape=(1, centers, latent)))), axis=2)
    qu = (1.0 + dist2 / alpha) ** (-(alpha + 1.0) / 2.0)
    q = sym.broadcast_div(qu, sym.sum(qu, axis=1, keepdims=True))
    kl = sym.sum(p * (sym.log(p + 1e-6) - sym.log(q + 1e-6)))
    return sym.Group([sym.BlockGrad(q), sym.MakeLoss(kl, name="dec")])


def example_fcnxs(epochs=6, batch=8, n=64):
    """examples/fcn-xs/train_fcnxs_toy.py at its size, Adam; pixel
    accuracy over the training set (its assert: > 0.9)."""
    hw = 32
    net = fcnxs_toy_symbol(mt.sym)
    rng = np.random.RandomState(0)
    x = rng.normal(0, 0.3, (n, 3, hw, hw)).astype("f")
    y = np.zeros((n, hw, hw), "f")
    for i in range(n):
        h, w = rng.randint(8, 20, 2)
        r, c = rng.randint(0, hw - h), rng.randint(0, hw - w)
        x[i, :, r:r + h, c:c + w] += rng.uniform(1.0, 2.0)
        y[i, r:r + h, c:c + w] = 1.0
    it = mt.io.NDArrayIter(x, y, batch_size=batch, shuffle=True,
                           label_name="softmax_label")
    mod = mt.mod.Module(net, context=mt.base.current_context())
    mod.fit(it, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            initializer=mt.init.Xavier(magnitude=2.0))
    it.reset()
    correct = total = 0
    for b in it:
        mod.forward(b, is_train=False)
        pred = mod.get_outputs()[0].asnumpy().argmax(axis=1)
        lab = b.label[0].asnumpy()
        correct += (pred == lab).sum()
        total += lab.size
    acc = correct / total
    return {"pixel_accuracy": acc}, acc > 0.9, _example_params(mod)


def example_autoencoder(batch=32, pretrain_epochs=8, finetune_epochs=12,
                        lr=2e-3):
    """examples/autoencoder/train_autoencoder_toy.py: greedy layer-wise
    pretraining of each encoder/decoder pair, then the whole stack,
    LinearRegressionOutput, Adam; the validation reconstruction mse over
    the data variance (its assert: < 0.15)."""
    dims = (64, 32, 8)
    proj = np.random.RandomState(1234).normal(0, 1, (6, dims[0])) \
        .astype("f")

    def make(rng, n):
        latent = rng.normal(0, 1, (n, 6)).astype("f")
        return latent @ proj + rng.normal(0, 0.05, (n, dims[0])).astype("f")

    def stage(sym, X, epochs, arg_params=None):
        it = mt.io.NDArrayIter(X, X.copy(), batch_size=batch, shuffle=True,
                               label_name="label")
        mod = mt.mod.Module(sym, label_names=("label",),
                            context=mt.base.current_context())
        mod.fit(it, num_epoch=epochs, optimizer="adam",
                optimizer_params={"learning_rate": lr},
                arg_params=arg_params, allow_missing=True,
                initializer=mt.init.Xavier())
        return dict(mod.get_params()[0]), mod

    rng = np.random.RandomState(0)
    X, Xv = make(rng, 768), make(rng, 128)
    base_var = float((Xv ** 2).mean())
    params, codes = {}, X
    for i in range(len(dims) - 1):
        got, _ = stage(autoencoder_symbol(mt.sym, (dims[i + 1],),
                                          codes.shape[1]), codes,
                       pretrain_epochs)
        last = len(dims) - 2 - i
        params.update({"enc%d_weight" % i: got["enc0_weight"],
                       "enc%d_bias" % i: got["enc0_bias"],
                       "dec%d_weight" % last: got["dec0_weight"],
                       "dec%d_bias" % last: got["dec0_bias"]})
        codes = np.maximum(codes @ got["enc0_weight"].asnumpy().T
                           + got["enc0_bias"].asnumpy(), 0.0)
    _, mod = stage(autoencoder_symbol(mt.sym, dims[1:], dims[0]), X,
                   finetune_epochs, params)
    it = mt.io.NDArrayIter(Xv, Xv.copy(), batch_size=batch,
                           label_name="label")
    ratio = dict(mod.score(it, mt.metric.MSE()))["mse"] / base_var
    return {"mse_over_variance": ratio}, ratio < 0.15, _example_params(mod)


def example_svm(epochs=10, batch=32):
    """examples/svm_mnist/svm_toy.py: an MLP under SVMOutput (squared
    hinge), SGD momentum 0.9; training accuracy (its assert: > 0.9)."""
    net = svm_symbol(mt.sym)
    rng = np.random.RandomState(0)
    x = rng.randn(400, 20).astype("f")
    y = np.argmax(x @ rng.randn(20, 4).astype("f"), axis=1).astype("f")
    it = mt.io.NDArrayIter(x, y, batch_size=batch, shuffle=True,
                           label_name="svm_label")
    mod = mt.mod.Module(net, context=mt.base.current_context(),
                        label_names=("svm_label",))
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.02, "momentum": 0.9},
            initializer=mt.init.Xavier())
    it.reset()
    correct = total = 0
    for b in it:
        mod.forward(b, is_train=False)
        pred = mod.get_outputs()[0].asnumpy().argmax(1)
        lab = b.label[0].asnumpy()
        correct += (pred == lab).sum()
        total += len(lab)
    acc = correct / total
    return {"accuracy": acc}, acc > 0.9, _example_params(mod)


class _NceIter(mt.io.DataIter):
    """examples/nce-loss/train_nce_toy.py's NceIter: multi-hot features
    whose bits give the true class; a batch carries [true, noise...]
    candidate ids and their 0/1 indicator weights, the same every
    epoch."""

    def __init__(self, count, batch_size, vocab=100, num_label=6,
                 feature=20, seed=0):
        super().__init__(batch_size)
        self.count, self.vocab, self.num_label = count, vocab, num_label
        self.feature, self.seed = feature, seed
        self.proj = np.random.RandomState(seed).randint(1, vocab,
                                                        size=(feature,))
        # the context current when the iterator is made: a fit on the
        # fused path fetches batches on a thread of its own
        self.ctx = mt.base.current_context()
        self.reset()

    @property
    def provide_data(self):
        return [mt.io.DataDesc("data", (self.batch_size, self.feature))]

    @property
    def provide_label(self):
        return [mt.io.DataDesc("label", (self.batch_size, self.num_label)),
                mt.io.DataDesc("label_weight",
                               (self.batch_size, self.num_label))]

    def reset(self):
        self._batch = 0
        self.rng = np.random.RandomState(self.seed + 1)

    def next(self):
        if self._batch >= self.count:
            raise StopIteration
        self._batch += 1
        B, L = self.batch_size, self.num_label
        x = np.zeros((B, self.feature), "f")
        label = np.zeros((B, L), "f")
        weight = np.zeros((B, L), "f")
        for i in range(B):
            bits = self.rng.choice(self.feature, 3, replace=False)
            x[i, bits] = 1.0
            true = int(self.proj[bits].sum() % self.vocab)
            noise = self.rng.randint(0, self.vocab, 4 * L)
            cand = [true] + [n for n in noise if n != true][:L - 1]
            order = self.rng.permutation(L)
            label[i] = np.asarray(cand, "f")[order]
            weight[i] = (np.arange(L)[order] == 0).astype("f")
        return mt.io.DataBatch(data=[mt.nd.array(x, ctx=self.ctx)],
                               label=[mt.nd.array(label, ctx=self.ctx),
                                      mt.nd.array(weight, ctx=self.ctx)],
                               pad=0)


class _NceAccuracy(mt.metric.EvalMetric):
    def __init__(self):
        super().__init__("nce-accuracy")

    def update(self, labels, preds):
        weight = labels[1].asnumpy()
        scores = preds[0].asnumpy()
        self.sum_metric += (scores.argmax(1) == weight.argmax(1)).sum()
        self.num_inst += scores.shape[0]


def example_nce(epochs=15, batch=32, batches=20):
    """examples/nce-loss/train_nce_toy.py: Embedding-gathered candidate
    vectors against an FC representation, LogisticRegressionOutput over
    [true, noise...], Adam; NCE accuracy (its assert: > 0.8)."""
    net = nce_symbol(mt.sym)
    train = _NceIter(batches, batch)
    mod = mt.mod.Module(net, context=mt.base.current_context(),
                        data_names=("data",),
                        label_names=("label", "label_weight"))
    metric = _NceAccuracy()
    mod.fit(train, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": 0.02},
            initializer=mt.init.Xavier(), eval_metric=metric)
    train.reset()
    metric.reset()
    for b in train:
        mod.forward(b, is_train=False)
        metric.update(b.label, mod.get_outputs())
    acc = metric.get()[1]
    return {"nce_accuracy": acc}, acc > 0.8, _example_params(mod)


def example_matrix_fact(epochs=20, batch=64):
    """examples/recommenders/matrix_fact_toy.py: user and item Embedding
    tables, their product summed, LinearRegressionOutput, Adam; training
    rmse (its assert: < 0.5)."""
    users_n, items_n, rank = 40, 30, 6
    net = matrix_fact_symbol(mt.sym, users_n, items_n, rank)
    rng = np.random.RandomState(0)
    U = rng.normal(0, 1, (users_n, rank)).astype("f")
    V = rng.normal(0, 1, (items_n, rank)).astype("f")
    users = rng.randint(0, users_n, 2048).astype("f")
    items = rng.randint(0, items_n, 2048).astype("f")
    scores = (U[users.astype(int)] * V[items.astype(int)]).sum(1) \
        + rng.normal(0, 0.05, 2048).astype("f")
    it = mt.io.NDArrayIter({"user": users.reshape(-1, 1),
                            "item": items.reshape(-1, 1)},
                           {"score_label": scores.astype("f")
                            .reshape(-1, 1)},
                           batch_size=batch, shuffle=True)
    mod = mt.mod.Module(net, context=mt.base.current_context(),
                        data_names=("user", "item"),
                        label_names=("score_label",))
    mod.fit(it, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": 0.02},
            initializer=mt.init.Normal(0.3), eval_metric="rmse")
    it.reset()
    metric = mt.metric.create("rmse")
    for b in it:
        mod.forward(b, is_train=False)
        metric.update(b.label, mod.get_outputs())
    rmse = metric.get()[1]
    return {"rmse": rmse}, rmse < 0.5, _example_params(mod)


def example_dec(update_interval=4, rounds=40):
    """examples/dec/dec_toy.py: an autoencoder-pretrained encoder,
    k-means centroids, then self-training on KL(P || Q) under MakeLoss
    with a BlockGrad'd Q in a Group, the encoder read through
    ``Symbol.bind``'s Executor; cluster accuracy (its asserts: > 0.9
    and no regression from the first round)."""
    dim, latent, centers, alpha = 16, 2, 3, 1.0
    ctx = mt.base.current_context()

    def target(q):
        w = (q ** 2) / q.sum(0)
        return (w.T / w.sum(1)).T

    def cluster_acc(pred, truth):
        from itertools import permutations
        return max((np.asarray(perm)[pred] == truth).mean()
                   for perm in permutations(range(centers)))

    rng = np.random.RandomState(0)
    means = np.asarray([[0, 0], [2.2, 2.2], [0, 2.8]], "f")
    y = rng.randint(0, centers, 300)
    lat = means[y] + rng.normal(0, 0.55, (300, 2)).astype("f")
    proj = rng.normal(0, 1, (2, dim)).astype("f")
    x = (lat @ proj + rng.normal(0, 0.05, (300, dim))).astype("f")
    # autoencoder pretrain of the encoder
    h = mt.sym.Activation(mt.sym.FullyConnected(
        dec_encoder_symbol(mt.sym, latent), num_hidden=16, name="dec1"),
        act_type="relu")
    ae = mt.sym.LinearRegressionOutput(
        mt.sym.FullyConnected(h, num_hidden=dim, name="dec2"),
        mt.sym.Variable("rec_label"), name="rec")
    it = mt.io.NDArrayIter(x, x.copy(), batch_size=32, shuffle=True,
                           label_name="rec_label")
    mod = mt.mod.Module(ae, label_names=("rec_label",), context=ctx)
    mod.fit(it, num_epoch=30, optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            initializer=mt.init.Xavier())
    enc_args = {k: v for k, v in mod.get_params()[0].items()
                if k.startswith("enc")}
    z = dec_encoder_symbol(mt.sym, latent).bind(ctx, args={
        "data": mt.nd.array(x, ctx=ctx),
        **{k: mt.nd.array(v.asnumpy(), ctx=ctx)
           for k, v in enc_args.items()}}).forward()[0].asnumpy()
    cent = z[rng.choice(len(z), centers, replace=False)]
    for _ in range(20):
        assign = ((z[:, None] - cent[None]) ** 2).sum(-1).argmin(1)
        for j in range(centers):
            if (assign == j).any():
                cent[j] = z[assign == j].mean(0)
    mod = mt.mod.Module(dec_symbol(mt.sym, centers, latent, alpha),
                        context=ctx, label_names=("p_label",))
    batch = len(x)
    mod.bind(data_shapes=[("data", (batch, dim))],
             label_shapes=[("p_label", (batch, centers))])
    mod.init_params(mt.init.Xavier())
    mod.set_params({**{k: mt.nd.array(v.asnumpy())
                       for k, v in enc_args.items()},
                    "dec_mu_weight": mt.nd.array(cent)}, {},
                   allow_missing=True)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01,
                                         "momentum": 0.9,
                                         "rescale_grad": 1.0 / batch})
    p = np.ones((batch, centers), "f") / centers
    acc0 = None
    for r in range(rounds):
        if r % update_interval == 0:
            mod.forward(mt.io.DataBatch(data=[mt.nd.array(x)],
                                        label=[mt.nd.array(p)], pad=0),
                        is_train=False)
            q = mod.get_outputs()[0].asnumpy()
            p = target(q).astype("f")
            acc0 = cluster_acc(q.argmax(1), y) if acc0 is None else acc0
        mod.forward(mt.io.DataBatch(data=[mt.nd.array(x)],
                                    label=[mt.nd.array(p)], pad=0),
                    is_train=True)
        mod.backward()
        mod.update()
    mod.forward(mt.io.DataBatch(data=[mt.nd.array(x)],
                                label=[mt.nd.array(p)], pad=0),
                is_train=False)
    acc = cluster_acc(mod.get_outputs()[0].asnumpy().argmax(1), y)
    return ({"cluster_accuracy_first_round": acc0, "cluster_accuracy": acc},
            acc > 0.9 and acc >= acc0, _example_params(mod))


LOSS_EXAMPLES = [("fcn-xs", example_fcnxs),
                 ("autoencoder", example_autoencoder),
                 ("svm_mnist", example_svm),
                 ("nce-loss", example_nce),
                 ("recommenders", example_matrix_fact),
                 ("dec", example_dec)]


def run_example(fn, ctx, fused):
    """``fn`` under ``ctx`` from mt.random.seed(SEED), its modules on
    Module's ``fused`` policy (``MXTPU_MODULE_FUSED``): (score, its
    assert held, parameters on the host, seconds)."""
    mt.random.seed(SEED)
    t0 = time.perf_counter()
    with _fused_policy(fused), ctx:
        score, ok, params = fn()
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    return score, bool(ok), params, time.perf_counter() - t0


# (run, context, MXTPU_MODULE_FUSED): the card's default path (the fused
# Trainer, a CUDA graph a step) and the classic executor path, each on
# the card and on the port's CPU
EXAMPLE_RUNS = (("card_fused", "gpu", "auto"), ("cpu_fused", "cpu", "always"),
                ("card_classic", "gpu", "never"),
                ("cpu_classic", "cpu", "never"))


def loss_examples(card):
    """Each loss-layer example at its own size on both of Module's paths
    (EXAMPLE_RUNS), on the card and on the port's CPU: its end-of-run
    score against its own assert in all four runs, and, on each path, the
    largest relative norm between the card's and the CPU's parameters
    within EXAMPLE_PARAM_TOL.  The gap between the two paths (the fused
    Adam rule forms its bias correction in float32, the classic update in
    float64) is reported.  Returns (launches, records)."""
    _phase("loss_examples")
    reset_launch_counts()
    records, bad = [], []
    for name, fn in LOSS_EXAMPLES:
        runs = {run: run_example(fn, mt.Context(dev), policy)
                for run, dev, policy in EXAMPLE_RUNS}
        rec = {"example": name, "card": card,
               "scores": {run: r[0] for run, r in runs.items()},
               "asserts_held": {run: r[1] for run, r in runs.items()},
               "seconds": {run: r[3] for run, r in runs.items()}}
        for label, a, b in (("fused", "card_fused", "cpu_fused"),
                            ("classic", "card_classic", "cpu_classic"),
                            ("card_fused_vs_classic", "card_fused",
                             "card_classic")):
            rel = _rel_norms(runs[a][2], runs[b][2])
            worst = max(rel, key=rel.get)
            rec[label] = {"param_rel_err_max": rel[worst],
                          "worst_param": worst}
        _emit({"loss_examples": rec})
        print("loss_examples %s: fused card %s, CPU %s (parameters %.2e "
              "apart, %s); classic card %s, CPU %s (%.2e, %s); tolerance "
              "%g; asserts %s; the card's two paths %.2e apart; s %s" % (
                  name, rec["scores"]["card_fused"],
                  rec["scores"]["cpu_fused"],
                  rec["fused"]["param_rel_err_max"],
                  rec["fused"]["worst_param"],
                  rec["scores"]["card_classic"],
                  rec["scores"]["cpu_classic"],
                  rec["classic"]["param_rel_err_max"],
                  rec["classic"]["worst_param"], EXAMPLE_PARAM_TOL,
                  rec["asserts_held"],
                  rec["card_fused_vs_classic"]["param_rel_err_max"],
                  {k: round(v, 1) for k, v in rec["seconds"].items()}),
              flush=True)
        records.append(rec)
        if not (all(rec["asserts_held"].values())
                and rec["fused"]["param_rel_err_max"] <= EXAMPLE_PARAM_TOL
                and rec["classic"]["param_rel_err_max"]
                <= EXAMPLE_PARAM_TOL):
            bad.append(name)
    counts = launch_counts()
    if bad:
        raise AssertionError("loss_examples failed %s: %s" % (bad, records))
    expect_launches("loss_examples", counts)
    return counts, records


# ----------------------------------------------------------------------
# op_sweep_card: tests/test_op_sweep.py's case table on the card
def op_sweep_cases():
    """The op-sweep case table, read from ``tests/test_op_sweep.py`` in
    place: its statements up to the first function that binds a symbol,
    run without its imports of the JAX package (the table itself is
    numpy)."""
    import ast
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_op_sweep.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    body = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "_build_symbol":
            break
        mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
            else [node.module or ""] if isinstance(node, ast.ImportFrom) \
            else []
        if any(m.split(".")[0] == "mxnet_tpu" for m in mods):
            continue
        body.append(node)
    ns = {"__name__": "_op_sweep_table"}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns["CASES"]


def _op_run(case, device, cots=None, rng=None):
    """The port's op of ``case`` on ``device``, float32, with autograd:
    (outputs, new aux, gradients of every input) on the host."""
    from mxnet_tpu_torch.op import registry as treg
    op = treg.get(case["op"])
    p = op.parse_params(dict(case["params"]))
    is_train = case["kind"] == "grad"
    ctx = treg.OpContext(is_train=is_train, record=True, device=device,
                         rng=rng)
    xs = [torch.from_numpy(np.asarray(v, np.float32)).to(device)
          .requires_grad_() for v in case["loc"].values()]
    aux = [torch.from_numpy(np.asarray(v, np.float32)).to(device)
           for v in (case["aux"] or {}).values()]
    outs, new_aux = op.apply(p, ctx, *xs, *aux)
    grads = []
    if cots is not None:
        heads = [(o, torch.from_numpy(c).to(device, o.dtype))
                 for o, c in zip(outs, cots) if o.requires_grad]
        got = torch.autograd.grad([h for h, _ in heads], xs,
                                  [c for _, c in heads],
                                  allow_unused=True) \
            if heads and xs else [None] * len(xs)
        grads = [(torch.zeros_like(x) if g is None else g).detach().cpu()
                 for x, g in zip(xs, got)]
    return ([o.detach().float().cpu() for o in outs],
            [a.detach().float().cpu() for a in new_aux], grads)


def _imdecode_on_card():
    """The table's imperative ``_imdecode`` case on the card: its 4 x 6
    RGB image as PNG bytes in a card NDArray, decoded back exactly, onto
    the card."""
    import io
    from PIL import Image
    img = (np.arange(4 * 6 * 3) % 255).astype("uint8").reshape(4, 6, 3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    raw = np.frombuffer(buf.getvalue(), dtype=np.uint8).astype("f")
    out = mt.nd._imdecode(mt.nd.array(raw, ctx=mt.gpu(0)))
    return out.data.is_cuda and np.array_equal(out.asnumpy(), img)


IMPERATIVE_ON_CARD = {"_imdecode": _imdecode_on_card}


def op_sweep_card(card):
    """Every case of tests/test_op_sweep.py's table, forward and backward
    on the card in float32 against the port's CPU (the same random head
    gradients), within the case's own tolerance (a gradient case's
    rtol/atol, a forward case's 1e-3/1e-4); a sampler by its case's
    check on the card's draw; the imperative ``_imdecode`` case decoded
    onto the card.  Prints the worst relative error per op family (the
    op's module).  Returns (launches, record)."""
    from mxnet_tpu_torch.op import registry as treg
    _phase("op_sweep_card")
    cases = op_sweep_cases()
    run = [c for c in cases
           if c["op"] in treg._REGISTRY or c["op"] in treg._ALIASES]
    reset_launch_counts()
    t0 = time.perf_counter()
    worst, failed = {}, []
    cuda = torch.device("cuda")
    for case in run:
        op = treg.get(case["op"])
        family = op.fn.__module__.rsplit(".", 1)[-1]
        if case["kind"] == "imp":
            if not IMPERATIVE_ON_CARD[case["op"]]():
                failed.append(case["id"])
            continue
        if op.uses_rng and not case["loc"]:
            gen = torch.Generator(device=cuda).manual_seed(SEED)
            out, _, _ = _op_run(case, cuda, rng=gen)
            if not case["check"](out[0].numpy()):
                failed.append(case["id"])
            continue
        if case["kind"] == "grad":
            rtol, atol = case["rtol"], case["atol"]
        else:
            rtol, atol = 1e-3, 1e-4
        outs, _, _ = _op_run(case, torch.device("cpu"))
        rng = np.random.default_rng(1)
        cots = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
                for o in outs]
        want = _op_run(case, torch.device("cpu"), cots)
        got = _op_run(case, cuda, cots)
        err = 0.0
        for g_list, w_list in zip(got, want):
            for g, w in zip(g_list, w_list):
                g, w = g.double(), w.double()
                if g.shape != w.shape or not torch.allclose(
                        g, w, rtol=rtol, atol=atol, equal_nan=True):
                    failed.append(case["id"])
                if g.numel():
                    err = max(err, float((g - w).abs().max())
                              / max(float(w.abs().max()), 1.0))
        worst[family] = max(worst.get(family, 0.0), err)
    counts = launch_counts()
    record = {"cases": len(run), "table_cases": len(cases),
              "not_registered": sorted({c["op"] for c in cases} -
                                       {c["op"] for c in run}),
              "worst_rel_err_by_family": worst, "failed": failed,
              "launches": counts, "seconds": time.perf_counter() - t0,
              "card": card}
    _emit({"op_sweep_card": record})
    print("op_sweep_card: %d of %d cases on the card against the CPU in "
          "%.1f s; worst relative error by family %s; failed %s" % (
              len(run), len(cases), record["seconds"],
              {k: "%.1e" % v for k, v in worst.items()}, failed), flush=True)
    if failed or len(run) != len(cases):
        raise AssertionError("op_sweep_card gave %s" % record)
    return counts, record


# ----------------------------------------------------------------------
# open-loop load: tools/serve_bench.py's arrival engine, ported
def arrival_schedule(n, rate_rps, seed):
    """``n`` cumulative Poisson arrival times at ``rate_rps``, seeded:
    the same seed at any rate gives the same sequence, rescaled."""
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def single_request_rate(pred, x, n):
    """The pre-server path (``serve_bench``'s capacity): one Predictor,
    one request at a time, each read back to the host; requests/s and
    latency percentiles over ``n`` requests after 5 warm-ups, and the
    median ms of the forward and of the read-back (into pageable host
    memory, as ``np.asarray`` reads back) apart."""
    for _ in range(5):
        pred.predict(data=x)[0].cpu()
    lat, fwd = [], []
    t0 = time.perf_counter()
    for _ in range(n):
        t1 = time.perf_counter()
        out = pred.predict(data=x)[0]
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t1)
        out.cpu()
        lat.append(time.perf_counter() - t1)
    elapsed = time.perf_counter() - t0
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    return {"requests": n, "rps": n / elapsed,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "forward_p50_ms": statistics.median(fwd) * 1e3,
            "read_back_p50_ms": statistics.median(
                b - a for a, b in zip(fwd, lat)) * 1e3}


def open_loop(server, payloads, rate_rps, model, seed=2, deadline_s=None,
              shed=()):
    """Submit ``payloads`` on a seeded Poisson schedule at ``rate_rps``,
    honoured however far the server falls behind; submits refused with
    one of ``shed`` are counted and timed.  A thread beside settles the
    futures in order and keeps only their latency, so results (the LM's
    logits) are dropped as soon as they are read.  ``hung`` counts
    futures not settled within 120 s."""
    arrivals = arrival_schedule(len(payloads), rate_rps, seed)
    pending = queue.Queue()
    lat, tally = [], {"in_deadline": 0, "late": 0, "failed": 0, "hung": 0}

    def settle():
        while True:
            f = pending.get()
            if f is None:
                return
            try:
                exc = f.exception(timeout=120)
            except mt.serving.ServeTimeout:
                tally["hung"] += 1
                continue
            if exc is not None:
                tally["failed"] += 1
                continue
            lat.append(f.latency_s)
            late = deadline_s is not None and f.latency_s > deadline_s
            tally["late" if late else "in_deadline"] += 1

    settler = threading.Thread(target=settle, name="load-settle")
    settler.start()
    accepted = rejected = 0
    reject_max_ms = 0.0
    t0 = time.perf_counter()
    i = 0
    try:
        while i < len(payloads):
            now = time.perf_counter() - t0
            while i < len(payloads) and arrivals[i] <= now:
                ts = time.perf_counter()
                try:
                    pending.put(server.submit({"data": payloads[i]},
                                              model=model))
                    accepted += 1
                except shed:
                    rejected += 1
                    reject_max_ms = max(reject_max_ms,
                                        (time.perf_counter() - ts) * 1e3)
                i += 1
            if i < len(payloads):
                time.sleep(min(0.002, max(0.0, arrivals[i]
                                          - (time.perf_counter() - t0))))
        submit_s = time.perf_counter() - t0
    finally:
        pending.put(None)
        settler.join()
    elapsed = time.perf_counter() - t0
    n = len(payloads)
    completed = tally["in_deadline"] + tally["late"]
    out = {"offered_rps": rate_rps, "arrived_rps": n / submit_s,
           "requests": n, "rows": int(sum(p.shape[0] for p in payloads)),
           "accepted": accepted, "rejected_at_submit": rejected,
           "reject_max_ms": reject_max_ms, "completed": completed,
           "completed_in_deadline": tally["in_deadline"],
           "completed_late": tally["late"], "failed": tally["failed"],
           "hung": tally["hung"], "served_rps": completed / elapsed,
           "goodput_rps": tally["in_deadline"] / elapsed,
           "shed_rate": (rejected + tally["failed"] + tally["late"]) / n,
           "elapsed_s": elapsed}
    if lat:
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        out.update(p50_ms=float(np.percentile(lat_ms, 50)),
                   p99_ms=float(np.percentile(lat_ms, 99)))
    return out


def settled(run):
    """Every accepted request of a run settled: served or failed."""
    return run["hung"] == 0 and run["accepted"] == run["completed"] \
        + run["failed"]


def overload_probe(make_server, model, make_rows, capacity_rps,
                   load_factors=(1.0, 4.0), per_load=250, deadline_ms=250,
                   queue_cap=64, seed=0):
    """``serve_bench``'s goodput-under-overload sweep: single-row
    requests offered at each multiple of ``capacity_rps`` to a fresh
    server (``make_server(**policy)``) with the ``reject`` policy, a
    bounded queue and a per-request deadline.  Reports goodput per load
    and the JAX bench's verdict (goodput at the highest load >= 0.9x the
    goodput at the lowest)."""
    loads = []
    for f in sorted(load_factors):
        server = make_server(queue_cap=queue_cap, shed_policy="reject",
                             timeout_ms=deadline_ms)
        with server:
            rng = np.random.default_rng(seed + int(f * 10))
            payloads = [make_rows(rng, 1) for _ in range(per_load)]
            run = open_loop(server, payloads, max(1.0, f * capacity_rps),
                            model, deadline_s=deadline_ms / 1e3,
                            shed=(mt.serving.ServeOverload,
                                  mt.serving.ServeUnavailable))
            server.assert_no_retrace()
            st = server.stats()
        run.update(load_factor=f, shed_deadline=st["shed_deadline"],
                   expired_after_dispatch=st["expired_after_dispatch"])
        loads.append(run)
    g1, gmax = loads[0]["goodput_rps"], loads[-1]["goodput_rps"]
    return {"policy": {"shed_policy": "reject", "queue_cap_rows": queue_cap,
                       "deadline_ms": deadline_ms},
            "single_request_rps": capacity_rps, "loads": loads,
            "base_load_factor": loads[0]["load_factor"],
            "degradation_ratio": gmax / g1 if g1 else None,
            "degradation_ok": bool(g1 and gmax >= 0.9 * g1),
            "retraces": 0}


def times(latencies):
    """Kernel, plain and library times at the serving shapes; returns
    each attention kernel's record by (kernel, dtype), the kernels "K1"
    and "B2"."""
    _phase("times")
    b, t, h = BATCH, GPT2_SMALL["seq_len"], GPT2_SMALL["num_heads"]
    d = GPT2_SMALL["num_hidden"] // h
    records = {}
    for dtype in DTYPES:
        q, k, v = _qkv(b, t, t, h, d, dtype, seed=100)
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
        plain_ms = cuda_ms(
            lambda: fa.attention_reference(q, k, v, causal=True))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True))
        bound_ms, bound_by = attention_bound(b, t, t, h, d, True, dtype)
        line = {"kernel": K1_SOURCES[dtype], "dtype": str(dtype),
                "shape": [b, t, t, h, d], "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "x_library": ms / library_ms,
                "share_of_bound": bound_ms / ms}
        _emit(line)
        records["K1", dtype] = line

        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        g = torch.Generator(device="cuda").manual_seed(101)
        do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
        ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal=True))
        plain_ms = cuda_ms(lambda: fa.attention_bwd_reference(
            q, k, v, o, lse, do, causal=True))
        # SDPA's backward alone: its forward once, then the gradients
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        do_t = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do_t, retain_graph=True))
        bound_ms, bound_by = attention_bound(b, t, t, h, d, True, dtype,
                                             backward=True)
        line = {"kernel": B2_SOURCES[dtype], "dtype": str(dtype),
                "shape": [b, t, t, h, d], "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "x_library": ms / library_ms,
                "share_of_bound": bound_ms / ms}
        _emit(line)
        records["B2", dtype] = line
        del out, leaves
    steady = statistics.median(latencies[1:])
    _emit({"predictor": "gpt2-small", "batch": BATCH, "seq_len": t,
           "steady_latency_s": steady, "requests_per_s": 1.0 / steady,
           "tokens_per_s": BATCH * t / steady,
           "steady_latency_range_s": [min(latencies[1:]), max(latencies[1:])],
           "first_request_s": latencies[0]})
    return records


def rtc_times():
    """rtc kernels at size, their torch-language versions and the one
    PyTorch call of the same function; the host cost of one push.
    Returns the GELU's record."""
    _phase("rtc times")
    g = torch.Generator(device="cuda").manual_seed(11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = {}

    x = mt.nd.NDArray(torch.randn(AXPY_N, generator=g, device="cuda"))
    a = mt.nd.NDArray(torch.full((1,), 0.75, device="cuda"))
    y, ry = (mt.nd.empty((AXPY_N,), ctx=mt.gpu()) for _ in range(2))
    one = torch.ones((), device="cuda")
    cuda, plain = rtc_pair("axpy", [("x", x), ("alpha_", a)], [("y", y)],
                           AXPY_STRIDED)
    dims = dict(grid_dims=(sms * 8, 1, 1), block_dims=(256, 1, 1))
    err = _push_checked(cuda, plain, [x, a], [y], [ry],
                        RTC_TOL[torch.float32], **dims)
    bound_ms, bound_by = elementwise_bound(AXPY_N, 2, 2)
    records["axpy"] = {
        "shape": [AXPY_N], "grid": dims["grid_dims"], "max_abs_err": err,
        "ms": cuda_ms(lambda: cuda.push([x, a], [y], **dims)),
        "plain_ms": cuda_ms(lambda: plain.push([x, a], [ry])),
        "library_ms": cuda_ms(lambda: torch.addcmul(one, a.data, x.data)),
        "bound_ms": bound_ms, "bound_by": bound_by}
    del x, y, ry

    rows = BATCH * GPT2_SMALL["seq_len"]
    cols = 4 * GPT2_SMALL["num_hidden"]
    x = mt.nd.NDArray(torch.randn(rows, cols, generator=g, device="cuda"))
    y, ry = (mt.nd.empty((rows, cols), ctx=mt.gpu()) for _ in range(2))
    # the imperative block's GELU (GELU_VEC4), and the same body with one
    # scalar element per thread beside it
    scalar, plain = rtc_pair("gelu_tanh", [("x", x)], [("y", y)], GELU)
    cuda = Rtc("gelu_tanh_vec4", [("x", x)], [("y", y)], GELU_VEC4[0])
    dims = vec4_dims(rows * cols)
    scalar_err = _push_checked(scalar, plain, [x], [y], [ry],
                               RTC_TOL[torch.float32])
    err = _push_checked(cuda, plain, [x], [y], [ry],
                        RTC_TOL[torch.float32], **dims)
    # 8 float operations and one tanh per element
    bound_ms, bound_by = elementwise_bound(rows * cols, 2, 9)
    records["gelu"] = {
        "shape": [rows, cols], "body": "gelu_tanh_vec4", "max_abs_err": err,
        "ms": cuda_ms(lambda: cuda.push([x], [y], **dims)),
        "scalar_body_ms": cuda_ms(lambda: scalar.push([x], [y])),
        "scalar_body_max_abs_err": scalar_err,
        "plain_ms": cuda_ms(lambda: plain.push([x], [ry])),
        "library_ms": cuda_ms(lambda: F.gelu(x.data, approximate="tanh")),
        "bound_ms": bound_ms, "bound_by": bound_by}
    del x, y, ry

    x8 = mt.nd.NDArray(torch.randn(8, 8, generator=g, device="cuda"))
    y8 = mt.nd.empty((8, 8), ctx=mt.gpu())
    k = Rtc("scale2", [("x", x8)], [("y", y8)], SCALE2[0])
    host_us = {}
    for name, fn in (("rtc_push", lambda: k.push([x8], [y8])),
                     ("torch_add", lambda: torch.add(x8.data, 1.0))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host_us[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    records["host_us_per_call_8x8"] = host_us
    for name, rec in records.items():
        _emit({"rtc_times": name, **rec})
    return records["gelu"]


# ----------------------------------------------------------------------
# data-parallel training over worker processes, several contexts in one
# Module, and the fused step's remat policies
ROOT = os.path.dirname(os.path.abspath(__file__))
DIST_TIMEOUT_S = 600
# the collective's kernels in a traced replay: NCCL's, and the one-rank
# reduce NCCL launches for a PREMUL_SUM over one rank
DIST_KERNEL_RE = re.compile(r"nccl|onerank", re.IGNORECASE)
# dist_two_ranks_shared_card: each rank's rows of ResNet-50's global
# batch (bench.py's 256, two ranks on the card), the steps of each run,
# the steps of the classic runs (MLP, LeNet: batch DIST_SMALL_BATCH a
# step, global)
DIST_SHARED_BATCH, DIST_SHARED_STEPS = RESNET_BATCH // 2, 3
DIST_SMALL_BATCH, DIST_SMALL_STEPS = 64, 4
# the float32 runs against one process over the same global batches
# (relative norm over every parameter): each gradient summed over the
# ranks in another order
DIST_CLASSIC_TOL = 1e-5
# ResNet-50 in bfloat16 against one process over the whole global batch,
# after its first step and after DIST_SHARED_STEPS: each rank's weight
# gradients are rounded to bfloat16 before the float32 sum over the
# ranks, one process's once over every row.  Read 1.28e-3 and 9.04e-3
# on the card; normalising BatchNorm by each rank's rows reads 0.141
# after the first step
DIST_RESNET_TOL = (4e-3, 3e-2)
# the bfloat16 wire: each element of the summed gradient within 2^-8 of
# the float32 sum, relative to the sum of the ranks' magnitudes (two
# half-ulp roundings of bfloat16, lowp_allreduce's bound)
WIRE_TOL = 2.0 ** -8
MULTI_CONTEXT_TOL = 1e-5
REMAT_POLICIES = ("none", "convs_dots", "dots", "nothing")
REMAT_STEPS = 5          # an eager step, the capture, 3 replays
# each policy's first-step float32 gradients against none's on the same
# weights and batch (relative norm per parameter, the largest): the same
# bfloat16 work recomputed; bitwise in every chip run so far, and a
# recompute that drew other BatchNorm statistics would be far above it
REMAT_GRAD_TOL = {"gpt2-small": 1e-5, "resnet-50": 1e-5}
REMAT_DROPOUT_TOL = 1e-6


def _card_flags():
    """The float32 settings the environment phase makes, in a worker."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_workers(n, case, env=None):
    """``python tools/launch.py -n N --launcher local -- python3
    chip_smoke.py dist_child <case> <dir>``: the launcher's workers join
    one ``torch.distributed`` group at import (``env``: variables set for
    them).  Returns each rank's result (``<dir>/rank<r>.json``) and the
    wall seconds.  A worker that fails fails the phase; on a timeout the
    whole process group is killed."""
    out = tempfile.mkdtemp(prefix="mxtpu-dist-")
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"),
           "-n", str(n), "--launcher", "local", "--", sys.executable,
           os.path.abspath(__file__), "dist_child", case, out]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, start_new_session=True,
                            env=dict(os.environ, **(env or {})))
    try:
        code = proc.wait(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        shutil.rmtree(out, ignore_errors=True)
        raise AssertionError("%s: the workers ran past %d s"
                             % (case, DIST_TIMEOUT_S))
    try:
        if code != 0:
            raise AssertionError("%s: the launcher exited %d" % (case, code))
        results = []
        for r in range(n):
            with open(os.path.join(out, "rank%d.json" % r)) as f:
                results.append(json.load(f))
        return results, time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)


def dist_child(case, out):
    """A launcher's worker: run ``case`` and write this rank's result."""
    from mxnet_tpu_torch.parallel import collectives as coll
    _card_flags()
    rank = coll._process_index()
    res = DIST_CASES[case](out)
    res.update(rank=rank, world=coll._process_count(),
               backend=coll.backend(),
               device=torch.cuda.current_device())
    with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    coll.barrier()
    torch.distributed.destroy_process_group()


def _digest(tensors):
    """sha256 of the tensors' bytes in name order (bitwise comparison
    across processes)."""
    h = hashlib.sha256()
    for n in sorted(tensors):
        h.update(tensors[n].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _rel_all(got, want):
    """Relative norm of the difference over every array together."""
    num = sum(float((got[n].double() - want[n].double()).norm() ** 2)
              for n in want)
    den = sum(float(want[n].double().norm() ** 2) for n in want)
    return math.sqrt(num / den)


def _timed_fit(mod, data, kvstore):
    """``Module.fit`` of the ResNet cell, one epoch; the seconds of each
    step between synchronised ``batch_end_callback``s."""
    steps, last = [], {}

    def on_batch(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append(now - last["t"])
        last["t"] = now

    torch.cuda.synchronize()
    last["t"] = time.perf_counter()
    mod.fit(data, num_epoch=1, kvstore=kvstore, optimizer="sgd",
            optimizer_params=RESNET_SGD,
            initializer=mt.init.Xavier(**RESNET_INIT),
            eval_metric=mt.metric.CrossEntropy(),
            batch_end_callback=on_batch)
    return steps


def _dist_one_rank_nccl(out):
    """One rank over NCCL: the ResNet cell fit without a store, then with
    ``dist_sync_tpu``, whose fused step spans the one-rank mesh and
    issues its gradient sum in the captured graph."""
    from mxnet_tpu_torch.parallel import collectives as coll
    if (coll.backend(), coll._process_count()) != ("nccl", 1):
        raise AssertionError("one rank over NCCL expected, got %s over %d"
                             % (coll.backend(), coll._process_count()))
    res, params = {}, {}
    for kv in ("local", "dist_sync_tpu"):
        reset_launch_counts()
        mod, data, x, y, _ = resnet_cell(kvstore=kv)
        tr = mod._trainer
        steps = _timed_fit(mod, data, kv)
        params[kv] = {n: v.clone() for n, v in
                      list(tr.params.items()) + list(tr.aux.items())}
        rec = {"comm": tr._comm, "graph_captures": tr.graph_captures,
               "graph_replays": tr.graph_replays,
               "step_ms": statistics.median(steps[2:]) * 1e3,
               "img_per_s": RESNET_BATCH / statistics.median(steps[2:]),
               "launches": launch_counts()}
        if kv != "local":
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tr.step({"data": x, "softmax_label": y})
                torch.cuda.synchronize()
            names = sorted({e.key for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA})
            rec["kernels"] = len(names)
            rec["collective_kernels"] = [k for k in names
                                         if DIST_KERNEL_RE.search(k)]
        res[kv] = rec
        del mod, data, tr, x, y
        gc.collect()
        torch.cuda.empty_cache()
    a, b = params["local"], params["dist_sync_tpu"]
    res["bitwise"] = all(torch.equal(a[n], b[n]) for n in a)
    res["rel_err"] = _rel_all(b, a)
    return res


def _small_net(name):
    if name == "mlp":
        return _opt_mlp(), (784,)
    return mt.models.get_symbol("lenet", num_classes=10), (1, 28, 28)


def _small_data(name, steps, batch):
    """Batches and initial weights of the MLP or LeNet, numpy from SEED."""
    symbol, shape = _small_net(name)
    rng = np.random.default_rng(SEED + 5)
    x = rng.standard_normal((steps * batch,) + shape, dtype=np.float32)
    y = rng.integers(0, 10, steps * batch).astype(np.float32)
    shapes, _, _ = symbol.infer_shape(data=(batch,) + shape)
    init = {n: rng.standard_normal(s, dtype=np.float32) * np.float32(0.05)
            for n, s in zip(symbol.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    return symbol, x, y, init


def _small_fit(name, x, y, init, batch, kvstore, contexts=None):
    """``Module.fit`` of the MLP or LeNet on the classic path, one epoch;
    the trained parameters on the host."""
    symbol, _ = _small_net(name)
    with _fused_policy("never"):
        it = mt.io.NDArrayIter(x, y, batch_size=batch)
        mod = mt.mod.Module(symbol, context=contexts or mt.gpu())
        mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                arg_params={n: mt.nd.array(v) for n, v in init.items()})
    if mod._trainer is not None:
        raise AssertionError("the classic path was asked for")
    arg, _ = mod.get_params()
    return mod, {n: v.data.clone().cpu() for n, v in arg.items()}


def _rows(a, rank, n, batch):
    """Rank ``rank``'s rows of every global batch of ``a``."""
    per = batch // n
    return np.concatenate([a[s * batch + rank * per:
                             s * batch + (rank + 1) * per]
                           for s in range(len(a) // batch)])


def _resnet_dist_trainer(zero, wire, batch, mesh=True):
    """The ResNet cell's fused Trainer at ``batch`` rows a rank, over the
    two-rank mesh (or alone), its gradients scaled by the global batch."""
    mt.random.seed(SEED)
    tr = mt.parallel.Trainer(
        mt.models.get_symbol("resnet-50", **RESNET),
        mt.optimizer.create("sgd", rescale_grad=1.0 / (2 * DIST_SHARED_BATCH),
                            **RESNET_SGD),
        mesh=mt.parallel.data_parallel_mesh() if mesh else None,
        zero=zero, grad_dtype=wire, compute_dtype="bfloat16")
    tr.bind(data_shapes={"data": (batch, RESNET_IMAGE, RESNET_IMAGE, 3)},
            label_shapes={"softmax_label": (batch,)})
    tr.init_params(mt.init.Xavier(**RESNET_INIT))
    return tr


def _wire_check(batch):
    """The bfloat16 wire against the float32 sum on the first batch:
    every element's error relative to the sum of the ranks' magnitudes."""
    tr = _resnet_dist_trainer(0, "bf16", DIST_SHARED_BATCH)
    batch_dev = tr._device_batch(batch)
    with torch.no_grad():
        aux = [tr.aux[n] for n in tr.aux_names]
        with mt.parallel.trainer._float32_sums():
            _, _, g = tr._accum_backward(tr.params, aux, batch_dev, None)
        wire = tr._lowp_sum(g)
        exact = tr._allreduce_flat(g)
        mag = tr._allreduce_flat({n: v.abs() for n, v in g.items()})
    worst = max(float(((wire[n] - exact[n]).abs()
                       / mag[n].clamp(min=1e-30)).max()) for n in g)
    del tr, g, wire, exact, mag
    return worst


def _dist_two_ranks_shared(out):
    """Two ranks over gloo on one card: the classic dist_sync path on the
    MLP and LeNet, the fused step over the two-rank mesh on ResNet-50 at
    zero 0 and 1 and with the bfloat16 wire (uncaptured: the host-side
    collective)."""
    from mxnet_tpu_torch.parallel import collectives as coll
    rank, n = coll._process_index(), coll._process_count()
    if (coll.backend(), n, torch.cuda.current_device()) != ("gloo", 2, 0):
        raise AssertionError("two ranks over gloo on card 0 expected")
    res = {}
    for name in ("mlp", "lenet"):
        symbol, x, y, init = _small_data(name, DIST_SMALL_STEPS,
                                         DIST_SMALL_BATCH)
        per = DIST_SMALL_BATCH // n
        t0 = time.perf_counter()
        _, got = _small_fit(name, _rows(x, rank, n, DIST_SMALL_BATCH),
                            _rows(y, rank, n, DIST_SMALL_BATCH), init, per,
                            "dist_sync")
        rec = {"digest": _digest(got), "fit_s": time.perf_counter() - t0}
        coll.barrier()
        if rank == 0:
            _, one = _small_fit(name, x, y, init, DIST_SMALL_BATCH, "local")
            rec["rel_err_vs_one_process"] = _rel_all(got, one)
        coll.barrier()
        res[name] = rec
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b = DIST_SHARED_BATCH
    x = torch.randn((2 * b, RESNET_IMAGE, RESNET_IMAGE, 3), generator=gen,
                    device="cuda")
    y = torch.randint(0, RESNET["num_classes"], (2 * b,), generator=gen,
                      device="cuda", dtype=torch.int32)
    mine = {"data": x[rank * b:(rank + 1) * b],
            "softmax_label": y[rank * b:(rank + 1) * b]}
    res["wire_err_max"] = _wire_check(mine)
    for zero, wire in ((0, "f32"), (1, "f32"), (0, "bf16")):
        tr = _resnet_dist_trainer(zero, wire, b)
        steps, comm = [], []
        for _ in range(DIST_SHARED_STEPS):
            torch.cuda.synchronize()
            c0, t0 = tr.comm_s, time.perf_counter()
            tr.step(mine)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            comm.append(tr.comm_s - c0)
        res["z%d_%s" % (zero, wire)] = {
            "digest": _digest(dict(list(tr.params.items())
                                   + list(tr.aux.items()))),
            "step_ms": [t * 1e3 for t in steps],
            "comm_ms": [c * 1e3 for c in comm],
            "comm_share": sum(comm[1:]) / sum(steps[1:]),
            "graph_captures": tr.graph_captures,
            "state_bytes": tr.opt_state_bytes_per_chip(),
            "wire_bytes": tr.grad_comm_bytes_per_step()}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    res["deterministic"] = _shared_vs_one_process(mine, x, y)
    return res


def _shared_vs_one_process(mine, x, y):
    """The two-rank fused step (zero=0, float32 wire: BatchNorm over the
    whole global batch) against one process stepping the global batch,
    cuDNN's deterministic algorithms on both sides: the relative gap over
    every parameter after each step."""
    from mxnet_tpu_torch.parallel import collectives as coll
    torch.backends.cudnn.deterministic = True
    try:
        tr = _resnet_dist_trainer(0, "f32", DIST_SHARED_BATCH)
        ranks = []
        for _ in range(DIST_SHARED_STEPS):
            tr.step(mine)
            ranks.append({k: v.clone() for k, v in tr.params.items()})
        rec = {"digest": _digest(ranks[-1])}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        coll.barrier()
        if coll._process_index() == 0:
            whole = _resnet_dist_trainer(0, "f32", 2 * DIST_SHARED_BATCH,
                                         mesh=False)
            gaps = []
            for ours in ranks:
                whole.step({"data": x, "softmax_label": y})
                gaps.append(_rel_all(ours, whole.params))
            rec["whole_batch_rel_err"] = gaps
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        coll.barrier()
    finally:
        torch.backends.cudnn.deterministic = False
    return rec


def _conv_bn_symbol():
    """A convolution, BatchNorm and a head: under a data mesh's float32
    wire BatchNorm sums its statistics over the ranks inside the
    captured step."""
    net = mt.sym.Convolution(mt.sym.Variable("data"), num_filter=16,
                             kernel=(3, 3), pad=(1, 1), layout="NHWC",
                             name="c1")
    net = mt.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(mt.sym.Flatten(net), num_hidden=10,
                                name="fc")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def _across_cards_trainer(name, batch, **kw):
    """The MLP's or the convolution-BatchNorm net's fused float32 Trainer
    at ``batch`` rows, from the same weights on every rank."""
    if name == "mlp":
        symbol, _, _, init = _small_data("mlp", DIST_SMALL_STEPS,
                                         DIST_SMALL_BATCH)
        shape = (784,)
    else:
        symbol, shape = _conv_bn_symbol(), (8, 8, 3)
        rng = np.random.default_rng(SEED + 6)
        shapes, _, _ = symbol.infer_shape(data=(batch,) + shape)
        init = {n: rng.standard_normal(s, dtype=np.float32)
                * np.float32(0.1)
                for n, s in zip(symbol.list_arguments(), shapes)
                if n not in ("data", "softmax_label")}
    tr = mt.parallel.Trainer(
        symbol, mt.optimizer.create("sgd", learning_rate=0.05, momentum=0.9,
                                    rescale_grad=1.0 / DIST_SMALL_BATCH),
        **kw)
    tr.bind(data_shapes={"data": (batch,) + shape},
            label_shapes={"softmax_label": (batch,)})
    tr.init_params(arg_params=init)
    return tr


def _dist_ranks_across_cards(out):
    """A rank a card over NCCL: the MLP's fused step over the mesh of
    every rank at zero 0 and 1 and with the bfloat16 wire, and the
    convolution-BatchNorm net's at zero 0 and 1 (its statistics summed
    over the ranks inside the step), captured with their collectives;
    rank 0 also steps one process over the global batches."""
    from mxnet_tpu_torch.parallel import collectives as coll
    rank, n = coll._process_index(), coll._process_count()
    if (coll.backend(), torch.cuda.current_device()) != ("nccl", rank):
        raise AssertionError("NCCL with a card a rank expected")
    per = DIST_SMALL_BATCH // n
    res = {}
    for net in ("mlp", "conv_bn"):
        if net == "mlp":
            _, x, y, _ = _small_data("mlp", DIST_SMALL_STEPS,
                                     DIST_SMALL_BATCH)
        else:
            rng = np.random.default_rng(SEED + 7)
            x = rng.standard_normal((DIST_SMALL_STEPS * DIST_SMALL_BATCH,
                                     8, 8, 3), dtype=np.float32)
            y = rng.integers(0, 10, len(x)).astype(np.float32)
        xs = _rows(x, rank, n, DIST_SMALL_BATCH)
        ys = _rows(y, rank, n, DIST_SMALL_BATCH)
        one = None
        if rank == 0:
            tr = _across_cards_trainer(net, DIST_SMALL_BATCH)
            for s in range(DIST_SMALL_STEPS):
                b = DIST_SMALL_BATCH
                tr.step({"data": x[s * b:(s + 1) * b],
                         "softmax_label": y[s * b:(s + 1) * b]})
            one = dict(list(tr.params.items()) + list(tr.aux.items()))
        runs = ((0, "f32"), (1, "f32"), (0, "bf16")) if net == "mlp" \
            else ((0, "f32"), (1, "f32"))
        for zero, wire in runs:
            tr = _across_cards_trainer(
                net, per, mesh=mt.parallel.data_parallel_mesh(), zero=zero,
                grad_dtype=wire)
            for s in range(DIST_SMALL_STEPS):
                tr.step({"data": xs[s * per:(s + 1) * per],
                         "softmax_label": ys[s * per:(s + 1) * per]})
            mine = dict(list(tr.params.items()) + list(tr.aux.items()))
            rec = {"digest": _digest(mine),
                   "graph_captures": tr.graph_captures,
                   "graph_replays": tr.graph_replays}
            if one is not None:
                rec["rel_err_vs_one_process"] = _rel_all(mine, one)
            key = "z%d_%s" % (zero, wire)
            res[key if net == "mlp" else "%s_%s" % (net, key)] = rec
    return res


DIST_CASES = {"one_rank_nccl": _dist_one_rank_nccl,
              "two_ranks_shared": _dist_two_ranks_shared,
              "ranks_across_cards": _dist_ranks_across_cards}


def dist_one_rank_nccl(card, resnet_record):
    """``tools/launch.py -n 1``: one rank over NCCL trains the ResNet cell
    through ``Module.fit`` with ``dist_sync_tpu``.  Holds one capture,
    the NCCL all-reduce in a traced replay, and the parameters bitwise
    those of the same fit without a store (the sum over one rank is an
    identity)."""
    _phase("dist_one_rank_nccl")
    (res,), wall = run_workers(1, "one_rank_nccl")
    dist, local = res["dist_sync_tpu"], res["local"]
    record = {"dist_one_rank_nccl": "resnet-50 bf16 batch %d" % RESNET_BATCH,
              "backend": res["backend"], "comm": dist["comm"],
              "graph_captures": dist["graph_captures"],
              "collective_kernels": dist["collective_kernels"],
              "step_ms": dist["step_ms"], "img_per_s": dist["img_per_s"],
              "no_store_step_ms": local["step_ms"],
              "train_resnet_bf16_step_ms": resnet_record["step_ms"],
              "train_resnet_bf16_img_per_s": resnet_record["img_per_s"],
              "bitwise": res["bitwise"], "rel_err": res["rel_err"],
              "wall_s": wall, "card": card}
    _emit(record)
    print("dist_one_rank_nccl (%s): %s; step %.2f ms (%.1f img/s), without "
          "a store %.2f ms, train_resnet_bf16 %.2f ms (%.1f img/s); "
          "collective kernels in a replay: %s"
          % (card, res["backend"], dist["step_ms"], dist["img_per_s"],
             local["step_ms"], resnet_record["step_ms"],
             resnet_record["img_per_s"], dist["collective_kernels"]),
          flush=True)
    if not (dist["comm"] and dist["graph_captures"] == 1
            and local["graph_captures"] == 1
            and dist["collective_kernels"] and res["bitwise"]):
        raise AssertionError("dist_one_rank_nccl: %s" % record)
    for rec in (dist, local):
        expect_launches("dist_one_rank_nccl", rec["launches"])
    return dist["launches"], record


def dist_two_ranks_shared_card(card):
    """``tools/launch.py -n 2``: two ranks over gloo on one card.  Holds
    the ranks bitwise alike on every run; the classic runs within
    DIST_CLASSIC_TOL of one process over the same global batches, the
    fused ResNet-50 run within DIST_RESNET_TOL of one process stepping
    the global batch; zero=1 bitwise zero=0; the bfloat16 wire within
    WIRE_TOL a summed element."""
    _phase("dist_two_ranks_shared_card")
    ranks, wall = run_workers(2, "two_ranks_shared")
    r0, r1 = ranks
    runs = ("mlp", "lenet", "z0_f32", "z1_f32", "z0_bf16", "deterministic")
    alike = {k: r0[k]["digest"] == r1[k]["digest"] for k in runs}
    record = {"dist_two_ranks_shared_card": "two ranks, one card, gloo",
              "backends": [r["backend"] for r in ranks],
              "devices": [r["device"] for r in ranks],
              "ranks_bitwise": alike,
              "classic_rel_err": {k: r0[k]["rel_err_vs_one_process"]
                                  for k in ("mlp", "lenet")},
              "resnet_vs_one_process":
                  r0["deterministic"]["whole_batch_rel_err"],
              "zero1_bitwise_zero0":
                  r0["z1_f32"]["digest"] == r0["z0_f32"]["digest"],
              "wire_err_max": max(r["wire_err_max"] for r in ranks),
              "runs": {k: {f: r0[k][f] for f in (
                  "step_ms", "comm_ms", "comm_share", "graph_captures",
                  "state_bytes", "wire_bytes")}
                  for k in ("z0_f32", "z1_f32", "z0_bf16")},
              "classic_fit_s": {k: r0[k]["fit_s"] for k in ("mlp", "lenet")},
              "wall_s": wall, "card": card}
    _emit(record)
    one = record["resnet_vs_one_process"]
    print("dist_two_ranks_shared_card (%s): ranks bitwise %s; against one "
          "process, classic %s, resnet-50 over the global batch %s after "
          "each step (bounds %s after the first and the last); zero=1 "
          "bitwise zero=0 %s; bfloat16 wire %.4g of 2^-8"
          % (card, alike, record["classic_rel_err"],
             ["%.4g" % g for g in one], DIST_RESNET_TOL,
             record["zero1_bitwise_zero0"],
             record["wire_err_max"] / WIRE_TOL), flush=True)
    for k, rec in record["runs"].items():
        print("dist_two_ranks_shared_card %s (%s): steps %s ms, collectives "
              "%s ms, %.1f%% of a step after the first"
              % (k, card, ["%.1f" % v for v in rec["step_ms"]],
                 ["%.1f" % v for v in rec["comm_ms"]],
                 100 * rec["comm_share"]), flush=True)
    bad = [k for k, v in alike.items() if not v]
    if (bad or record["backends"] != ["gloo", "gloo"]
            or record["devices"] != [0, 0]
            or max(record["classic_rel_err"].values()) > DIST_CLASSIC_TOL
            or one[0] > DIST_RESNET_TOL[0] or one[-1] > DIST_RESNET_TOL[1]
            or not record["zero1_bitwise_zero0"]
            or record["wire_err_max"] > WIRE_TOL
            or any(r["graph_captures"] for r in record["runs"].values())):
        raise AssertionError("dist_two_ranks_shared_card: %s" % record)
    return record


def multi_context(card):
    """One process, ``Module(context=[gpu(0), gpu(0)])`` on the classic
    path (two executors on one card, each on half of every batch, their
    gradients merged by the store) against one context over the same
    batches, the MLP and LeNet."""
    _phase("multi_context")
    record = {"multi_context": "[gpu(0), gpu(0)] vs gpu(0)", "card": card}
    reset_launch_counts()
    for name in ("mlp", "lenet"):
        _, x, y, init = _small_data(name, DIST_SMALL_STEPS, DIST_SMALL_BATCH)
        two_mod, two = _small_fit(name, x, y, init, DIST_SMALL_BATCH, "local",
                                  contexts=[mt.gpu(0), mt.gpu(0)])
        if len(two_mod._exec_group.execs) != 2 or two_mod._kvstore is None:
            raise AssertionError("two contexts bound %d executors"
                                 % len(two_mod._exec_group.execs))
        _, one = _small_fit(name, x, y, init, DIST_SMALL_BATCH, "local")
        record[name] = _rel_all(two, one)
    _emit(record)
    print("multi_context (%s): mlp %.3g, lenet %.3g from one context"
          % (card, record["mlp"], record["lenet"]), flush=True)
    if max(record["mlp"], record["lenet"]) > MULTI_CONTEXT_TOL:
        raise AssertionError("multi_context: %s" % record)
    launches = launch_counts()
    expect_launches("multi_context", launches)
    return launches, record


def _remat_cells():
    """The two remat cells: (name, symbol, batch, optimizer, initial
    weights on the host)."""
    x, y = cyclic_tokens(BATCH, np.random.default_rng(SEED + 3), np.int32)
    lm = mt.models.transformer.get_symbol(**GPT2_SMALL)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    img = torch.randn((RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3),
                      generator=gen, device="cuda")
    lab = torch.randint(0, RESNET["num_classes"], (RESNET_BATCH,),
                        generator=gen, device="cuda", dtype=torch.int32)
    return [("gpt2-small", lm,
             {"data": torch.from_numpy(x).cuda(),
              "softmax_label": torch.from_numpy(y).cuda()},
             ("adam", {"learning_rate": TRAIN_LR}), mt.init.Xavier(
                 **TRAIN_INIT)),
            ("resnet-50", mt.models.get_symbol("resnet-50", **RESNET),
             {"data": img, "softmax_label": lab},
             ("sgd", dict(RESNET_SGD)), mt.init.Xavier(**RESNET_INIT))]


def _remat_trainer(symbol, batch, opt, policy, arg=None, init=None):
    name, kw = opt
    tr = mt.parallel.Trainer(
        symbol, mt.optimizer.create(
            name, rescale_grad=1.0 / batch["data"].shape[0], **kw),
        remat=policy, compute_dtype="bfloat16")
    tr.bind(data_shapes={"data": tuple(batch["data"].shape)},
            label_shapes={"softmax_label":
                          tuple(batch["softmax_label"].shape)})
    tr.init_params(init, arg_params=arg)
    return tr


def _mlp_block_batch():
    """A batch for GPT-2's MLP block, on the card, from SEED."""
    rng = np.random.default_rng(SEED)
    c = GPT2_SMALL["num_hidden"]
    return {"data": torch.from_numpy(rng.standard_normal(
                (BATCH * 64, c), dtype=np.float32)).cuda(),
            "softmax_label": torch.from_numpy(rng.integers(
                0, c, BATCH * 64).astype(np.float32)).cuda()}


def _donated_batch():
    """``donate_batch=True`` against a trainer that keeps its batches, on
    GPT-2's MLP block in bfloat16: REMAT_STEPS steps fed the rows of one
    on-card dataset in turn (views: left as they were), then one whole
    batch tensor (emptied after its step, its memory freed).  Returns
    (the dataset untouched and the whole batch given up, the parameters
    bitwise alike)."""
    batch = _mlp_block_batch()
    rows = batch["data"].shape[0] // 2
    data = {n: torch.cat([v, v.flip(0)]) for n, v in batch.items()}
    kept = {n: v.clone() for n, v in data.items()}
    params, given_up = {}, True
    for donate in (False, True):
        mt.random.seed(SEED)
        tr = mt.parallel.Trainer(
            _mlp_block_symbol(), mt.optimizer.create(
                "sgd", learning_rate=0.1, momentum=0.9,
                rescale_grad=1.0 / rows),
            donate_batch=donate, compute_dtype="bfloat16")
        tr.bind(data_shapes={"data": (rows,) + tuple(batch["data"].shape[1:])},
                label_shapes={"softmax_label": (rows,)})
        tr.init_params()
        for i in range(REMAT_STEPS):
            part = slice(rows * (i % 2), rows * (i % 2 + 1))
            tr.step({n: v[part] for n, v in data.items()})
        whole = {n: v[rows:].clone() for n, v in data.items()}
        tr.step(whole)
        torch.cuda.synchronize()
        if donate:
            given_up = all(v.numel() == 0 for v in whole.values())
        params[donate] = {n: v.clone() for n, v in tr.params.items()}
        del tr, whole
    untouched = all(torch.equal(data[n], kept[n]) for n in data)
    same = all(torch.equal(params[True][n], params[False][n])
               for n in params[True])
    return untouched and given_up, same


def _remat_dropout():
    """GPT-2's MLP block with a Dropout, fused in bfloat16: ``nothing``
    against ``none`` after REMAT_STEPS steps through the capture and
    replays (the recompute draws the forward's masks from the twin
    generator inside the one graph)."""
    symbol = _mlp_block_symbol()
    batch = _mlp_block_batch()
    params = {}
    for policy in ("none", "nothing"):
        mt.random.seed(SEED)
        tr = _remat_trainer(symbol, batch, ("sgd", {"learning_rate": 0.1,
                                                    "momentum": 0.9}),
                            policy)
        for _ in range(REMAT_STEPS):
            tr.step(batch)
        params[policy] = (dict(tr.params), tr.graph_captures,
                          tr.graph_replays)
    (a, ca, ra), (b, cb, rb) = params["none"], params["nothing"]
    return _rel_all(b, a), (ca, ra, cb, rb)


def remat(card):
    """The fused bfloat16 step of GPT-2 small (batch 4 of 1024 tokens) and
    of ResNet-50 (batch 256 of 224^2) under each remat policy: the first
    step's float32 gradients against ``none``'s on the same weights and
    batch, step ms of the replays, peak memory, and K1/B2 launches a
    step (the eager first step's count); then the Dropout check."""
    _phase("remat")
    record = {"remat": "fused bfloat16 step", "card": card, "cells": {}}
    reset_launch_counts()
    total = launch_counts()
    for name, symbol, batch, opt, init in _remat_cells():
        mt.random.seed(SEED)
        first = _remat_trainer(symbol, batch, opt, "none", init=init)
        arg = {n: v.detach().cpu() for n, v in first.params.items()}
        del first
        ref, cells = None, {}
        for policy in REMAT_POLICIES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tr = _remat_trainer(symbol, batch, opt, policy, arg)
            dev = tr._device_batch(batch)
            with torch.no_grad():
                _, _, grads = tr._run_backward(tr.params, tr.aux, dev, None)
            if ref is None:
                ref = {n: g.clone() for n, g in grads.items()}
            err = max(_rel_norms(grads, ref).values())
            del grads
            before = launch_counts()
            times = []
            for i in range(REMAT_STEPS):
                if i == 1:
                    per_step = {k: v - before[k] for k, v in
                                launch_counts().items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.step(dev)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            cells[policy] = {
                "grad_rel_err_max": err,
                "step_ms": statistics.median(times[2:]) * 1e3,
                "capture_step_ms": times[1] * 1e3,
                "peak_bytes": torch.cuda.max_memory_allocated() - base,
                "k1_b2_per_step": {k: v for k, v in per_step.items()
                                   if k != "rtc"},
                "graph_captures": tr.graph_captures}
            del tr, dev
        del ref
        record["cells"][name] = cells
        for policy, c in cells.items():
            print("remat %s %s (%s): step %.2f ms, peak %.2f GB, grads %.3g "
                  "from none's, launches a step %s"
                  % (name, policy, card, c["step_ms"], c["peak_bytes"] / 1e9,
                     c["grad_rel_err_max"], c["k1_b2_per_step"]), flush=True)
    record["dropout_rel_err"], record["dropout_graphs"] = _remat_dropout()
    record["donated"], record["donated_bitwise"] = _donated_batch()
    launches = {k: v - total[k] for k, v in launch_counts().items()}
    record["launches"] = launches
    _emit(record)
    gc.collect()
    torch.cuda.empty_cache()
    bad = [(name, p) for name, cells in record["cells"].items()
           for p, c in cells.items()
           if c["grad_rel_err_max"] > REMAT_GRAD_TOL[name]
           or c["graph_captures"] != 1]
    lm = record["cells"]["gpt2-small"]
    if (bad or record["dropout_rel_err"] > REMAT_DROPOUT_TOL
            or record["dropout_graphs"] != (1, REMAT_STEPS - 1) * 2
            or not (record["donated"] and record["donated_bitwise"])
            or lm["none"]["peak_bytes"] <= lm["nothing"]["peak_bytes"]):
        raise AssertionError("remat: %s (%s)" % (record, bad))
    return launches, record


def dist_across_cards(card):
    """NCCL across cards, a rank a card, where the machine has two or
    more: the ranks bitwise alike, each run within its tolerance of one
    process over the same global batches (DIST_CLASSIC_TOL, the bfloat16
    wire 10 WIRE_TOL; the convolution-BatchNorm net normalising by the
    whole global batch), one capture each, and at two ranks zero=1
    bitwise zero=0."""
    _phase("dist_across_cards")
    n = torch.cuda.device_count()
    if n < 2:
        print("dist_across_cards: did not run (%d card on this machine; "
              "NCCL across cards waits for a machine with two or more)"
              % n, flush=True)
        return None
    ranks, wall = run_workers(n, "ranks_across_cards")
    runs = ("z0_f32", "z1_f32", "z0_bf16", "conv_bn_z0_f32",
            "conv_bn_z1_f32")
    r0 = ranks[0]
    record = {"dist_across_cards": "%d ranks, a card each, NCCL" % n,
              "backends": [r["backend"] for r in ranks],
              "ranks_bitwise": {k: len({r[k]["digest"] for r in ranks}) == 1
                                for k in runs},
              "rel_err_vs_one_process": {
                  k: r0[k]["rel_err_vs_one_process"] for k in runs},
              "zero1_bitwise_zero0":
                  r0["z1_f32"]["digest"] == r0["z0_f32"]["digest"],
              "graphs": {k: (r0[k]["graph_captures"],
                             r0[k]["graph_replays"]) for k in runs},
              "wall_s": wall, "card": card}
    _emit(record)
    print("dist_across_cards (%s): %s" % (card, record), flush=True)
    err = record["rel_err_vs_one_process"]
    if (not all(record["ranks_bitwise"].values())
            or set(record["backends"]) != {"nccl"}
            or max(err[k] for k in runs if k != "z0_bf16")
            > DIST_CLASSIC_TOL
            or err["z0_bf16"] > 10 * WIRE_TOL
            or (n == 2 and not record["zero1_bitwise_zero0"])
            or any(g != (1, DIST_SMALL_STEPS - 1)
                   for g in record["graphs"].values())):
        raise AssertionError("dist_across_cards: %s" % record)
    return record


# ----------------------------------------------------------------------
# integrity, integrity_vote, elastic_shrink: the silent-data-corruption
# defence around the captured step, and elastic membership
INTEG_STEPS = 12          # off against fp at period 1, and the audit
INTEG_FLIP_STEP = 6       # bitflip@step=6 under audit: detected at 6
INTEG_BUDGET = 0.02       # bench.py:1183: the check's share at period 100
INTEG_RESNET_STEPS = 5    # the ResNet-50 cell's audit
# the fit with a rollback: GPT-2's cell, 2 epochs of TRAIN_BATCHES steps,
# an audit every step, bitflip at the second step of the second epoch
INTEG_FIT_EPOCHS, INTEG_FIT_FLIP = 2, TRAIN_BATCHES + 2
# integrity_vote: two gloo ranks on the card, GPT-2 small in bfloat16 at
# VOTE_ROWS rows a rank, a check every VOTE_PERIOD updates, a flip on
# rank 1 after update VOTE_FLIP, detected by the next check (update
# VOTE_FLIP + 1), VOTE_STEPS steps a run
VOTE_ROWS, VOTE_PERIOD, VOTE_FLIP, VOTE_STEPS = 4, 1, 1, 2
# elastic_shrink: tests/torch_elastic_train.py --model gpt2 at GPT-2
# small's widths, ELASTIC_LAYERS deep (the drill's depth), ELASTIC_EPOCHS
# epochs of 2 steps a rank (a 10 s heartbeat timeout, above 12 times the
# longest interpreter-lock stall measured at this depth; at 12 layers a
# 4 s timeout once declared a rank saving its 2 GB checkpoint dead);
# rank 1 dies at its step-4 guard, rank 0 resumes from epoch
# ELASTIC_RESUME_EPOCH's checkpoint, which the replay, started beside
# the drill, waits for
ELASTIC_FAULT = "host_dead@step=4:rank=1"
ELASTIC_LAYERS, ELASTIC_EPOCHS, ELASTIC_RESUME_EPOCH = 2, 2, 1
ELASTIC_TIMEOUT_S = 600


class _env_scope:
    """Environment variables set inside the scope, restored after."""

    def __init__(self, **values):
        self.values, self.saved = values, {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _integrity_cell(mode, period, cell="gpt2"):
    """gpt2_train_cell's fused bfloat16 module (or resnet_cell's), its
    Trainer made under ``integrity=mode`` every ``period`` updates; with
    the batch to step and the step count the cell's iterator holds."""
    with _env_scope(MXTPU_INTEGRITY_MODE=mode,
                    MXTPU_INTEGRITY_PERIOD=str(period)):
        if cell == "gpt2":
            mod, data, x, y, _ = gpt2_train_cell(True, "bfloat16")
            batches = [(x[i * BATCH:(i + 1) * BATCH],
                        y[i * BATCH:(i + 1) * BATCH])
                       for i in range(TRAIN_BATCHES)]
        else:
            mod, data, x, y, _ = resnet_cell()
            batches = [(x, y)]
    if mod._trainer._integ_mode != mode:
        raise AssertionError("the trainer resolved %s to %s"
                             % (mode, mod._trainer._integ_mode))
    return mod, data, batches


def _integrity_steps(mod, batches, n):
    """``n`` fused steps over ``batches`` in turn; each step's seconds
    (host clock between synchronisations)."""
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _fused_step(mod, *batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _free(*objs):
    del objs
    gc.collect()
    torch.cuda.empty_cache()


def _check_cost(tr):
    """The check graph's device time (CUDA events, median of 20 replays)
    against one replay of the step graph: ms each, and the check's share
    of a step at the default period of 100."""
    graph = next(iter(tr._graphs.values()))[0]
    check_ms = cuda_ms(tr._run_check)
    replay_ms = cuda_ms(graph.replay, iters=10)
    return {"check_ms": check_ms, "replay_ms": replay_ms,
            "overhead_at_100": check_ms / (100 * replay_ms),
            "state_words": sum(v.numel() for _, v in tr._named_state()),
            "leaves": len(tr._integ_paths)}


def _audit_run(cell, steps, fault=None, cost=False):
    """``steps`` audited steps of the cell (a check every update), under
    ``fault``; the IntegrityError's record (or None), the divergence
    count, each step's seconds and the trainer's graph counts; with
    ``cost``, the check graph's (``_check_cost``)."""
    mod, _, batches = _integrity_cell("audit", 1, cell)
    tr = mod._trainer
    if fault:
        mt.faults.configure(fault)
    rec, times = None, []
    try:
        times = _integrity_steps(mod, batches, steps)
    except mt.integrity.IntegrityError as e:
        rec = e.record
    finally:
        mt.faults.clear()
    out = {"record": rec, "divergences": tr.integrity_divergences,
           "step_ms": [t * 1e3 for t in times],
           "graphs": (tr.graph_captures, tr.graph_replays),
           "num_update": tr.num_update}
    if cost:
        out["cost"] = _check_cost(tr)
    _free(mod, tr)
    return out


def _integrity_fit(prefix, fault):
    """``Module.fit`` of GPT-2's cell under the audit, with a checkpoint
    an epoch under ``prefix`` (none without one); the final parameters'
    digest, the divergences and the rollback count."""
    mod, data, _ = _integrity_cell("audit", 1)
    mgr = mt.resilience.CheckpointManager(prefix, keep=2) if prefix \
        else None
    before = mt.obs.snapshot()["counters"].get("integrity.rollbacks", 0)
    if fault:
        mt.faults.configure(fault)
    try:
        mod.fit(data, num_epoch=INTEG_FIT_EPOCHS, optimizer="adam",
                optimizer_params={"learning_rate": TRAIN_LR},
                checkpoint=mgr, eval_metric=mt.metric.Perplexity(None))
    finally:
        mt.faults.clear()
    tr = mod._trainer
    out = {"digest": _digest(tr.params),
           "divergences": tr.integrity_divergences,
           "rollbacks": mt.obs.snapshot()["counters"].get(
               "integrity.rollbacks", 0) - before,
           "num_update": tr.num_update}
    _free(mod, tr, data)
    return out


def integrity(card):
    """The fused step's integrity modes on GPT-2 small in bfloat16 (the
    cell of train_fused_bf16) and on the ResNet-50 cell: ``fp`` at
    period 1 over INTEG_STEPS steps bitwise ``off``; the device
    fingerprint against the host's over the state copied off the card;
    the check graph's time beside a step replay's (and its share at the
    default period, reported against INTEG_BUDGET); the audit clean over
    INTEG_STEPS steps (INTEG_RESNET_STEPS on ResNet-50) and a bitflip
    detected at its step; ``fit`` rolled back to the newest verified
    checkpoint and ending bitwise a run without the fault."""
    _phase("integrity")
    t_phase = time.perf_counter()
    reset_launch_counts()
    record = {"integrity": "gpt2-small bf16 fused batch %d; resnet-50 "
              "bf16 batch %d" % (BATCH, RESNET_BATCH), "card": card}
    digests, steps = {}, {}
    for mode in ("off", "fp"):
        mod, _, batches = _integrity_cell(mode, 1)
        tr = mod._trainer
        steps[mode] = _integrity_steps(mod, batches, INTEG_STEPS)
        digests[mode] = _digest(tr.params)
        if mode == "fp":
            rec = tr.state_fingerprint()
            named = [(p, v.cpu()) for p, v in tr._named_state(whole=True)]
            host = mt.integrity.host_fingerprint(named)
            del named
            record["device_vs_host"] = {
                "global": [rec["global"], host[0]],
                "leaves_equal": rec["leaves"] == host[1]}
            record["checks"] = {"captures": tr.check_captures,
                                "replays": tr.check_replays}
            record["gpt2"] = _check_cost(tr)
        _free(mod, tr)
    record["fp_bitwise_off"] = digests["off"] == digests["fp"]
    record["step_ms"] = {m: statistics.median(v[2:]) * 1e3
                         for m, v in steps.items()}
    audits = {"gpt2_clean": _audit_run("gpt2", INTEG_STEPS),
              "gpt2_flip": _audit_run(
                  "gpt2", INTEG_STEPS,
                  "bitflip@step=%d:rank=0" % INTEG_FLIP_STEP),
              "resnet_clean": _audit_run("resnet", INTEG_RESNET_STEPS,
                                         cost=True)}
    record["resnet"] = audits["resnet_clean"].pop("cost")
    record["audits"] = {k: {f: v[f] for f in ("record", "divergences",
                                              "graphs", "num_update")}
                        for k, v in audits.items()}
    record["audit_step_ms"] = {
        k: statistics.median(v["step_ms"][2:]) if len(v["step_ms"]) > 2
        else None for k, v in audits.items()}
    with tempfile.TemporaryDirectory() as tmp:
        fits = {"clean": _integrity_fit(None, None),
                "flip": _integrity_fit(
                    os.path.join(tmp, "flip"),
                    "bitflip@step=%d:rank=0" % INTEG_FIT_FLIP)}
    record["fit"] = fits
    record["fit_bitwise"] = fits["clean"]["digest"] == fits["flip"]["digest"]
    launches = launch_counts()
    record["launches"] = launches
    record["phase_s"] = time.perf_counter() - t_phase
    _emit(record)
    for cell in ("gpt2", "resnet"):
        c = record[cell]
        print("integrity %s (%s): check %.3f ms over %d words, a step "
              "replay %.2f ms, %.4f%% of a step at period 100 (budget %g%%)"
              % (cell, card, c["check_ms"], c["state_words"],
                 c["replay_ms"], 100 * c["overhead_at_100"],
                 100 * INTEG_BUDGET), flush=True)
    print("integrity (%s): fp bitwise off %s; steps %s ms; audit steps %s "
          "ms; phase %.1f s" % (card, record["fp_bitwise_off"],
                                record["step_ms"], record["audit_step_ms"],
                                record["phase_s"]), flush=True)
    flip = audits["gpt2_flip"]["record"] or {}
    bad = []
    if not record["fp_bitwise_off"]:
        bad.append("fp is not bitwise off")
    if record["device_vs_host"]["global"][0] != \
            record["device_vs_host"]["global"][1] \
            or not record["device_vs_host"]["leaves_equal"]:
        bad.append("device fingerprint != host fingerprint")
    if record["checks"] != {"captures": 1, "replays": INTEG_STEPS - 1}:
        bad.append("check graphs %s" % record["checks"])
    for k in ("gpt2_clean", "resnet_clean"):
        if audits[k]["record"] is not None or audits[k]["divergences"]:
            bad.append("%s: a false alarm %s" % (k, audits[k]["record"]))
    if flip.get("step") != INTEG_FLIP_STEP or flip.get("mode") != "audit":
        bad.append("the flip was detected as %s" % flip)
    if not (record["fit_bitwise"] and fits["flip"]["divergences"] == 1
            and fits["flip"]["rollbacks"] == 1
            and fits["clean"]["divergences"] == 0):
        bad.append("fit rollback %s" % fits)
    if not (launches[K1_SOURCES[torch.bfloat16]]
            and launches[B2_SOURCES[torch.bfloat16]]):
        bad.append("K1/B2 bf16 not launched: %s" % launches)
    if bad:
        raise AssertionError("integrity: %s" % bad)
    return launches, record


def _vote_trainer(zero, arg):
    """GPT-2 small's fused bfloat16 Trainer over the mesh of every rank,
    VOTE_ROWS rows a rank, voting every VOTE_PERIOD updates."""
    symbol = mt.models.transformer.get_symbol(**GPT2_SMALL)
    t = GPT2_SMALL["seq_len"]
    tr = mt.parallel.Trainer(
        symbol, mt.optimizer.create("adam", learning_rate=TRAIN_LR,
                                    rescale_grad=1.0 / VOTE_ROWS),
        mesh=mt.parallel.data_parallel_mesh(), compute_dtype="bfloat16",
        zero=zero, integrity="vote", integrity_period=VOTE_PERIOD)
    tr.bind(data_shapes={"data": (VOTE_ROWS, t)},
            label_shapes={"softmax_label": (VOTE_ROWS, t)})
    tr.init_params(arg_params=arg)
    return tr


def _vote_run(tr, batches):
    try:
        for x, y in batches:
            tr.step({"data": x, "softmax_label": y})
    except mt.integrity.IntegrityError as e:
        return json.loads(json.dumps(e.record))
    return None


def _dist_integrity_vote(out):
    """The vote over the ranks of the launch: GPT-2 small in bfloat16,
    bitflip on rank 1 after update VOTE_FLIP, at zero 0 and 1.  Two
    ranks: detection with the blame undetermined, then the replay from
    the start resolves it to rank 1 and ends bitwise a run without the
    fault; more ranks: the majority blames at detection."""
    from mxnet_tpu_torch.parallel import collectives as coll
    _card_flags()
    rank, n = coll._process_index(), coll._process_count()
    rng = np.random.default_rng(SEED + 11)
    x, y = cyclic_tokens(VOTE_ROWS * n * VOTE_STEPS, rng, np.int32)
    per = VOTE_ROWS
    batches = [(x[(s * n + rank) * per:(s * n + rank + 1) * per],
                y[(s * n + rank) * per:(s * n + rank + 1) * per])
               for s in range(VOTE_STEPS)]
    res = {"backend": coll.backend()}
    symbol = mt.models.transformer.get_symbol(**GPT2_SMALL)
    t = GPT2_SMALL["seq_len"]
    shapes, _, _ = symbol.infer_shape(data=(per, t), softmax_label=(per, t))
    arg = _random_params(symbol, shapes, np.random.default_rng(SEED))
    reset_launch_counts()
    # the runs without the fault: at two ranks zero=1 steps bitwise
    # zero=0, so one serves both; at more, NCCL sums in other orders
    cleans = {}
    for zero in (0,) if n <= 2 else (0, 1):
        clean = _vote_trainer(zero, arg)
        _vote_run(clean, batches)
        cleans[zero] = _digest(clean.params)
        del clean
    for zero in (0, 1):
        tr = _vote_trainer(zero, arg)
        blamed = []
        tr.on_integrity_blame = blamed.append
        start = tr.get_opt_states()
        mt.faults.configure("bitflip@step=%d:rank=1" % VOTE_FLIP)
        t0 = time.perf_counter()
        rec = _vote_run(tr, batches)
        mt.faults.clear()
        detect_s = time.perf_counter() - t0
        tr.set_params(arg)
        tr.set_opt_states(start)
        replay = _vote_run(tr, batches)
        res["z%d" % zero] = {
            "record": {k: v for k, v in (rec or {}).items() if k != "fps"},
            "replay_record": replay, "blamed": [b["blamed"]
                                                for b in blamed],
            "bitwise_clean": _digest(tr.params) == cleans.get(zero,
                                                               cleans[0]),
            "check_captures": tr.check_captures,
            "graph_captures": tr.graph_captures,
            "detect_s": detect_s, "comm_s": tr.comm_s}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        coll.barrier()
    res["launches"] = launch_counts()
    return res


DIST_CASES["integrity_vote"] = _dist_integrity_vote


def integrity_vote(card):
    """``vote`` over two gloo ranks sharing the card (``tools/launch.py
    -n 2``): at zero 0 and 1, the flip on rank 1 raises on both ranks at
    the next check with the blame undetermined, the replay blames rank 1
    and ends bitwise a run without the fault.  Where the machine has two
    cards or more, the same over NCCL, a rank a card, where the check is
    captured and (three ranks or more) the majority blames at once."""
    _phase("integrity_vote")
    # both ranks see one card, so they share it over gloo on any machine
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    ranks, wall = run_workers(2, "integrity_vote",
                              env={"CUDA_VISIBLE_DEVICES": first})
    record = {"integrity_vote": "gpt2-small bf16, %d rows a rank, two gloo "
              "ranks on one card" % VOTE_ROWS, "ranks": ranks,
              "wall_s": wall, "card": card}
    n = torch.cuda.device_count()
    if n >= 2:
        record["across_cards"], record["across_cards_wall_s"] = run_workers(
            min(n, 4), "integrity_vote")
    else:
        print("integrity_vote: NCCL across cards did not run (%d card on "
              "this machine; it waits for a machine with two or more)" % n,
              flush=True)
    _emit(record)
    bad = []
    for r in ranks:
        for z in ("z0", "z1"):
            run = r[z]
            rec = run["record"]
            if not (rec.get("step") == VOTE_FLIP + 1
                    and rec.get("blamed") is None
                    and run["replay_record"] is None
                    and run["blamed"] == [[1]] and run["bitwise_clean"]):
                bad.append((r["rank"], z, run))
    for r in record.get("across_cards", []):
        m = len(record["across_cards"])
        for z in ("z0", "z1"):
            run = r[z]
            want = [1] if m >= 3 else None
            if not (run["record"].get("blamed") == want
                    and run["check_captures"] == 1 and run["bitwise_clean"]):
                bad.append((r["rank"], z, "across cards", run))
    print("integrity_vote (%s): %s" % (card, {
        z: {k: ranks[0][z][k] for k in ("record", "blamed", "bitwise_clean",
                                         "detect_s")} for z in ("z0", "z1")}),
        flush=True)
    if bad or [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        raise AssertionError("integrity_vote: %s" % bad)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    return launches, record


def elastic_shrink(card):
    """``tools/launch.py --local-elastic 2`` runs
    ``tests/torch_elastic_train.py --model gpt2`` on the card with
    ELASTIC_FAULT: rank 1 dies before its step barrier, the survivor
    publishes the shrink (2 -> 1), the launcher relaunches one worker,
    which resumes from the newest checkpoint; ELASTIC_RECOVERY_S is the
    launcher's, and the final parameters must be bitwise a one-process
    ``--replay`` from the same checkpoint epoch, started beside the
    drill (it waits for that checkpoint)."""
    _phase("elastic_shrink")
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mxtpu-elastic-")
    env = dict(os.environ)
    for k in ("MXTPU_COORDINATOR", "MXTPU_ELASTIC_DIR",
              "MXTPU_HEARTBEAT_DIR", "MXTPU_MODULE_FUSED", "MXTPU_FAULTS"):
        env.pop(k, None)
    drill = [sys.executable, os.path.join(ROOT, "tests",
                                          "torch_elastic_train.py"),
             work, "--model", "gpt2", "--epochs", str(ELASTIC_EPOCHS)]

    def start(cmd, env, out=subprocess.PIPE):
        return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)

    def finish(proc, what):
        try:
            text, _ = proc.communicate(
                timeout=max(1.0, ELASTIC_TIMEOUT_S
                            - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise AssertionError("elastic_shrink: %s ran past %d s"
                                 % (what, ELASTIC_TIMEOUT_S))
        return proc.returncode, text, time.perf_counter() - t0

    procs = []
    try:
        procs.append(start([sys.executable, os.path.join(
            ROOT, "tools", "launch.py"), "--local-elastic", "2", "--"]
            + drill, dict(env, MXTPU_FAULTS=ELASTIC_FAULT)))
        # the replay's output to a file: no pipe fills while it waits
        replay_log = os.path.join(work, "replay.log")
        with open(replay_log, "w") as out:
            procs.append(start(drill + ["--replay",
                                        str(ELASTIC_RESUME_EPOCH)], env, out))
        code, text, elastic_s = finish(procs[0], "the launcher")
        lines = [ln for ln in text.splitlines()
                 if any(k in ln for k in (
                     "membership", "shrinking", "auto-resume",
                     "ELASTIC_RECOVERY_S", "elastic train done",
                     "elastic job", "Error", "error"))]
        for ln in lines:
            print("elastic_shrink | %s" % ln, flush=True)
        recovery = [float(ln.split("=", 1)[1]) for ln in text.splitlines()
                    if ln.startswith("ELASTIC_RECOVERY_S=")]
        if code != 0:
            raise AssertionError("elastic_shrink: the launcher exited %d:\n%s"
                                 % (code, text[-4000:]))
        code, _, replay_s = finish(procs[1], "the replay")
        with open(replay_log) as f:
            rtext = f.read()
        if code != 0:
            raise AssertionError("elastic_shrink: the replay exited %d:\n%s"
                                 % (code, rtext[-4000:]))
        with open(os.path.join(work, "resume-info.json")) as f:
            info = json.load(f)
        finals = {}
        for tag in ("final", "replay-final"):
            with open(os.path.join(work, tag + ".json")) as f:
                finals[tag] = json.load(f)
        records = {}
        for name in sorted(os.listdir(work)):
            if name.startswith("record-"):
                with open(os.path.join(work, name)) as f:
                    records[name[len("record-"):-len(".json")]] = \
                        json.load(f)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        shutil.rmtree(work, ignore_errors=True)
    total = {"rtc": 0}
    for tag, rec in records.items():
        if "replay" not in tag:
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
    record = {"elastic_shrink": "gpt2-small bf16, %d layers, %d epochs, %s"
              % (ELASTIC_LAYERS, ELASTIC_EPOCHS, ELASTIC_FAULT),
              "shrunk": "shrinking 2 -> 1" in text,
              "dead_rank_1": "dead=[1]; shrinking 2 -> 1" in text,
              "resumed": info, "ELASTIC_RECOVERY_S": recovery,
              "bitwise_replay": finals["final"] == finals["replay-final"],
              "launches_by_process": {k: v["launches"]
                                      for k, v in records.items()},
              "max_stall_s": {k: v["max_stall_s"] for k, v in records.items()},
              "elastic_s": elastic_s,
              "replay_end_s": replay_s,
              "phase_s": time.perf_counter() - t0,
              "card": card}
    _emit(record)
    print("elastic_shrink (%s): shrunk %s, resumed from epoch %s at world "
          "%s, ELASTIC_RECOVERY_S %s, bitwise the replay %s; the drill "
          "%.1f s, the replay's end at %.1f s; longest interpreter-lock "
          "stalls %s"
          % (card, record["shrunk"], info["resumed_epoch"], info["world"],
             recovery, record["bitwise_replay"], elastic_s, replay_s,
             record["max_stall_s"]),
          flush=True)
    if not (record["shrunk"] and record["dead_rank_1"]
            and info["world"] == 1
            and info["resumed_epoch"] == ELASTIC_RESUME_EPOCH
            and recovery and record["bitwise_replay"]
            and "auto-resume from checkpoint epoch" in text):
        raise AssertionError("elastic_shrink: %s" % record)
    return total, record


# ----------------------------------------------------------------------
# serve_int8: serve_server's two tenants quantized to int8 weights for
# bfloat16 compute (contrib.quantization), behind ModelServer(precision=
# "int8"); ResNet-50 calibrated over SERVE_CALIBRATION images at the
# SERVE_INT8_PERCENTILE-th percentile, GPT-2 small weights-only.  One
# burst of SERVE_INT8_ROWS requests a tenant, filling bucket 4; its rows
# against the port's eager forward of the same quantized symbol and
# weights on the CPU (bfloat16 both sides), within SERVE_INT8_TOL of the
# largest reference value, and their top-1 against the float32 tenant's
# on the card on at least SERVE_INT8_TOP1 of its rows (GPT-2: of its
# token positions; the weights are random, so near ties flip under the
# int8 rounding).  The tolerance lies between the sound path's gap and a
# planted fault's (PERF.md, tools/torch_int8_parity.py): ResNet-50's gap
# comes from its activations' fake quantization, where a value that the
# CPU and the card sum apart (by a float32 rounding, or a bfloat16 one)
# lands on the other side of a 1/127 step, and the steps compound
# through the 16 units.  The planted fault, the middle weight's scales
# doubled on the card, must read above the tolerance in every run.
SERVE_INT8_PERCENTILE = 99.9
SERVE_INT8_ROWS = {"resnet-50": (1, 1, 2), "gpt2-small": (1, 1, 2)}
SERVE_INT8_TOL = {"resnet-50": 0.1, "gpt2-small": 0.04}
SERVE_INT8_TOP1 = {"resnet-50": 0.75, "gpt2-small": 0.8}


def _to_bf16(params):
    """Float32 tensors as bfloat16, the rest (int8, bfloat16) as they
    are: the bfloat16 tier's weights."""
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in params.items()}


def _nd(params):
    return {k: mt.nd.NDArray(v) for k, v in params.items()}


def int8_tenants(tenants):
    """serve_tenants' two tenants quantized for bfloat16 compute:
    name -> (symbol, int8 and bfloat16 weights, aux states, per-example
    shape, row maker), plus each tenant's quantization record."""
    out, info = {}, {}
    rsym, rarg, raux, image, rmake = tenants["resnet-50"]
    calib = np.random.default_rng(SEED + 7).standard_normal(
        (SERVE_CALIBRATION,) + image, dtype=np.float32)
    ctx = mt.gpu(0)
    with ctx:
        it = mt.io.NDArrayIter({"data": calib}, None, SERVE_CALIBRATION)
        t0 = time.perf_counter()
        qsym, qarg, qaux, cal = mt.contrib.quantization.calibrate_model(
            rsym, _nd(rarg), _nd(raux), calib_iter=it,
            calib_mode="percentile", percentile=SERVE_INT8_PERCENTILE,
            compute_dtype="bfloat16", ctx=ctx)
        info["resnet-50"] = {
            "calibrate_s": time.perf_counter() - t0, "digest": cal.digest,
            "tag": mt.contrib.quantization.quant_tag(qsym),
            "weights": len(cal.weight_axes),
            "activations": len(cal.act_scales)}
        out["resnet-50"] = (qsym, _to_bf16({k: v.data for k, v in
                                            qarg.items()}),
                            _to_bf16({k: v.data for k, v in qaux.items()}),
                            image, rmake)
        lsym, larg, _, example, lmake = tenants["gpt2-small"]
        t0 = time.perf_counter()
        qsym, qarg, _ = mt.contrib.quantization.quantize_model(
            lsym, _nd(larg), compute_dtype="bfloat16")
        info["gpt2-small"] = {
            "quantize_s": time.perf_counter() - t0,
            "tag": mt.contrib.quantization.quant_tag(qsym),
            "kept_float": sum(not k.endswith(("_quant", "_quant_scale"))
                              for k in qarg)}
        out["gpt2-small"] = (qsym, _to_bf16({k: v.data for k, v in
                                             qarg.items()}), {}, example,
                             lmake)
    return out, info


def _weight_bytes(params, aux):
    return sum(v.numel() * v.element_size()
               for d in (params, aux) for v in d.values())


def _rel_gap(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def serve_int8(card, float_replay_ms):
    """ResNet-50 and GPT-2 small quantized to int8 weights (bfloat16
    compute) behind ``ModelServer(precision="int8")``: every int8
    weight at one byte an element beside the tenant's bytes in
    bfloat16, 10 captures at start with K1-bf16 launched by GPT-2's
    buckets, a burst against the port's CPU forward of the same
    quantized symbol and weights and against the float32 tenant's top-1,
    a planted fault that must read past the tolerance, and a replay's
    device ms a bucket beside serve_server's float32 tenants'.  Returns
    (launches, record)."""
    _phase("serve_int8")
    t_phase = time.perf_counter()
    tenants = serve_tenants()
    qtenants, info = int8_tenants(tenants)
    layers = GPT2_SMALL["num_layers"]
    k1 = K1_SOURCES[torch.bfloat16]
    record = {"card": card, "quantization": info}
    srv = mt.serving.ModelServer(buckets=SERVE_BUCKETS, max_wait_us=2000,
                                 ctx=mt.gpu(0), precision="int8")
    for name, (sym, arg, aux, example, _) in qtenants.items():
        srv.add_model(name, sym, arg, aux, input_shapes={"data": example})
    reset_launch_counts()
    t0 = time.perf_counter()
    srv.start()
    record["start_s"] = time.perf_counter() - t0
    launches = launch_counts()
    st = srv.stats()
    expect_launches("serve_int8 start", launches,
                    **{k1: 2 * layers * len(SERVE_BUCKETS)})
    if st["graph_captures"] != 2 * len(SERVE_BUCKETS) or st["retraces"]:
        raise AssertionError("serve_int8 start: %s" % st)
    # the weights: int8 at one byte an element, the rest bfloat16
    record["bytes"] = {}
    for name, m in srv._models.items():
        int8 = {k: v for k, v in m.params.items() if v.dtype == torch.int8}
        farg, faux = tenants[name][1], tenants[name][2]
        bf16 = 2 * sum(v.numel() for d in (farg, faux) for v in d.values())
        held = st["per_model"][name]["weight_bytes_on_device"]
        rec = {"int8_tensors": len(int8),
               "int8_elements": sum(v.numel() for v in int8.values()),
               "int8_bytes": sum(v.numel() * v.element_size()
                                 for v in int8.values()),
               "weight_bytes_on_device": held,
               "same_tenant_bfloat16_bytes": bf16,
               "float32_bytes": _weight_bytes(farg, faux)}
        record["bytes"][name] = rec
        if not int8 or rec["int8_bytes"] != rec["int8_elements"] \
                or held != _weight_bytes(m.params, m.aux) \
                or held >= bf16 \
                or srv.load_report()["per_model"][name][
                    "weight_bytes_on_device"] != held \
                or json.loads(st["per_model"][name]["quant"])["dtype"] \
                != "int8":
            raise AssertionError("serve_int8 %s bytes: %s" % (name, rec))
    # a burst a tenant, against the CPU's forward of the same quantized
    # model and the float32 tenant's top-1 on the card
    rng = np.random.default_rng(SEED + 9)
    record["parity"] = {}
    for name, (sym, arg, aux, example, make) in qtenants.items():
        rows = [make(rng, n) for n in SERVE_INT8_ROWS[name]]
        futs = [srv.submit({"data": x}, model=name) for x in rows]
        got = torch.cat([f.result(300)[0] for f in futs])
        x = torch.cat(rows)
        m = srv._models[name]
        inputs = list(m.example_shapes) + list(m.label_trailing)
        labels = {n: torch.zeros((len(x),) + t)
                  for n, t in m.label_trailing.items()}
        with uncounted():
            cpu = torch.device("cpu")
            (want,) = mt.serving.CompiledForward(sym, inputs).run(
                {k: v.to(cpu) for k, v in arg.items()},
                {k: v.to(cpu) for k, v in aux.items()},
                dict(labels, data=x.to(m.input_dtypes["data"])))
            fsym, farg, faux = tenants[name][:3]
            feed = {"data": x.cuda(),
                    **{n: v.cuda() for n, v in labels.items()}}
            (ref,) = mt.serving.CompiledForward(fsym, inputs).run(
                farg, faux, feed)
            scales = sorted(k for k in arg if k.endswith("_quant_scale")
                            and "_act_" not in k)
            fault = scales[len(scales) // 2]
            (bad,) = mt.serving.CompiledForward(sym, inputs).run(
                dict(arg, **{fault: 2 * arg[fault]}), aux,
                dict(feed, data=feed["data"].to(m.input_dtypes["data"])))
        gap = _rel_gap(got, want)
        top1 = float((got.float().argmax(-1) == ref.float().cpu()
                      .argmax(-1)).float().mean())
        record["parity"][name] = {"rows": len(x), "max_rel_gap_cpu": gap,
                                  "top1_vs_float32": top1,
                                  "planted_fault": fault + " x2",
                                  "planted_rel_gap_cpu": _rel_gap(
                                      bad.cpu(), want),
                                  "dtype": str(got.dtype),
                                  "finite": bool(torch.isfinite(
                                      got.float()).all())}
        del got, want, ref, bad
    bad = {n: r for n, r in record["parity"].items()
           if r["max_rel_gap_cpu"] > SERVE_INT8_TOL[n]
           or r["planted_rel_gap_cpu"] <= SERVE_INT8_TOL[n]
           or r["top1_vs_float32"] < SERVE_INT8_TOP1[n] or not r["finite"]}
    if bad:
        raise AssertionError("serve_int8 parity: %s" % record["parity"])
    record["replay_ms"] = replay_ms(srv)
    record["float32_replay_ms"] = float_replay_ms
    record["graph_replays"] = srv.stats()["graph_replays"]
    record["phase_s"] = time.perf_counter() - t_phase
    _emit({"serve_int8": record})
    print("serve_int8 (%s): bytes %s; parity %s; replay ms int8 %s, "
          "float32 %s" % (card, {n: (r["weight_bytes_on_device"],
                                     r["same_tenant_bfloat16_bytes"])
                                 for n, r in record["bytes"].items()},
                          record["parity"], record.get("replay_ms"),
                          float_replay_ms), flush=True)
    del srv, tenants, qtenants
    release_serving()
    return launches, record


# ----------------------------------------------------------------------
# detection_ops: the detection ops at the sizes of the networks they come
# from, on the card against the port's CPU run of the same op (the same
# inputs and head gradients from SEED), forward and backward, within
# DET_TOL: Faster R-CNN's RPN over VGG-16's 38 x 50 map of a 600 x 800
# image (Proposal at its defaults, stride 16, 6000 boxes before NMS and
# 300 after, with Faster R-CNN's 3 scales x 3 ratios: 9 anchors) and its
# ROIPooling (7 x 7, 1/16, 128 rois
# over a 512-channel map); SSD-300's six maps (8,732 anchors, the sizes
# and ratios of the upstream SSD example), 21 VOC classes, batch 32,
# labels of SSD_LABELS slots padded with -1
DET_RPN_MAP, DET_IMAGE = (38, 50), (600, 800)
DET_ROIS, DET_POOLED, DET_CHANNELS = 128, (7, 7), 512
SSD_MAPS = ((38, (0.1, 0.141), (1, 2, 0.5)),
            (19, (0.2, 0.272), (1, 2, 0.5, 3, 1 / 3)),
            (10, (0.37, 0.447), (1, 2, 0.5, 3, 1 / 3)),
            (5, (0.54, 0.619), (1, 2, 0.5, 3, 1 / 3)),
            (3, (0.71, 0.79), (1, 2, 0.5)),
            (1, (0.88, 0.961), (1, 2, 0.5)))
SSD_ANCHORS, SSD_CLASSES, SSD_BATCH, SSD_LABELS = 8732, 21, 32, 16
DET_TOL = dict(rtol=1e-5, atol=1e-4)


def ssd300_priors(device):
    """SSD-300's anchors: MultiBoxPrior over each of SSD_MAPS (steps of
    1/size), concatenated: (1, 8732, 4)."""
    outs = []
    for size, sizes, ratios in SSD_MAPS:
        data = mt.nd.NDArray(torch.zeros(1, 1, size, size, device=device))
        outs.append(mt.nd.MultiBoxPrior(
            data, sizes=sizes, ratios=ratios,
            steps=(1.0 / size, 1.0 / size)).data)
    return torch.cat(outs, dim=1)


def detection_inputs(rng, anchors):
    """The cases: (op, params, inputs as numpy), from ``rng``."""
    h, w = DET_RPN_MAP
    logits = rng.standard_normal((1, 2, 9, h, w)).astype(np.float32)
    rpn_prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
        .reshape(1, 18, h, w).astype(np.float32)
    deltas = (rng.standard_normal((1, 36, h, w)) * 0.1).astype(np.float32)
    info = np.array([[DET_IMAGE[0], DET_IMAGE[1], 1.0]], np.float32)
    feat = rng.standard_normal((1, DET_CHANNELS, h, w)).astype(np.float32)
    x1 = rng.uniform(0, DET_IMAGE[1] - 64, DET_ROIS)
    y1 = rng.uniform(0, DET_IMAGE[0] - 64, DET_ROIS)
    rois = np.stack([np.zeros(DET_ROIS), x1, y1,
                     np.minimum(x1 + rng.uniform(32, 400, DET_ROIS),
                                DET_IMAGE[1] - 1),
                     np.minimum(y1 + rng.uniform(32, 300, DET_ROIS),
                                DET_IMAGE[0] - 1)], 1).astype(np.float32)
    A = anchors.shape[1]
    label = np.full((SSD_BATCH, SSD_LABELS, 5), -1.0, np.float32)
    for i in range(SSD_BATCH):
        for j in range(rng.integers(1, 7)):
            x0, y0 = rng.uniform(0.0, 0.7, 2)
            label[i, j] = [rng.integers(0, SSD_CLASSES - 1), x0, y0,
                           x0 + rng.uniform(0.05, 0.3),
                           y0 + rng.uniform(0.05, 0.3)]
    cls = rng.standard_normal((SSD_BATCH, SSD_CLASSES, A)).astype(np.float32)
    cls_prob = (np.exp(cls) / np.exp(cls).sum(1, keepdims=True)) \
        .astype(np.float32)
    loc = (rng.standard_normal((SSD_BATCH, A * 4)) * 0.2).astype(np.float32)
    return [
        ("Proposal", {"scales": (8.0, 16.0, 32.0), "output_score": True},
         [rpn_prob, deltas, info]),
        ("ROIPooling", {"pooled_size": DET_POOLED, "spatial_scale": 1 / 16},
         [feat, rois]),
        ("MultiBoxTarget", {"negative_mining_ratio": 3.0,
                            "negative_mining_thresh": 0.5,
                            "overlap_threshold": 0.5},
         [anchors, label, cls_prob]),
        ("MultiBoxDetection", {"nms_threshold": 0.45},
         [cls_prob, loc, anchors]),
    ]


def _det_run(name, params, ins, device, cots=None):
    """The port's op ``name`` on ``device`` with autograd: (outputs,
    gradients of the floating inputs) on the host."""
    case = {"op": name, "params": params, "kind": "grad", "aux": None,
            "loc": {str(i): a for i, a in enumerate(ins)}}
    outs, _, grads = _op_run(case, device, cots)
    return outs, grads


def detection_ops(card):
    """Proposal, ROIPooling, MultiBoxPrior, MultiBoxTarget and
    MultiBoxDetection at their networks' sizes, on the card against the
    CPU, forward and backward; each op's ms on the card and s on the CPU.
    Returns (launches, record)."""
    _phase("detection_ops")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    reset_launch_counts()
    priors = ssd300_priors(dev)
    cpu_priors = ssd300_priors(torch.device("cpu"))
    if priors.shape != (1, SSD_ANCHORS, 4):
        raise AssertionError("SSD-300 priors %s" % (tuple(priors.shape),))
    torch.testing.assert_close(priors.cpu(), cpu_priors, **DET_TOL)
    rng = np.random.default_rng(SEED + 13)
    record = {"card": card, "priors": tuple(priors.shape), "ops": {}}
    failed = []
    for name, params, ins in detection_inputs(rng, cpu_priors.numpy()):
        outs, _ = _det_run(name, params, ins, dev)
        crng = np.random.default_rng(SEED + 17)
        cots = [crng.standard_normal(tuple(o.shape)).astype(np.float32)
                for o in outs]
        t0 = time.perf_counter()
        want = _det_run(name, params, ins, torch.device("cpu"), cots)
        cpu_s = time.perf_counter() - t0
        got = _det_run(name, params, ins, dev, cots)
        err = 0.0
        for g_list, w_list in zip(got, want):
            for g, w in zip(g_list, w_list):
                if g.shape != w.shape or not torch.allclose(
                        g, w, equal_nan=True, **DET_TOL):
                    failed.append(name)
                if g.numel():
                    err = max(err, float((g.double() - w.double()).abs()
                                         .max()))
        rec = {"outputs": [tuple(o.shape) for o in want[0]],
               "max_abs_err": err, "cpu_fwd_bwd_s": cpu_s}
        if name == "Proposal":
            rec["distinct_rois"] = int(torch.unique(want[0][0][:, 1:],
                                                    dim=0).shape[0])
        if name == "MultiBoxDetection":
            rec["kept_rows"] = int((want[0][0][..., 0] >= 0).sum())
        if name == "MultiBoxTarget":
            rec["positives"] = int((want[0][2] > 0).sum())
        op = mt.op.registry.get(name)
        p = op.parse_params(dict(params))
        ctx = mt.op.registry.OpContext(device=dev)
        xs = [torch.from_numpy(np.asarray(a)).to(dev) for a in ins]
        rec["card_forward_ms"] = cuda_ms(lambda: op.apply(p, ctx, *xs),
                                         warmup=1, iters=3)
        record["ops"][name] = rec
    counts = launch_counts()
    record["launches"] = counts
    record["failed"] = failed
    record["phase_s"] = time.perf_counter() - t_phase
    _emit({"detection_ops": record})
    print("detection_ops (%s): %s; failed %s" % (
        card, {n: (r["max_abs_err"], r.get("card_forward_ms"))
               for n, r in record["ops"].items()}, failed), flush=True)
    if failed:
        raise AssertionError("detection_ops: %s" % record)
    expect_launches("detection_ops", counts)
    return counts, record


# ----------------------------------------------------------------------
# item8_examples: the example scripts of ROADMAP item 8 unchanged under
# the port on the card (tools/torch_run_example.py in this process), each
# to its own assert; the SSD toy with 80 batches (150 by default)
ITEM8_EXAMPLES = (("examples/numpy-ops/numpy_softmax.py", []),
                  ("examples/torch-interop/torch_module.py", []),
                  ("examples/ssd/train_ssd_toy.py", ["--num-batches", "80"]),
                  ("examples/rcnn/train_rcnn_toy.py", []),
                  ("examples/warpctc/toy_ctc.py", []))
# the examples whose symbol holds a node that runs Python
ITEM8_PYTHON = ("examples/numpy-ops/numpy_softmax.py",
                "examples/torch-interop/torch_module.py",
                "examples/rcnn/train_rcnn_toy.py")


@mt.operator.register("chip_smoke_scaled_tanh")
class _ScaledTanhProp(mt.operator.CustomOpProp):
    """2 tanh(x), a Custom op for the card's fit and server check."""

    def create_operator(self, ctx, in_shapes, in_dtypes):
        class ScaledTanh(mt.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0],
                            mt.nd.array(2 * np.tanh(in_data[0].asnumpy())))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                y = out_data[0].asnumpy() / 2
                self.assign(in_grad[0], req[0], mt.nd.array(
                    out_grad[0].asnumpy() * 2 * (1 - y * y)))

        return ScaledTanh()


def _custom_mlp(sym):
    h = sym.FullyConnected(sym.Variable("data"), num_hidden=32, name="fc1")
    h = sym.Custom(h, op_type="chip_smoke_scaled_tanh", name="tanh2")
    h = sym.FullyConnected(h, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(h, name="softmax")


def custom_on_card():
    """A Custom node through ``fit`` with MXTPU_MODULE_FUSED=always (the
    Trainer's steps eager, the reason named, nothing captured) and
    behind a ModelServer (the tenant's forward eager, nothing captured),
    each against the port's CPU run."""
    rng = np.random.default_rng(SEED + 21)
    x = rng.standard_normal((128, 16)).astype(np.float32)
    y = (x @ rng.standard_normal((16, 4))).argmax(1).astype(np.float32)
    init = {"fc1_weight": rng.standard_normal((32, 16)) * 0.3,
            "fc1_bias": np.zeros(32), "fc2_weight":
            rng.standard_normal((4, 32)) * 0.3, "fc2_bias": np.zeros(4)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    params = {}
    for where, ctx in (("cuda", mt.gpu(0)), ("cpu", mt.cpu())):
        with ctx, _env_scope(MXTPU_MODULE_FUSED="always"):
            it = mt.io.NDArrayIter(x, y, batch_size=32)
            mod = mt.mod.Module(_custom_mlp(mt.sym), context=ctx)
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(arg_params={k: mt.nd.array(v)
                                        for k, v in init.items()})
            mod.fit(it, num_epoch=5, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.5})
            params[where] = {k: v.asnumpy()
                             for k, v in mod.get_params()[0].items()}
            if where == "cuda":
                tr = mod._trainer
                train = {"uncaptured": tr.uncaptured,
                         "graph_captures": tr.graph_captures}
    gap = max(float(np.abs(params["cuda"][k] - params["cpu"][k]).max())
              for k in init)
    srv = mt.serving.ModelServer(buckets=[1, 4], max_wait_us=100,
                                 ctx=mt.gpu(0))
    srv.add_model("custom", _custom_mlp(mt.sym),
                  {k: mt.nd.array(v, ctx=mt.gpu(0)) for k, v in
                   params["cuda"].items()}, {},
                  input_shapes={"data": (16,)})
    with srv:
        got = srv.predict({"data": torch.from_numpy(x[:3])},
                          model="custom")[0]
        st = srv.stats()
    with mt.cpu():
        ex = _custom_mlp(mt.sym).bind(mt.cpu(), dict(
            {k: mt.nd.array(v) for k, v in params["cuda"].items()},
            data=mt.nd.array(x[:3]), softmax_label=mt.nd.zeros((3,))))
        want = ex.forward()[0].data
    record = {"train": train, "fit_card_vs_cpu_max_abs": gap,
              "serve": {"graph_captures": st["graph_captures"],
                        "uncaptured": st["per_model"]["custom"][
                            "uncaptured"],
                        "max_abs_vs_cpu": float((got - want).abs().max())}}
    reason = "Python bodies: tanh2 (Custom[chip_smoke_scaled_tanh])"
    if train["uncaptured"] != reason or train["graph_captures"] \
            or gap > FAMILY_TOL or st["graph_captures"] \
            or record["serve"]["uncaptured"] != reason \
            or record["serve"]["max_abs_vs_cpu"] > 1e-5:
        raise AssertionError("custom_on_card: %s" % record)
    return record


def item8_examples(card):
    """The item-8 examples on the card, each to its own assert, and what
    each Module did: the SSD toy's fused step captured once, the scripts
    with a Python node on the classic path naming it; then
    ``custom_on_card``.  Returns (launches, record)."""
    _phase("item8_examples")
    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_run_example as runner
    reset_launch_counts()
    records = []
    with runner.as_the_reference():
        for path, args in ITEM8_EXAMPLES:
            records.append(runner.run_script(os.path.join(ROOT, path), args))
            gc.collect()
    bad = []
    for rec in records:
        mods = rec["modules"]
        if rec["exit"] or not mods:
            bad.append(rec)
        elif rec["script"].endswith("train_ssd_toy.py"):
            if not (mods[0]["fused"] and mods[0]["graph_captures"] == 1
                    and mods[0]["graph_replays"] > 0
                    and mods[0]["uncaptured"] is None):
                bad.append(rec)
        elif rec["script"] in ITEM8_PYTHON:
            if any(m["fused"] or not m["fused_refused"] for m in mods):
                bad.append(rec)
    record = {"card": card, "examples": records, "custom": custom_on_card()}
    counts = launch_counts()
    record["launches"] = counts
    record["phase_s"] = time.perf_counter() - t_phase
    _emit({"item8_examples": record})
    print("item8_examples (%s): %s" % (card, [
        (r["script"].split("/")[-1], r["exit"], round(r["seconds"], 1),
         [(m["fused"], m.get("graph_captures"), m["fused_refused"])
          for m in r["modules"]]) for r in records]), flush=True)
    if bad:
        raise AssertionError("item8_examples: %s" % bad)
    expect_launches("item8_examples", counts)
    return counts, record


def _kernel_line(name, source, replaces, rec, paths, main_path, err, card,
                 dtype, trains=None):
    """A kernel's record.  ``launches`` is what its wrapper counted on the
    main path; a fused path's wrapper counts its eager first step and the
    capture, and ``replayed_step_launches`` gives what one replay of the
    captured step launched (a profiler trace), ``graph_replays`` how
    often the path replayed it."""
    by_path = {path: counts[name] for path, counts in paths.items()}
    if not by_path[main_path]:
        raise AssertionError("%s was not launched on its path: %s"
                             % (name, by_path))
    replayed = {path: {"replayed_step_launches":
                       rec_["replayed_step_launches"][name],
                       "graph_replays": rec_["graph_replays"]}
                for path, rec_ in (trains or {}).items()
                if rec_.get("replayed_step_launches", {}).get(name)}
    return {"name": name, "route": "cuda", "source": source,
            "fused_replays_by_path": replayed,
            "replaces": replaces, "launches": by_path[main_path],
            "launches_by_path": by_path, "main_path": main_path,
            "max_abs_err": err, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "dtype": dtype, "card": card}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = environment()
    compile_record = build_kernels()
    serving_err, serving_bwd_err = check_kernels()
    check_determinism()
    check_rtc()
    check_casts()
    paths = {}
    paths["serve"], latencies, serve_traced = serve()
    paths["serve_server"], server = serve_server(card)
    paths["serve_int8"], _ = serve_int8(card, server["replay_ms"])
    paths["imperative"], _, _ = imperative()
    paths["imperative_bf16"], _ = imperative_bf16()
    trains = {}
    paths["train"], trains["train"], first, _ = train()
    paths["train_fused"], trains["train_fused"], _, grads = train(
        "train_fused", reference=first)
    del first
    paths["train_fused_bf16"], trains["train_fused_bf16"], _, _ = train(
        "train_fused_bf16", "bfloat16", reference=grads)
    del grads
    _emit({"train_steps": {name: {k: rec.get(k) for k in (
        "path", "compute_dtype", "step_s", "replay_step_s", "capture_step_s",
        "first_step_s", "tokens_per_s", "peak_memory_bytes",
        "perplexity_by_epoch")} for name, rec in trains.items()},
        "card": card})
    sentinel()
    # the ResNet path runs none of the port's kernels: its convolutions,
    # pooling and BatchNorm are PyTorch ops, as the JAX package leaves them
    # to XLA; both phases assert that every count stays 0
    paths["train_resnet_vs_cpu"] = train_resnet_vs_cpu()
    paths["train_resnet_bf16"], trains["train_resnet_bf16"] = \
        train_resnet_bf16()
    paths["train_resnet_records"], _ = train_resnet_records(
        card, trains["train_resnet_bf16"])
    # the bucketing LSTM LM runs none of the port's kernels either: its
    # cells and the RNN op are PyTorch ops, as the JAX package leaves them
    # to XLA
    paths["train_lstm_bucketing"], _ = train_lstm_bucketing(card)
    # the rest of fit on the fused bfloat16 and classic float32 cells,
    # then the module family
    paths["train_resume"], _ = train_resume(card)
    paths["train_reshape"], _ = train_reshape(card)
    paths["train_monitor"], _ = train_monitor(card)
    paths["module_family"], _ = module_family(card)
    # the image-classification zoo and the optimizers run none of the
    # port's kernels either: convolutions, LRN, pooling, BatchNorm and the
    # updates are PyTorch ops, as the JAX package leaves them to XLA
    paths["train_zoo"], _ = train_zoo(card)
    paths["optimizers"], _ = optimizers(card)
    # FCN-8s, the loss-layer examples and the op sweep: Deconvolution goes
    # to cuDNN's transposed convolution, as the JAX package leaves it to
    # XLA; train_fcn and loss_examples launch none of the port's kernels,
    # and the op sweep's attention case runs K1 and B2 at its tiny shape
    paths["train_fcn"], _ = train_fcn(card)
    paths["loss_examples"], _ = loss_examples(card)
    paths["op_sweep_card"], _ = op_sweep_card(card)
    # ROADMAP item 8's ops at their networks' sizes and its examples: the
    # detection ops, CustomOp and WarpCTC are PyTorch ops, as the JAX
    # package leaves them to XLA, and launch none of the port's kernels
    paths["detection_ops"], _ = detection_ops(card)
    paths["item8_examples"], _ = item8_examples(card)
    # data-parallel training over worker processes (tools/launch.py), two
    # contexts in one Module, and the fused step's remat policies
    gc.collect()
    torch.cuda.empty_cache()
    paths["dist_one_rank_nccl"], _ = dist_one_rank_nccl(
        card, trains["train_resnet_bf16"])
    dist_two_ranks_shared_card(card)
    dist_across_cards(card)
    paths["multi_context"], _ = multi_context(card)
    paths["remat"], _ = remat(card)
    # the silent-data-corruption defence and elastic membership: GPT-2
    # small in bfloat16 through K1-bf16 and B2-bf16 under a check, an
    # audit, a vote over two ranks and a shrink from two ranks to one
    gc.collect()
    torch.cuda.empty_cache()
    paths["integrity"], _ = integrity(card)
    paths["integrity_vote"], _ = integrity_vote(card)
    paths["elastic_shrink"], _ = elastic_shrink(card)
    records = times(latencies)
    gelu = rtc_times()
    # the paths that replay a captured graph: what one replay launched (a
    # profiler trace) and how often the path replayed
    replays = dict(trains, serve={"replayed_step_launches": serve_traced,
                                  "graph_replays": PREDICTOR_REQUESTS + 1},
                   serve_server={"replayed_step_launches":
                                 server["replayed_batch_launches"],
                                 "graph_replays": server["graph_replays"]})
    lines = []
    for dtype in DTYPES:
        # the path that carries each kernel of this dtype: serving and
        # classic training (float32), fused bfloat16 training
        f32 = dtype == torch.float32
        lines.append(_kernel_line(
            K1_SOURCES[dtype], "mxnet_tpu_torch/csrc/%s.cu" % K1_SOURCES[dtype],
            "mxnet_tpu/op/pallas/flash_attention.py:38", records["K1", dtype],
            paths, "serve" if f32 else "train_fused_bf16",
            serving_err[dtype], card, str(dtype), replays))
        lines.append(_kernel_line(
            B2_SOURCES[dtype],
            "mxnet_tpu_torch/csrc/%s.cu" % B2_SOURCES[dtype],
            "mxnet_tpu/op/pallas/flash_attention.py:165",
            records["B2", dtype], paths,
            "train" if f32 else "train_fused_bf16", serving_bwd_err[dtype],
            card, str(dtype), replays))
    rtc = _kernel_line("rtc", "mxnet_tpu_torch/rtc.py", "mxnet_tpu/rtc.py:84",
                       gelu, paths, "imperative", gelu["max_abs_err"], card,
                       "float32")
    rtc.update(name="rtc_cuda", body=gelu["body"], shape=gelu["shape"],
               nvrtc=compile_record)
    _emit({"chip_smoke_s": time.perf_counter() - _T0, "card": card})
    _emit({"kernels": lines + [rtc]})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dist_child"]:
        if not torch.cuda.is_available():
            sys.exit(1)
        dist_child(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["resume_child"]:
        if not torch.cuda.is_available():
            sys.exit(1)
        resume_child(*sys.argv[2:4])
        sys.exit(0)
    sys.exit(main())
