#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card: build, check, serve,
train, time.

    python3 chip_smoke.py
    python3 chip_smoke.py --f32-times   # the build, then only the f32 tables below
    python3 chip_smoke.py --bf16-wide-times   # ... only the bf16 streamed BPTTs' table
    python3 chip_smoke.py --first-port-times  # ... only the first-port kernels' rows

Two generators are driven through the entry points a user calls
(``eval/serve.py``'s ``serve``, ``training/state.py``'s ``make_gan_state``
and the normalizing WGAN-GP step): config 3's CNN generator with its BiLSTM
f0 head (``generator="cnn_blstm"``), and the BGRU generator
(``generator="bgru"``: a 256-wide front end, 2 BGRU layers of 128 units per
direction, a readout to 99 features); config 3's served features go
through the default PML vocoder (``vocoders.get_vocoder(VocoderConfig())
.synthesize_batch``, closed loop, 2 passes), the two calls ``cli synth``
makes; config 3 trains for epochs through ``training.Trainer``, is
resumed from its checkpoints and served from the best one; and the
generators and the synthesis are exported (``eval/export.py``, ``cli
export``) and served from the reloaded artifacts. Phases, each of which
raises on failure (the script exits 0 only when all passed):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``percivaltts_tpu_torch/csrc`` (one nvcc per
   source, all at once, then one link);
3. hold each recurrent kernel against its plain PyTorch twin: the BiLSTM
   forward (with and without cells) and the BiGRU forward at the serving,
   edge and training shapes, f32 (the narrow cluster kernels
   ``csrc/*_fwd_narrow_f32.cu`` through the entry, W_h in shared memory or
   in registers as their plan takes it, and the one-block CUDA-core kernels
   they replaced launched beside them; the narrow ones also launched on a
   short split and on the other kind of plan, ``NARROW_FWD_FORCED``) and
   bf16 (the tensor-core kernels, ``csrc/*_fwd_mma.cu``, for every H a
   multiple of 16 up to 128), the BiLSTM and BiGRU BPTT at the training and edge
   shapes (T=1, B not a multiple of 8, H = 16, 48, 64, an unaligned gx
   view) and B = 8, f32 and bf16 (the tensor-core kernels
   ``csrc/*_bwd_mma.cu`` for H a multiple of 16 up to 128; in f32 the
   narrow cluster kernels ``csrc/*_bwd_narrow_f32.cu`` through the entry and
   the one-block CUDA-core kernels they replaced launched beside them, and
   the narrow kernels launched on a split whose last block is short, LSTM
   H = 160 and GRU H = 224, ``NARROW_SHORT``); each autograd
   pair (forward kernel + BPTT kernel) against the same function on the
   twins; and the DSP kernels, framing × window and overlap-add, bit
   for bit, at the vocoder's shapes, the JAX package's test shapes and the
   edges (fl not a multiple of 8, nf not a multiple of the framing tile,
   B·nf past 65,535, fl < hop, a frame cut into column slices), f32 and
   bf16; overlap-add also on a stride-0 broadcast row (the iSTFT's window²
   normaliser) and on frames cut from a wider buffer, with no copy kernel;
4. serve 8 requests (96…1500 frames) through each full-width generator
   (seeded init, numpy-made stats and labels): shapes, finiteness, the
   launches per generator call (1 BiLSTM forward for config 3, 2 BiGRU
   forwards for the BGRU), every forward on the tensor-core route, and
   agreement with the same requests served through the plain twins;
4b. vocode config 3's 8 served feature sets (2 chunks of 4, padded to 512
   and 1536 frames): waveforms of nf·80 finite samples, 14 framing and 12
   overlap-add launches (7 and 6 a chunk), and agreement with the same
   vocode through the DSP kernels' twins on the card;
5. train each generator at config 3's width (B=32, T=512, n_critic=5,
   config 3's critic) from ``make_gan_state``, on raw padded batches made
   with numpy (utterances of 300–512 frames, so masks hold zeros)
   normalized on the device: 3 steps with finite metrics and exactly
   (2 forward, 1 BPTT) launches a step for config 3, (4, 2) for the BGRU,
   every forward and BPTT on the tensor-core route; one step from identical state
   with the kernels against the same step with the plain twins;
6. time each kernel, its twin and the library call that computes the same
   function (``nn.LSTM`` / ``nn.GRU`` for the recurrent layers,
   ``F.unfold`` × window and ``F.fold`` for the DSP kernels; timed here
   only: the port never calls them; the recurrent layers by CUDA events and
   by the device time of all they launch, with cuDNN's weights in one
   buffer and its compaction warning an error), each tensor-core forward in
   µs a step
   at B = 8, 32 and 160 and each tensor-core BPTT at B = 32 and 8, beside
   the CUDA-core kernel that bf16 took before,
   each path's serve and step medians and the vocode's, and profile one
   serve and one step of each generator and one vocode for the device's
   busy share and the recurrent (or DSP) kernels' device time; the launch
   floor (the device time of a one-element ``fill_``, the least a launch
   costs), beside which each DSP row prints its time, bound, share of the
   bound and distance to the floor;
7. train config 3 with ``training.Trainer`` (WGAN-GP, n_critic=5, B=32,
   buckets 256 and 512, EMA 0.995, 2 checkpoints kept) on a numpy corpus
   (384 training and 40 validation utterances of 150–700 frames, raw, with
   stats for normalization on the device): 2 epochs, the second profiled
   for 2 steps, then a fresh ``Trainer`` on the same workdir resumes and
   runs a third. Every epoch record finite with as many steps as whole
   WGAN groups; (2 forward, 1 BPTT) launches a step and 1 forward a
   validation batch, all on the tensor-core route; the checkpoints that
   LatestN ∪ BestN predicts; ``resume()`` equal, bit for bit, to the state
   saved at that step (parameters, both Adam states, the step generator,
   the counters, the EMA) with the best epoch and score re-seeded; a
   Chrome trace per run, whose device busy share is printed; the 8
   requests of phase 4 served from ``eval_generator`` of the best
   checkpoint equal, bit for bit, the same requests served from that
   step's EMA held in memory. Prints each epoch's wall time, frames/s and
   step dispatch times, the checkpoint save, resume and restore times and
   a checkpoint's size, beside the card's name and power limit;
8. the README's quick start through the port's CLI
   (``percivaltts_tpu_torch.cli.main``) under ``build/quickstart/``:
   8a. config 1 at full width (the FC generator, 3 × 256 tanh layers, LSE,
   bf16 compute, the default vocoder's 99 features, B=32, buckets
   256/512): ``demo`` of 160 utterances; ``compose`` (the framing kernel
   launches; the features equal, bit for bit, a compose of the same wavs
   with the DSP kernels' twins); ``train --preset production`` for 3
   epochs on the corpus resident on the card with measures every epoch
   and MCD selecting 1 kept checkpoint (finite records, the steps
   ``epoch_indices`` yields, one corpus upload and no batch-sized copy in
   the profiled epoch, one ``objective`` record an epoch, the checkpoints
   LatestN ∪ BestN predicts on MCD); ``generate --split test
   --save-features`` (finite measures, 16 wavs, both DSP kernels launched,
   the same wavs through the twins); ``measures`` of the saved features
   against the denormalized references (generate's MCD within 1e-5);
   8b. config 3 (WGAN-GP, ``cnn_blstm``) trained by ``train --preset
   production`` with measures selecting on ``mcd_gv``, 1 epoch of 2
   steps on the same composed corpus: (2 forward, 1 BPTT) launches a step
   on the tensor-core route, 1 forward a validation batch and a predicted
   chunk. Prints the demo, compose, epoch, measure-validation and
   generate wall times, real frames a second, the generate real-time
   factor, and each profiled device-corpus epoch's busy share with its
   host→device copies by size;
9. the remaining vocoders (on phase 8's demo corpus, removed after):
   9a. config 4 (``bench.py:94-96``): phase 4's 8 requests served by the
   ``cnn`` generator with 80 mel outputs, vocoded by Griffin-Lim
   (``VocoderConfig(kind="melspec")``, 64 iterations, 2 chunks of 4):
   128 framing and 260 overlap-add launches, the same vocode through the
   twins within 1e-4 of the largest sample, its median wall, real-time
   factor and busy share; phase 8's demo wavs analyzed, equal to the
   twins' analysis bit for bit;
   9b. WORLD at ``VocoderConfig(kind="world")`` (65 + 33 bands, closed
   loop, 2 passes): the demo wavs analyzed against the twins, 8 of them
   copy-synthesized (14 framings, 12 overlap-adds) against the twins, timed
   and profiled;
   9c. both through the CLI: ``compose`` (equal to a compose through the
   twins), ``train --preset production`` (config 4: WGAN-GP, 1 epoch of 2
   steps, best on ``mcd_gv`` without F0; WORLD: config 1's FC generator,
   LSE, 2 epochs, the preset's bap voicing rule), ``generate --split test
   --save-features`` (equal to a generation through the twins) and
   ``measures`` (generate's MCD within 1e-5);
10. the remaining variants (on phase 8's corpus, removed after):
   10a. config 3 in the JAX package's reference-faithful form
   (``conv_style="2d"``: the spectral stream as a (T, 65, 2) image under
   32-channel 5×5 convs in 4 residual blocks, the BiLSTM f0 head; the 2d
   critic, 32 → 64, 64, 128, 128 channels; ``gen_norm`` and
   ``critic_norm`` ``"layer"``; 848,421 generator parameters) served and
   trained as in phases 4–6: 1 BiLSTM forward a call, (2 forward, 1 BPTT)
   launches a step on the tensor-core route, the twins' serve and step
   within phase 4's and 5's tolerances, medians and busy share beside the
   time-1D config 3's;
   10b. the BGRU with ``gen_norm="layer"`` (726,883 parameters): the same,
   with 2 forwards a call and (4, 2) launches a step;
   10c. PML with ``envelope="te"``: the demo wavs analyzed against the
   twins, 8 of them copy-synthesized (open loop: 2 framings and 4
   overlap-adds) against the twins, timed and profiled;
   10d. the demo wavs analyzed against the twins with WORLD's "te" and
   each non-default ``AnalysisParams`` reader (``ps_reflect``, ``ps_shift``
   with and without ``ps_shift_snap``, ``ps_shift_nm_only``,
   ``psync=False``), each differing from the default analysis;
   10e. 10a's model over "te" features through the CLI as phase 9c
   (WGAN-GP, 1 epoch of 2 steps);
11. the serving export (``eval/export.py``; the kernels run inside the
   exported graphs as the registered operators ``percival::*``):
   11a. config 3 (phase 4's seeded weights) exported at bounds 256 and 512,
   batch 1 and 8, saved and reloaded on the card; phase 4's requests that
   fit served through the artifacts equal, bit for bit, the live generator
   on the same bucket-bound padded batches; 1 BiLSTM forward a call on the
   tensor-core route, counted inside the artifact; a 1,500-frame request
   refused; export, save and load seconds and bytes per bound; the batched
   artifacts' median serve beside eager ``serve``'s;
   11b. the same for the BGRU at bound 256 (2 BiGRU forwards a call);
   11d. ``cli export`` on phase 8's workdir through a copy of its config
   with one bucket bound, 512 (one PML synthesis artifact to trace, the
   default synthesis; the command runs in a subprocess from the end of
   phase 8, beside phases 9–10), whose artifacts turn the test label files
   into features (within phase 4's tolerance of ``cli synth``'s) and wavs;
   11c. (after 11d) the default PML synthesis (closed loop, 2 passes; 11d's
   artifact at bound 512) and config 4's Griffin-Lim exported at bound 256
   and reloaded: the served requests of 385–512 (PML) or 129–256 frames
   (Griffin-Lim) rendered equal to ``synthesize_batch(seed=0, chunk=1)`` bit
   for bit, 7 framings and 6 overlap-adds (PML) or 64 and 130 (Griffin-Lim)
   counted inside each artifact call, ms a call beside
   ``synthesize_batch``'s;
   11e. the operators' host cost: an overlap-add through the op against the
   eager wrapper (the same CUDA function without the dispatcher), and
   Griffin-Lim's 388 launches both ways;
12. data parallelism (``parallel/``), config 3:
   12a. phase 7's config and corpus through ``Trainer(mesh=make_mesh())``
   over an NCCL group of one, 2 epochs, equal bit for bit (every state
   tensor) to the same ``Trainer`` without a mesh, both with cuDNN's
   deterministic algorithms; the same launches, all on the tensor-core
   route; the epoch walls, and a WGAN-GP step's median under the mesh
   against without it, in turns, with the all-reduces a step counted;
   12b. one WGAN-GP step from the seeded state over 2 ranks spawned on the
   card over gloo (NCCL refuses two ranks on one device), each on its 16
   rows, then the same step gathered from a ``shard_corpus=True`` device
   corpus (each rank holding half of it), then from a per-process corpus
   (``make_mesh(per_process=True)``, the JAX package's multi-process
   layout): each rank given only its own ``Dataset.shard(2, r)`` of the
   first 383 utterances (192 and 191; rank 1 pads one row), one all-gather
   of the counts and no other collective while it is built, its block's
   bytes beside the one-host block's; each rank within one bf16 step's
   tolerances of the world-size-1 step on the same global rows (the whole
   batches; for the per-process corpus, rank r's row j is utterance
   r + 2·(j mod N_r)), the ranks' states bit-equal, (2 forward, 1 BPTT)
   launches on each rank; beside them bf16's own spread, the world-size-1
   step on its rows reversed; the ranks' step median (no scaling number:
   the ranks share one card and gloo stages every all-reduce through the
   host); a rank that has not ended in ``MESH_TIMEOUT_S`` is killed and
   fails the phase;
   12c. ``python -m torch.distributed.run --standalone --nproc-per-node 1
   -m percivaltts_tpu_torch.cli train --mesh --device-corpus`` with config
   3 on phase 8's corpus, 1 epoch of 2 steps with measures: exit 0, one
   epoch record, the checkpoint, which ``cli synth`` serves;
13. kernels #1/#2 at every width the JAX package trains (a thread-block
   cluster a direction: the f32 "wide_f32" route,
   ``csrc/bilstm_{fwd,bwd}_wide_f32.cu``, for f32 up to H = 512; the
   CUDA-core "wide" route, ``csrc/bilstm_{fwd,bwd}_wide.cu``, past it; the
   tensor-core "wide_mma" route, ``csrc/bilstm_{fwd,bwd}_wide_mma.cu``, for
   bf16):
   13a. each launch plan against ``ops/wide_layout.py`` and, for
   ``wide_mma``, ``ops/wide_mma_layout.py`` (the BPTT's rows a cluster,
   clusters at once and waves, B <= 32 in one wave; the forward's rows,
   row tiles a warp and h buffers, B <= 32 and B = 160 in one wave at
   H = 512), for ``wide_f32`` ``ops/wide_f32_layout.py`` (the BPTT's
   ``rows``, the forward's ``fwd_rows``: chunks in shared memory and in
   registers), ``ptxas``'s registers with 0 spills on ``wide_mma`` and on
   the ``wide_f32`` forwards; the
   forward (with and without cells) at (512, 8, 512), (517, 3, 512), (1, 1,
   512), (512, 160, 512), (33, 9, 264), (64, 1, 608) and the BPTT at (512,
   32, 512), (33, 9, 264), (40, 1, 608), (24, 5, 100) and, bf16, (512, 160,
   512) (its entry's route, the one-block kernel padded to H = 104, and
   the cluster kernels launched directly) against the twins, f32 and bf16,
   each launch counted on its route, the CUDA-core cluster kernels
   launched on the bf16 inputs too, in f32 both cluster forwards and both
   cluster BPTTs (``wide``, ``wide_f32``: one on its route, the other
   launched directly) wherever ``wide_f32`` takes H, (512, 160, 512)
   included; H = 256 on the route that takes it,
   and in bf16 the one-block kernels against both cluster ones on the same
   inputs, checked and timed in turns; the autograd pair at (512, 32, 512)
   (bf16: both kernels on ``wide_mma``); both bf16 kernels timed at B = 8,
   32, 160 in turns with the CUDA-core cluster kernels they replaced (the
   forward at B = 160 also on R = 40 rows a cluster), beside the twins, the
   bound and cuDNN's ``nn.LSTM`` (by CUDA events and by device time, its
   weights in one buffer and the compaction warning an error), and the
   port's forward layer by device time on both forward kernels;
   13b. config 3 (``cnn_blstm``) and the BLSTM generator at
   ``blstm_size=1024`` (H = 512) each serving phase 4's 8 requests against
   the twins, every forward launch on ``wide_mma`` (and every BPTT launch
   of 13c), serve medians, busy share; config 3 also in f32
   (``compute_dtype="float32"``), every forward and BPTT launch on
   ``wide_f32``, one serve held against the twins (the median of 3 timed);
   13c. one WGAN-GP step of each as phase 5 takes them, held against the
   twins' step as ``_hold_step`` holds phase 5's, the step median of 5
   (the f32 form: one step held, the median of 3);
   13d. the f32 kernels at B = 8, 32, 160 (H = 512): the ``wide_f32``
   forward and BPTT, each in turns with its twin and the ``wide`` kernel it
   replaced, beside the bound at the f32 rate and cuDNN's f32 ``nn.LSTM``
   (TF32 off) by CUDA events and by device time;
14. kernels #3/#4 at every width the JAX package trains (the same three
   routes: ``csrc/bigru_{fwd,bwd}_wide_f32.cu``,
   ``csrc/bigru_{fwd,bwd}_wide.cu`` and ``csrc/bigru_{fwd,bwd}_wide_mma.cu``):
   14a. as 13a with 3 gates: the forward at (512, 8, 512), (517, 3, 512),
   (1, 1, 512), (512, 160, 512), (33, 9, 336), (33, 9, 352), (64, 1, 640)
   and the BPTT at (512, 32, 512), (33, 9, 336), (40, 1, 640), (24, 5, 100)
   and (512, 160, 512), cuDNN's ``nn.GRU`` beside the timings;
   14b/14c. the BGRU generator at ``blstm_size=1024`` (H = 512) serving
   phase 4's 8 requests and taking WGAN-GP steps as 13b/13c, every forward
   and BPTT launch on ``wide_mma``, (4, 2) launches a step; and in f32 as
   13b/13c's f32 form, every forward and BPTT on ``wide_f32``;
   14d. as 13d for the GRU's f32 kernels, beside cuDNN's f32 ``nn.GRU``;
15. f32 at the default width (H = 128), where the forwards and the BPTTs
   take the narrow kernels (``"narrow_f32"``,
   ``csrc/{bilstm,bigru}_{fwd,bwd}_narrow_f32.cu``):
   15a. their launch plans against ``ops/narrow_f32_layout.py`` at the card's
   clusters, and ``ptxas``'s registers and spills;
   15b. config 3 and the BGRU in f32 (``NARROW_MODELS``) served and trained
   as 13b/13c's f32 forms (``F32_DEPTH``), every forward and BPTT on
   ``"narrow_f32"``, the launch counts recorded;
   15d. the f32 kernels of those paths at ``F32_SIMT_TIMED`` as 13d times
   its kernels: the narrow forwards and BPTTs in turns with the one-block
   kernels they replaced, beside cuDNN's f32 layer;
16. the f32 BPTT's few-row plan (``"wide_f32"`` at B <= 8: R = 1, 2 or 4
   rows a cluster, ``csrc/wide_f32_few.cuh``):
   16a. its plans at every B up to 8 at the widths below against
   ``ops/wide_f32_layout.py::bwd_plan`` at the card's clusters (and at
   forced rows), ``ptxas``'s registers with 0 spills;
   16b. both kernels through their entries at every row that kept
   ``"wide"`` before (``F32_WIDE_KEPT``) and at ``FEW_EDGES``, each launch
   counted on the few-row kernels, against the twins within
   ``KERNEL_TOL[f32]``·max(1, max|twin|), with ``"wide"`` launched beside
   them; and at ``FEW_FORCED``'s forced rows;
   16c. config 3 and the BGRU in f32 at ``blstm_size=768`` (H = 384,
   ``FEW_MODELS``) served and trained at ``FEW_TRAIN_B`` = 8 rows as 13b/13c
   (``FEW_DEPTH``), every BPTT launch on the few-row kernels;
   16d. both kernels at ``F32_WIDE_KEPT`` in turns with ``"wide"`` and the
   twin, beside the bound and cuDNN's f32 layer (events, device time);
17. the bf16 layers past the tensor-core widths (``"wide_mma_stream"``: the
   W_hᵀ slice streamed from L2 in 64-k chunks, ``csrc/wide_mma_stream.cuh``;
   the forwards and the BPTTs):
   17a. their plans at every width and B they are timed at against
   ``ops/wide_mma_layout.py::stream_plan`` / ``stream_fwd_plan`` at the
   card's clusters, ``ptxas``'s registers and spills (none past
   ``STREAM_SPILL_MAX``: 0 but for two forward instantiations); the four kernels
   through their entries at ``STREAM_SHAPES`` against the twins within
   ``KERNEL_TOL[bf16]``·max(1, max|twin|) (the LSTM forward with and
   without cells), ``"wide"`` launched beside them;
   17b. the autograd pairs at ``STREAM_AUTOGRAD_SHAPE`` (forward and BPTT
   streamed) against the twins;
   17c. config 3 and the BGRU at ``blstm_size=2048`` (H = 1024,
   ``STREAM_MODELS``) served and trained (B = 32) as 13b/13c
   (``STREAM_DEPTH``), every forward and BPTT launch on the streamed kernels;
   17d. the four kernels at ``STREAM_TIMED`` in turns with ``"wide"`` and
   the twin, beside the bound and cuDNN's bf16 layer (events, device time);
18. the bf16 BPTTs past the 64-k layout's widths (H 1537 / 1793 up to
   4096: the deep layout of ``"wide_mma_stream"``, 32-k chunks all
   streamed, h_prev through the ring, the dh partials through L2; the
   forwards there stay on ``"wide"``):
   18a. their plans in 17a's, 0 spills for every deep instantiation; both
   kernels through their entries at ``DEEP_SHAPES`` against the twins
   within ``KERNEL_TOL[bf16]``·max(1, max|twin|), each launch counted on
   the route and on the deep layout (``.stream_layouts``);
   18b. the autograd pairs at ``DEEP_AUTOGRAD_SHAPE`` (the forward on
   ``"wide"``, the BPTT deep) against the twins;
   18c. config 3 and the BGRU at ``blstm_size=4096`` (H = 2048,
   ``DEEP_MODELS``) served and trained (B = 32) as 17c (``DEEP_DEPTH``),
   every BPTT launch on the deep layout;
   18d. both kernels at ``DEEP_TIMED`` in turns with the twin and, at B of
   ``DEEP_EARLIER_B`` and H of ``DEEP_EARLIER_H``, with ``"wide"``, beside
   the plan, the bound and cuDNN's bf16 layer backward (events, device
   time).

With ``--f32-times`` the script builds, then only times f32 and exits:
15d's kernels at ``F32_SIMT_TIMED``; ``"narrow_f32"`` and the one-block
kernel in turns, forward and BPTT, at each width of ``F32_NARROW_WIDTHS``
and B of ``F32_NARROW_BATCHES``; the BPTT rows that kept ``"wide"`` before
the few-row plan (``F32_WIDE_KEPT``) on ``"wide_f32"`` in turns with
``"wide"``, beside cuDNN's layer; and both cluster forwards and both cluster
BPTTs, ``"wide"`` and ``"wide_f32"``, in turns at each width of
``F32_ROUTE_WIDTHS`` and B of ``F32_ROUTE_BATCHES`` (where the BPTT's plan
takes its few-row kernels, its chunked kernel at R = 8 beside them); each
beside the route ``fwd_route`` / ``bwd_route`` takes there; and the GRU
forward at ``F32_WIDE_FWD``'s width, ``"wide"`` against ``"wide_f32"`` in
turns at B = 1–4. With ``--bf16-wide-times`` it builds, then times the
streamed bf16 BPTTs against ``"wide"`` in turns at each width of
``BF16_WIDE_WIDTHS`` and B of ``BF16_WIDE_BATCHES`` (the deep layout's
widths included), the streamed forwards likewise at B of
``BF16_WIDE_FWD_BATCHES`` up to their widest width, then 17d and 18d; with
``--first-port-times`` it times the kernels still in their first port
(``FIRST_PORT_ROWS``) beside the bound and cuDNN's layer. These print no
kernel line and no device record.

Launch counts are set to 0 just before each serve, train, vocode or
training-loop path (on each rank of 12b, which reports its counts) and
read just after it; launches made to compare a kernel with its twin are not
counted. The line before the last is one JSON object describing each
kernel; the last line is the JSON device record. Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SEED = 0
DEVICE = "cuda:0"
BUILD_LOG = ""  # nvcc's output of the build (main sets it): ptxas's registers and spills
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and dense FLOP/s by
# input type (bf16 on the tensor cores; f32 outside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# BiLSTM and BiGRU forwards: serving and edge shapes, then the training
# path's: the fakes pass over n_critic·B rows (without cells) and the
# generator update (with cells), and a narrow width (H=64)
KERNEL_SHAPES = [(512, 8, 128), (517, 3, 128), (64, 1, 128), (1, 1, 128), (1536, 8, 128),
                 (512, 160, 128), (512, 32, 128), (40, 160, 128), (33, 9, 64),
                 (256, 160, 128), (256, 32, 128)]  # the training loop's 256-frame bucket
# f32: the same math with sums and transcendentals in another order.
# bf16: outputs are bf16 (ulp 2^-8 near 1) and h is rounded to bf16 before
# each product, so a one-ulp rounding flip is carried into later steps.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REQUEST_LENGTHS = (96, 137, 250, 400, 512, 777, 1024, 1500)
# kernel vs plain twin through the whole generator, bf16, denormalized.
# Config 3: only the f0 stream reads the BiLSTM; a few bf16 ulps at
# |f0| < 2, divided by output scales >= 0.5. BGRU: every stream reads both
# GRU layers, and the bf16 readout rounds at |normalized output| < 4 with an
# ulp of 2^-6, times 1/scale <= 2: 0.03 a rounding flip, and up to four
# flips in the same element after two layers.
# Phase 13's blstm_size=1024 models by the same count: config 3's f0 head
# (one BiLSTM, now of 512 units) as config 3; the BLSTM generator, whose
# every stream reads both LSTM layers through a bf16 readout, as the BGRU.
# Phase 14's BGRU at blstm_size=1024 as the BGRU.
# The f32 forms (phases 13/14, route "wide_f32"): no bf16 rounding flips, only
# sums taken in another order (the kernels' f32 outputs within 1e-4 of the
# twins', KERNEL_TOL), read through an f32 readout and scaled by 1/scale <= 2.
SERVE_TOL = {"cnn_blstm": 0.0625, "bgru": 0.125, "cnn_blstm_2d": 0.0625, "bgru_ln": 0.125,
             "cnn_blstm_1024": 0.0625, "blstm_1024": 0.125, "bgru_1024": 0.125,
             "cnn_blstm_1024_f32": 1e-3, "bgru_1024_f32": 1e-3,
             "cnn_blstm_f32": 1e-3, "bgru_f32": 1e-3,
             "cnn_blstm_768_f32": 1e-3, "bgru_768_f32": 1e-3,
             "cnn_blstm_2048": 0.0625, "bgru_2048": 0.125,
             "cnn_blstm_4096": 0.0625, "bgru_4096": 0.125}
PARAMS = {"cnn_blstm": 3_246_691, "bgru": 726_371, "cnn_blstm_2d": 848_421, "bgru_ln": 726_883,
          "cnn_blstm_1024": 6_003_043, "blstm_1024": 13_128_803, "bgru_1024": 9_983_075,
          "cnn_blstm_1024_f32": 6_003_043, "bgru_1024_f32": 9_983_075,
          "cnn_blstm_f32": 3_246_691, "bgru_f32": 726_371,
          "cnn_blstm_768_f32": 4_822_115, "bgru_768_f32": 5_717_859,
          "cnn_blstm_2048": 13_348_195, "bgru_2048": 38_840_419,
          "cnn_blstm_4096": 40_621_411, "bgru_4096": 153_178_211}
# the models each path builds (``ModelConfig`` fields): config 3 and the
# BGRU, then phase 10's reference-faithful config 3 (2-D spectral convs in
# the generator and the critic, LayerNorms in the generator's trunk and the
# critic) and the BGRU with its front end's LayerNorm
MODELS = {
    "cnn_blstm": dict(generator="cnn_blstm"),
    "bgru": dict(generator="bgru"),
    "cnn_blstm_2d": dict(generator="cnn_blstm", conv_style="2d", gen_norm="layer",
                         critic_norm="layer"),
    "bgru_ln": dict(generator="bgru", gen_norm="layer"),
    # phase 13: blstm_size=1024, H = 512 a direction (a cluster of blocks a
    # direction, bf16: "wide_mma"): config 3's f0 head, and the BLSTM generator's 1024-wide tanh
    # front end and 2 bidirectional layers
    "cnn_blstm_1024": dict(generator="cnn_blstm", blstm_size=1024),
    "blstm_1024": dict(generator="blstm", blstm_size=1024),
    # phase 14: the BGRU generator's 1024-wide front end and 2 bidirectional
    # GRU layers of H = 512 (kernels #3/#4's cluster routes)
    "bgru_1024": dict(generator="bgru", blstm_size=1024),
    # phases 13/14 in f32: the same models computing in f32, whose recurrences
    # past H = 256 (LSTM) / 320 (GRU) take the f32 cluster forward and BPTT
    # ("wide_f32")
    "cnn_blstm_1024_f32": dict(generator="cnn_blstm", blstm_size=1024, compute_dtype="float32"),
    "bgru_1024_f32": dict(generator="bgru", blstm_size=1024, compute_dtype="float32"),
    # phase 15: config 3 and the BGRU in f32 at the default blstm_size (H = 128),
    # forwards and BPTTs on the f32 narrow kernels ("narrow_f32")
    "cnn_blstm_f32": dict(generator="cnn_blstm", compute_dtype="float32"),
    "bgru_f32": dict(generator="bgru", compute_dtype="float32"),
    # phase 16: config 3 and the BGRU in f32 at blstm_size=768 (H = 384 a
    # direction), trained at FEW_TRAIN_B rows: the BPTTs take the few-row
    # plan of "wide_f32" (csrc/wide_f32_few.cuh)
    "cnn_blstm_768_f32": dict(generator="cnn_blstm", blstm_size=768, compute_dtype="float32"),
    "bgru_768_f32": dict(generator="bgru", blstm_size=768, compute_dtype="float32"),
    # phase 17: config 3 and the BGRU at blstm_size=2048 (H = 1024 a
    # direction) in bf16: the forwards and the BPTTs on the streamed
    # tensor-core cluster kernels ("wide_mma_stream")
    "cnn_blstm_2048": dict(generator="cnn_blstm", blstm_size=2048),
    "bgru_2048": dict(generator="bgru", blstm_size=2048),
    # phase 18: the same at blstm_size=4096 (H = 2048 a direction): the
    # BPTTs on the streamed kernels' deep layout, the forwards on "wide"
    "cnn_blstm_4096": dict(generator="cnn_blstm", blstm_size=4096),
    "bgru_4096": dict(generator="bgru", blstm_size=4096),
}
# the forwards at the serving chunk, the generator update and the fakes pass
FWD_TIMED = [(512, 8, 128), (512, 32, 128), (512, 160, 128)]
TIMED_SHAPES = {"bilstm_fwd": FWD_TIMED, "bigru_fwd": FWD_TIMED,
                "bilstm_bwd": [(512, 32, 128), (512, 8, 128)],
                "bigru_bwd": [(512, 32, 128), (512, 8, 128)]}
# the wrappers with three routes (``.routes``): tensor cores ("mma"), CUDA
# cores in one block a direction ("simt") or a cluster of blocks ("wide")
ROUTED = ("bilstm_fwd", "bigru_fwd", "bilstm_bwd", "bigru_bwd")
# the BPTT wrappers, which also count their "wide_f32" launches by the kernel
# its plan took (``.wide_f32_plans``: "chunked" or "few") and their
# "wide_mma_stream" launches by layout (``.stream_layouts``: "64k" or "deep")
PLANNED = ("bilstm_bwd", "bigru_bwd")
LAYER_IN = 256  # the recurrent layers' input width in both generators

# BPTT: the training shape, edge shapes, the narrow width, and H=160 (bf16
# outside the tensor-core route: the cluster kernels in bf16; f32 takes its
# narrow cluster kernels, "narrow_f32", at every one of these, and the
# one-block CUDA-core kernels it replaced are launched beside them; phases
# 13a/14a check bf16 at H = 256), the training loop's 256-frame bucket and
# the serving chunk
BWD_SHAPES = [(512, 32, 128), (517, 3, 128), (64, 1, 128), (33, 9, 64), (33, 9, 160),
              (256, 32, 128), (512, 8, 128)]
# f32 "narrow_f32" launched directly on a split whose last block is short:
# (T, B, H, blocks) per cell (LSTM H = 160 over 7 blocks of 24 units, the
# last 16; GRU H = 224 over 5 of 48, the last 32)
NARROW_SHORT = {"lstm": (33, 9, 160, 8), "gru": (33, 9, 224, 5)}
# f32 "narrow_f32" forwards launched directly with their plan's overrides:
# on those short splits, and on the kind of plan the entry does not take at
# a width: W_h in registers at R = 2 (LSTM H = 96, GRU H = 128; the entry
# takes R = 1 at B = 9) and in shared memory (GRU H = 128): (cell, (T, B, H),
# overrides)
NARROW_FWD_FORCED = [("lstm", (33, 9, 160), dict(blocks=8, resident=0)),
                     ("gru", (33, 9, 224), dict(blocks=5, resident=0)),
                     ("lstm", (33, 9, 96), dict(rows=2, resident=1)),
                     ("gru", (33, 9, 128), dict(rows=2, resident=1)),
                     ("gru", (33, 9, 128), dict(resident=0))]
# bf16 only (the tensor-core route): T=1, H=16 and 48, B not a multiple of 8
# (the CUDA-core GRU BPTT takes H a multiple of 32 only)
BWD_MMA_SHAPES = [(1, 5, 128), (40, 11, 16), (24, 13, 48)]
BWD_UNALIGNED = (33, 9, 64)  # also checked, in bf16, with gx 2 bytes past a 16-byte boundary
# BPTT kernel vs twin. f32: absolute, as the forward. bf16: relative to
# max|dgx| (or max|dnr|), since the d(gates) are rounded to bf16 and fed
# back through dh, so a one-ulp flip is carried into earlier frames.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
AUTOGRAD_SHAPE = (512, 32, 128)

# DSP kernels at the vocode path's shapes, (B, n, frame length, hop,
# windowed): YIN's and CheapTrick's framings of a 4-utterance chunk of
# 1536 frames, the noise STFT's (one row, Hann window), then the JAX
# package's test shapes (tests/test_pallas.py), then the edges: fl not a
# multiple of 8 (777, 804 with odd n: rows off 16-byte alignment), nf not a
# multiple of the 8-frame tile, B·nf past 65,535, fl < hop, n < fl/2, and
# a frame too wide for one block (column slices); then Griffin-Lim's framing
# at B = 4, 1 and 8.
# Griffin-Lim's framing: a 4-utterance chunk of 1536 frames, fl 400 (25 ms), windowed
GL_FRAME = (4, 122880, 400, 80, True)
FRAME_SHAPES = [(4, 122880, 804, 80, False), (4, 122880, 800, 80, False),
                (1, 122880, 160, 80, True), (4, 122880, 160, 80, False),
                (2, 777, 320, 64, True), (2, 1000, 400, 80, False),
                (2, 3001, 777, 100, True), (3, 1001, 804, 80, False), (2, 1041, 160, 80, True),
                (43, 122880, 160, 80, False), (2, 1000, 48, 80, True), (1, 5, 160, 80, True),
                (1, 50000, 20000, 4000, True), GL_FRAME, (1, 122880, 400, 80, True),
                (8, 16000, 400, 80, True)]
# overlap-add (B, nf, frame length, hop): the noise iSTFT and its window²
# normaliser at 1536 frames, then the test shapes, then the edges: vectors
# that cross hop blocks (777 / 100), rows off 16-byte alignment (hop 63),
# B·nf past 65,535, fl < hop, one frame
OLA_SHAPES = [(4, 1536, 160, 80), (1, 1536, 160, 80), (2, 13, 320, 64), (2, 257, 400, 80),
              (2, 37, 777, 100), (3, 41, 126, 63), (43, 1536, 160, 80), (2, 20, 48, 80),
              (1, 1, 160, 80), (4, 1536, 400, 80), (1, 1536, 400, 80), (8, 200, 400, 80)]
# timed overlap-adds: the two above, and the normaliser as the iSTFT runs
# it, a stride-0 broadcast of one window² row (read once: its bound counts
# fl); then Griffin-Lim's iSTFT at fl 400 and its normaliser
OLA_TIMED = OLA_SHAPES[:2] + [(1, 1536, 160, 80, "stride 0"), (4, 1536, 400, 80),
                              (1, 1536, 400, 80, "stride 0")]
# framing is one copy and at most one multiply, rounded once; overlap-add
# sums in the twin's order with the twin's rounding: both bit for bit
# the vocode through the kernels against the same vocode through the twins
# (everything else identical): the kernels equal the twins, so 0 expected
VOCODE_TOL = 1e-4
VOCODE_LAUNCHES = {"frame_window": 14, "overlap_add": 12}  # 2 chunks x (7, 6)
N_TIMED_VOCODES = 3

TRAIN_B, TRAIN_T, LABEL_DIM = 32, 512, 425
UTT_FRAMES = (300, 512)  # utterance lengths: every batch pads, masks hold zeros
N_CHECKED_STEPS = 3
N_TIMED_STEPS = 5
# launches a WGAN-GP step makes: (forward, BPTT). Config 3: the f0 head's
# BiLSTM in the no-grad fakes pass and in the generator update, and one
# BPTT. BGRU: each of 2 layers in both passes, and one BPTT per layer.
STEP_LAUNCHES = {"cnn_blstm": (2, 1), "bgru": (4, 2), "cnn_blstm_2d": (2, 1), "bgru_ln": (4, 2),
                 "cnn_blstm_1024": (2, 1), "blstm_1024": (4, 2), "bgru_1024": (4, 2),
                 "cnn_blstm_1024_f32": (2, 1), "bgru_1024_f32": (4, 2),
                 "cnn_blstm_f32": (2, 1), "bgru_f32": (4, 2),
                 "cnn_blstm_768_f32": (2, 1), "bgru_768_f32": (4, 2),
                 "cnn_blstm_2048": (2, 1), "bgru_2048": (4, 2),
                 "cnn_blstm_4096": (2, 1), "bgru_4096": (4, 2)}
# one bf16 step from identical state, kernels vs plain twins. The twins
# differ from the kernels by bf16 rounding flips in the recurrent layers;
# Adam's first step, lr·g/(|g| + eps), is sign-like, so a flip of a
# near-zero critic gradient moves that weight by up to 2·lr, which the
# generator update then reads. Metrics: relative to max(1, |value|); the
# generator's first moments (0.5·gradient): relative to each parameter's
# max|moment|. (Seen on an H100 for config 3: metrics within 2.1e-6,
# moments within 5.8e-3.)
STEP_METRIC_TOL = 1e-3
STEP_MOMENT_TOL = 2e-2


# phase 7, the training loop at config 3's width: 192 training utterances
# of 150–256 frames and 192 of 257–700 (cropped past 512), so each bucket
# gives 6 batches of 32 an epoch, one WGAN group of n_critic + 1 = 6: 2 steps
# an epoch, and no partial group waits across an epoch or the resume. 40
# validation utterances of 150–700 frames: each bucket's last batch padded.
LOOP_UTTS = ((192, 150, 256), (192, 257, 700))  # (count, min frames, max frames)
LOOP_VALID = (40, 150, 700)
LOOP_BOUNDS = (256, 512)
LOOP_EPOCHS = 2  # then a fresh Trainer resumes and runs one more
LOOP_KEEP = 2
LOOP_EMA = 0.995

# phase 8, the quick start: the demo corpus (its utterances run ~120–340
# frames), config 1's LSE run and generation, then config 3's WGAN-GP on the
# same composed corpus
QS_UTTS, QS_SEED = 160, 1234
QS_SPLIT = 16  # utterances in each of the validation and test splits
QS_BOUNDS = [256, 512]
QS_EPOCHS = 3
QS_KEEP = 1  # so that LatestN ∪ BestN on MCD is a real choice
QS_WGAN_STEPS = 2
# generate's MCD through ``cli measures`` against the saved features: the
# same cepstra, computed per file instead of in padded chunks (f32 sums)
QS_MCD_TOL = 1e-5
# a copy larger than this in a profiled device-corpus epoch would be a batch
# (one config-1 batch's labels alone are ~3 MB); the index arrays are bytes
QS_MAX_STEP_COPY = 64 * 1024

# phase 9, the remaining vocoders: config 4's mel-spectrogram target
# (bench.py:94-96) and WORLD, on phase 4's requests and phase 8's corpus.
# Griffin-Lim frames once and overlap-adds twice (the frames and the window²
# normaliser) an iteration, and renders once more: 2 chunks x (64, 130).
# WORLD's copy-synthesis makes PML's launches: 2 chunks x (7, 6).
MEL_LAUNCHES = {"frame_window": 128, "overlap_add": 260}
WORLD_LAUNCHES = {"frame_window": 14, "overlap_add": 12}
WORLD_COPY_UTTS = 8
CLI9_WGAN_STEPS = 2  # config 4 trains 1 epoch of 2 WGAN-GP steps
CLI9_WORLD_EPOCHS = 2  # WORLD trains config 1's FC generator 2 LSE epochs

# phase 10, the remaining variants. PML's "te" renders open loop: a chunk
# frames the noise once (its STFT) and overlap-adds twice (the iSTFT's
# frames and its window² normaliser): 2 chunks x (1, 2).
TE_LAUNCHES = {"frame_window": 2, "overlap_add": 4}
TE_COPY_UTTS = 8
# the analyses held against the twins on phase 8's demo wavs: (label,
# VocoderConfig fields, AnalysisParams fields)
# phase 11: the serving export
EXPORT_BOUNDS = (256, 512)  # config 3's artifacts; the requests past 512 frames are refused
EXPORT_BATCH = 8  # the throughput artifact's rows a call (phase 4's chunk)
BGRU_EXPORT_BOUND = 256
SYN_BOUND = 256  # the synthesis artifacts' bound: requests of 129–256 frames render there
# cli export's one bucket bound (11d), for the generator and the PML synthesis
# alike: it holds every test label file of the demo corpus (up to ~340
# frames), and 11c renders the served requests of 385–512 frames through it
CLI_EXPORT_BOUND = 512
CLI_EXPORT_TIMEOUT_S = 600
SYN_LAUNCHES = {"pml": {"frame_window": 7, "overlap_add": 6},  # closed loop, 2 passes
                "melspec": {"frame_window": 64, "overlap_add": 130}}  # 64 Griffin-Lim iterations
N_TIMED_EXPORT = 7
DISPATCH_CALLS = 2000  # op calls timed against the CUDA kernel's function called directly
N_DISPATCH_VOCODES = 5
# phase 12: data parallelism. A rank, or the launcher, that has not ended by
# then fails the phase (a collective that waits for a lost rank hangs)
MESH_TIMEOUT_S = 300
MESH_CLI_TIMEOUT_S = 300
# 12b's per-process corpus: the first 383 of the 384 utterances of
# ``_sets_corpus``, so rank 0's ``Dataset.shard`` holds 192 and rank 1's 191,
# which pads one row
PER_PROCESS_UTTS = 383
# the collectives counted while a per-process corpus is built: one
# all-gather of the ranks' utterance counts, nothing else
CORPUS_COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_gather_object", "all_reduce",
                      "broadcast", "broadcast_object_list", "barrier")
# phase 13: kernels #1/#2 at the widths one block cannot hold, the cluster
# routes (csrc/bilstm_{fwd,bwd}_wide{,_mma}.cu): the serving chunk, edges (T not a
# multiple of anything, T = 1), the fakes pass, widths that leave the last
# block of a cluster short (264, 608: the widest the JAX package's Pallas
# kernels run) and 100 (the BPTT's entry pads it on the one-block kernel;
# the cluster kernel is launched on it directly too)
WIDE_FWD_SHAPES = [(512, 8, 512), (517, 3, 512), (1, 1, 512), (512, 160, 512), (33, 9, 264),
                   (64, 1, 608)]
WIDE_BWD_SHAPES = [(512, 32, 512), (33, 9, 264), (40, 1, 608), (24, 5, 100)]
WIDE_AUTOGRAD_SHAPE = (512, 32, 512)
# bf16 H in (128, 256]: the one-block kernels against the cluster ones on the
# same inputs; mma_layout.LSTM_SIMT_MAX_H routes by the faster
ROUTE_SHAPE = (512, 32, 256)
WIDE_TIMED = [(512, 8, 512), (512, 32, 512), (512, 160, 512)]
# python3 chip_smoke.py --f32-times: the narrow kernels that f32 takes at
# the default blstm_size (H = 128), and the widths of the f32 cluster routes,
# "wide" against "wide_f32", forward and BPTT (264 and 336 run zero-padded on
# "wide_f32")
F32_SIMT_TIMED = [(512, 8, 128), (512, 32, 128)]
# where the f32 forward and BPTT take "narrow_f32" (H <= 256 LSTM, 320 GRU):
# it and the one-block kernel ("simt") in turns at each width and B
F32_NARROW_WIDTHS = {"lstm": (64, 96, 128, 160, 192, 256), "gru": (64, 128, 192, 256, 320)}
F32_NARROW_BATCHES = (1, 2, 4, 8, 16, 32, 160)
# the f32 BPTT's rows that mma_layout.F32_WIDE_BWD kept on "wide" before the
# few-row plan of "wide_f32", by cell, timed beside cuDNN's layer
F32_WIDE_KEPT = {"lstm": [(512, 8, 288), (512, 8, 384), (512, 6, 416)],
                 "gru": [(512, 8, 384), (512, 6, 512)]}
F32_ROUTE_WIDTHS = {"lstm": (264, 288, 320, 384, 416, 448, 512),
                    "gru": (336, 352, 384, 416, 448, 512)}
F32_ROUTE_BATCHES = (1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 160)
WIDE_MODELS = ("cnn_blstm_1024", "blstm_1024", "cnn_blstm_1024_f32")
# the f32 forms' depth (one serve of the 8 requests and one WGAN-GP step
# checked against the twins; serves timed, steps checked, steps timed)
F32_DEPTH = (3, 1, 3)
# the bf16 BPTT's tensor-core cluster kernels (route "wide_mma",
# csrc/{bilstm,bigru}_bwd_wide_mma.cu) are also held at the fakes pass's rows
WIDE_MMA_SHAPE = (512, 160, 512)
# the forward's plan at B = 160 (the LSTM's R = 56 with one h buffer) timed
# beside another (R = 40: two buffers, two waves), {(cell, B): rows}
FWD_ALT_ROWS = {("lstm", 160): 40}
WIDE_BWD_KEYS = {"wide": "_bwd", "wide_mma": "_bwd_wide_mma"}  # the err key of each BPTT route
# phase 14: kernels #3/#4 on the cluster routes (csrc/bigru_{fwd,bwd}_wide{,_mma}.cu):
# phase 13's serving chunk, edges and fakes pass at H = 512, H = 336 (in
# 321…341 the one-block forward ran and its BPTT refused; its last block
# holds 16 of 32 units), 352, 640 (the widest the JAX package's Pallas GRU
# runs, bf16) and 100 (the BPTT's entry runs it on the one-block kernel; the
# cluster kernel is launched on it directly too, its last block short)
WIDE_GRU_FWD_SHAPES = [(512, 8, 512), (517, 3, 512), (1, 1, 512), (512, 160, 512),
                       (33, 9, 336), (33, 9, 352), (64, 1, 640)]
WIDE_GRU_BWD_SHAPES = [(512, 32, 512), (33, 9, 336), (40, 1, 640), (24, 5, 100)]
WIDE_GRU_MODELS = ("bgru_1024", "bgru_1024_f32")
# phase 15: the f32 models at the default width (forwards and BPTTs
# "narrow_f32"), served and stepped at F32_DEPTH
NARROW_MODELS = ("cnn_blstm_f32", "bgru_f32")
# phase 16: the f32 BPTT's few-row plan ("wide_f32" at B <= 8,
# csrc/wide_f32_few.cuh): its models, their training rows (a card's share of
# the default batch of 32 over 4 cards) and depth (serves timed, steps
# checked, steps timed), the edge shapes it is also held on (B = 1, 3, 5, 7:
# R = 1, 2, 4 with padding rows), and the rows a cluster it is forced to
FEW_MODELS = ("cnn_blstm_768_f32", "bgru_768_f32")
FEW_TRAIN_B = 8
FEW_DEPTH = (1, 1, 3)
FEW_EDGES = {"lstm": [(33, 1, 288), (33, 3, 384), (33, 5, 416), (33, 7, 264)],
             "gru": [(33, 1, 352), (33, 3, 384), (33, 5, 512), (33, 7, 480)]}
# phase 17: the bf16 layers past the widths whose W_hᵀ slice fits a block
# beside its tiles (route "wide_mma_stream",
# csrc/{bilstm,bigru}_{fwd,bwd}_wide_mma_stream.cu): the shapes the four
# kernels are held on (the models' H = 1024 at the generator update and the
# fakes pass, the route's first widths, a padded width, its widest), the
# autograd pair's, the models (served, one step checked, steps timed at
# STREAM_DEPTH) and the timed shapes; python3 chip_smoke.py --bf16-wide-times
# times them against "wide" at each width and B below (the forwards also at
# the few rows where "wide" holds its whole slice on chip, and the rows up to
# the next tile of 8 past them, where mma_layout.BF16_WIDE_FWD stops)
STREAM_SHAPES = {"lstm": [(512, 32, 1024), (512, 160, 1024), (33, 9, 640), (40, 1, 1000),
                          (33, 9, 1536)],
                 "gru": [(512, 32, 1024), (512, 160, 1024), (33, 9, 704), (40, 1, 1000),
                         (33, 9, 1792)]}
STREAM_AUTOGRAD_SHAPE = (512, 32, 1024)
STREAM_MODELS = ("cnn_blstm_2048", "bgru_2048")
# (cut to phase 18's depth, and 17d's B = 160 row, whose times PR 25 wrote
# into PERF.md, for the run's time; the B = 160 kernels are still held
# against their twins at STREAM_SHAPES)
STREAM_DEPTH = (1, 1, 2)
STREAM_TIMED = [(512, 8, 1024), (512, 32, 1024)]
# the rows 17d times "wide" at beside the streamed kernels (its B = 160 times
# are in PERF.md: 0.6 s a call there, cut for the run's time)
STREAM_EARLIER_B = (8, 32)
# the BPTTs' widths: the 64-k layout's, then the deep layout's (its first
# width, the models' 2048, 3840, the widest, 4096); the forwards take the
# widths up to wide_mma_layout.stream_fwd_max_h
BF16_WIDE_WIDTHS = {"lstm": (640, 768, 1024, 1536, 1568, 2048, 3840, 4096),
                    "gru": (704, 768, 1024, 1536, 1792, 1824, 2048, 3840, 4096)}
BF16_WIDE_BATCHES = (1, 2, 3, 4, 5, 6, 7, 8, 32, 160)
BF16_WIDE_FWD_BATCHES = (1, 2, 3, 4, 5, 6, 7, 8, 32, 160)
# past the 64-k layout's widths "wide" takes 0.3–17 s a call (PERF.md, step
# 0): it is timed by one call a turn there, not a median of 5
BF16_WIDE_SLOW_H = 1568
# phase 18: the bf16 BPTTs past the 64-k layout's widths (the deep layout of
# "wide_mma_stream", csrc/wide_mma_stream.cuh; the forwards there stay on
# "wide" until their redesign): the shapes both kernels are held on (the
# models' H = 2048 at the generator update and the fakes pass, the first
# width past the 64-k layout, a padded width, 3840, and the widest, 4096, on
# the LSTM's 4-pair and the GRU's 2-pair kernel), the autograd
# pair's, the models (served, one step checked, steps timed at DEEP_DEPTH)
# and the timed shapes (the "wide" kernel it replaced timed in turns at
# B = 8 and 32)
DEEP_SHAPES = {"lstm": [(512, 32, 2048), (512, 160, 2048), (33, 9, 1568), (40, 1, 2000),
                        (17, 3, 3840), (17, 3, 4096)],
               "gru": [(512, 32, 2048), (512, 160, 2048), (33, 9, 1824), (40, 1, 2000),
                       (17, 3, 3840), (17, 3, 4096)]}
DEEP_AUTOGRAD_SHAPE = (512, 32, 2048)
DEEP_MODELS = ("cnn_blstm_4096", "bgru_4096")
DEEP_DEPTH = (1, 1, 2)
DEEP_TIMED = [(512, 8, 2048), (512, 32, 2048), (512, 160, 2048), (512, 8, 4096), (512, 32, 4096)]
# "wide" in turns at these B and H alone (at 4096 it takes 2.6–8.3 s a call:
# its times there are in PERF.md, step 0)
DEEP_EARLIER_B, DEEP_EARLIER_H = (8, 32), (2048,)
# bytes of spill stores phase 17a allows a streamed kernel instantiation (by
# its mangled name's kernel and template argument), 0 for any not listed:
# the forwards whose four (LSTM) / three (GRU) pairs a warp fill the 128
# registers with their accumulators, carries and gate operands, held to the
# spill ptxas reported when their design was fixed, so that a larger one
# fails (loading gx a pair at a time halved them but made a step slower;
# fewer pairs a warp would take B = 160 in two waves; PERF.md)
STREAM_SPILL_MAX = {"bilstm_fwd_wide_mma_stream_kernelILi4E": 160,
                    "bigru_fwd_wide_mma_stream_kernelILi3E": 84}
FEW_FORCED = {"lstm": [(33, 8, 384, 1), (33, 8, 384, 2), (33, 6, 416, 1)],
              "gru": [(33, 8, 512, 1), (33, 8, 512, 2), (33, 6, 384, 4)]}

ANALYSIS_VARIANTS = (
    ("world te", dict(kind="world", envelope="te"), {}),
    ("pml ps_reflect", {}, dict(ps_reflect=True)),
    ("pml ps_shift", {}, dict(ps_shift=True)),
    ("pml ps_shift snap", {}, dict(ps_shift=True, ps_shift_snap=True)),
    ("pml ps_shift_nm_only", {}, dict(ps_shift=True, ps_shift_nm_only=True)),
    ("pml psync=False", {}, dict(psync=False)),
)


def _kernels() -> dict:
    """The kernel wrappers by name; each counts its launches."""
    from percivaltts_tpu_torch.ops.frames_cuda import frame_window, overlap_add
    from percivaltts_tpu_torch.ops.gru_cuda import bigru_bwd, bigru_fwd
    from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_bwd, bilstm_fwd

    return {"bilstm_fwd": bilstm_fwd, "bilstm_bwd": bilstm_bwd,
            "bigru_fwd": bigru_fwd, "bigru_bwd": bigru_bwd,
            "frame_window": frame_window, "overlap_add": overlap_add}


def _zero_counts() -> None:
    for name, fn in _kernels().items():
        fn.launches = 0
        if name in ROUTED:
            fn.routes = {route: 0 for route in fn.routes}
        if name in PLANNED:
            fn.wide_f32_plans = {plan: 0 for plan in fn.wide_f32_plans}
            fn.stream_layouts = {layout: 0 for layout in fn.stream_layouts}


def _counts() -> dict:
    return {name: fn.launches for name, fn in _kernels().items()}


def _routes() -> dict:
    """The recurrent wrappers' launches by route: {name: {route: n}}."""
    kernels = _kernels()
    return {name: dict(kernels[name].routes) for name in ROUTED}


def _plans() -> dict:
    """The BPTT wrappers' ``"wide_f32"`` launches by the kernel their plan
    took and ``"wide_mma_stream"`` launches by the layout theirs took:
    {name: {"chunked": n, "few": n, "64k": n, "deep": n}}."""
    kernels = _kernels()
    return {name: {**kernels[name].wide_f32_plans, **kernels[name].stream_layouts}
            for name in PLANNED}


def _no_routes() -> dict:
    """{name: {route: 0}} for every route of each recurrent wrapper."""
    kernels = _kernels()
    return {name: dict.fromkeys(kernels[name].routes, 0) for name in ROUTED}


def _all_mma(what: str, routes: dict, f32: bool = False) -> None:
    """Every forward and BPTT launch of a bf16 path went through the
    tensor-core routes (an f32 path's routes are printed: the path that runs
    it checks them)."""
    print(f"[{what}] recurrent launches by route {routes}")
    if not f32 and any(r["simt"] for r in routes.values()):
        raise AssertionError(f"{what}: a bf16 forward or BPTT took the CUDA-core route: {routes}")


def _is_gru(kind: str) -> bool:
    return MODELS[kind]["generator"] == "bgru"


def _is_f32(kind: str) -> bool:
    """An f32 model: its recurrences may take the CUDA-core routes."""
    return MODELS[kind].get("compute_dtype") == "float32"


def _use_twins(model):
    """Point every recurrent layer of ``model`` at the plain twins of both
    kernels; returns a function that puts the kernels back."""
    from percivaltts_tpu_torch.models.rnn import BiLSTM
    from percivaltts_tpu_torch.ops.gru_cuda import bigru_core_reference
    from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_core_reference

    layers = [m for m in model.modules() if isinstance(m, BiLSTM)]
    saved = [m.core for m in layers]
    for m in layers:
        m.core = bigru_core_reference if m.cell_type == "gru" else bilstm_core_reference
    return lambda: [setattr(m, "core", c) for m, c in zip(layers, saved)]


def _bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms, "bytes" or "operations"): each input read once and each
    output written once at the HBM rate, against the recurrent products'
    FLOPs at the peak rate of the input type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_bound(name: str, T: int, B: int, H: int, dtype) -> tuple:
    s = torch.finfo(dtype).bits // 8
    TBH = T * B * H
    G = 3 if name.startswith("bigru") else 4
    if name == "bilstm_fwd":  # gx, W_h in; y out (both directions)
        nbytes = 2 * (G * TBH + H * G * H + TBH)
    elif name == "bilstm_bwd":  # gx, W_h, h_prev, c_prev, c, dy in; dgx out
        nbytes = 2 * (G * TBH + H * G * H + 4 * TBH + G * TBH)
    elif name == "bigru_fwd":  # gx, W_h, b_hn in; y out
        nbytes = 2 * (G * TBH + H * G * H + H + TBH)
    else:  # bigru_bwd: gx, W_h, b_hn, h_prev, dy in; dgx, dnr out
        nbytes = 2 * (G * TBH + H * G * H + H + 2 * TBH + G * TBH + TBH)
    products = 1 if name.endswith("fwd") else 2  # h·W_h; and dgates·W_hᵀ
    flops = 2 * T * products * 2 * B * H * G * H
    return _bound(nbytes * s, flops, dtype)


def _median_ms(fn, runs: int, inner: int = 1) -> float:
    """Median over ``runs`` of the CUDA-event time of ``inner`` calls of
    ``fn``, per call, after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _ratio(a, b):
    """a / b, or None when either was not measured."""
    return None if a is None or b is None else a / b


def _normal(g: torch.Generator, shape, device, dtype, scale: float = 1.0) -> torch.Tensor:
    """Normal values of ``shape`` times ``scale``, drawn in f32 on ``device``
    from ``g`` and cast to ``dtype`` (made on the card: numpy took seconds
    for the fakes pass's gates)."""
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def _gates(T, B, H, dtype, device, seed):
    """gx_f, gx_b (T, B, 4H) and W_h (H, 4H) per direction, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    gx = [_normal(g, (T, B, 4 * H), device, dtype) for _ in range(2)]
    wh = [_normal(g, (H, 4 * H), device, dtype, 1 / math.sqrt(H)) for _ in range(2)]
    return gx[0], gx[1], wh[0], wh[1]


def _gru_gates(T, B, H, dtype, device, seed):
    """gx_f, gx_b (T, B, 3H), W_h (H, 3H) and b_hn (H,) per direction."""
    g = torch.Generator(device=device).manual_seed(seed)
    gx = [_normal(g, (T, B, 3 * H), device, dtype) for _ in range(2)]
    wh = [_normal(g, (H, 3 * H), device, dtype, 1 / math.sqrt(H)) for _ in range(2)]
    bn = [_normal(g, (H,), device, dtype) for _ in range(2)]
    return gx[0], gx[1], wh[0], wh[1], bn[0], bn[1]


def _dy(T, B, H, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return _normal(g, (T, B, H), device, dtype), _normal(g, (T, B, H), device, dtype)


def _bwd_args(T, B, H, dtype, device, seed):
    """The BiLSTM BPTT inputs from a forward pass of the plain twin: gx,
    W_h, the previous states (t−1 forward, t+1 backward), the cells and
    random dy."""
    from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_fwd_reference

    gx_f, gx_b, wh_f, wh_b = _gates(T, B, H, dtype, device, seed)
    with torch.no_grad():
        yf, yb, cf, cb = bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells=True)
    z = torch.zeros_like(yf[:1])
    return (gx_f, gx_b, wh_f, wh_b, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
            torch.cat([z, cf[:-1]]), torch.cat([cb[1:], z]), cf, cb,
            *_dy(T, B, H, dtype, device, seed + 1))


def _gru_bwd_args(T, B, H, dtype, device, seed):
    """The BiGRU BPTT inputs: gx, W_h, b_hn, the previous states from the
    twin's compute-dtype outputs (t−1 forward, t+1 backward) and random dy."""
    from percivaltts_tpu_torch.ops.gru_cuda import bigru_fwd_reference

    args = _gru_gates(T, B, H, dtype, device, seed)
    with torch.no_grad():
        yf, yb = bigru_fwd_reference(*args)
    z = torch.zeros_like(yf[:1])
    return (*args, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
            *_dy(T, B, H, dtype, device, seed + 1))


def _compare(label, got, want, tol, relative: bool) -> float:
    """max |kernel − twin| over the outputs, against ``tol`` (times the
    largest |twin| when ``relative``); raises when it is exceeded."""
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    scale = max(w.float().abs().max().item() for w in want)
    limit = tol * scale if relative else tol
    same = all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want))
    print(f"{label}: max|kernel-plain| = {err:.3g} (tol {limit:.3g}; max|plain| {scale:.3g})")
    if not same or not err <= limit:
        raise AssertionError(f"{label}: the kernel disagrees with its plain twin")
    return err


def _launch_once(fn, *args, route=None, **kw):
    """``fn(*args)`` synchronized, checking that it counted one launch (on
    ``route``, for the recurrent wrappers)."""
    before = fn.launches
    on_route = fn.routes[route] if route else 0
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    if fn.launches != before + 1:
        raise RuntimeError(f"{fn.__name__} did not count its launch")
    if route and fn.routes[route] != on_route + 1:
        raise RuntimeError(f"{fn.__name__} did not launch its {route} kernel")
    return out


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary (the wrappers copy such a view before a ``cp.async`` kernel)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned view is aligned")
    return view


def _f32_key(name: str, route: str) -> str:
    """The error key of an f32 kernel of phase 3: ``*_narrow_f32``, or the
    one-block kernel's ``*_simt_f32``."""
    return f"{name}_{route}" + ("_f32" if route == "simt" else "")


def _check_kernels(dev) -> dict:
    """Phase 3: every kernel against its twin. Returns each kernel's largest
    bf16 |kernel − twin|, and the f32 forwards' and BPTTs' on their narrow
    cluster kernels (``*_fwd_narrow_f32``, ``*_bwd_narrow_f32``) and on the
    one-block ones they replaced (``*_simt_f32``, launched directly beside
    them)."""
    from percivaltts_tpu_torch.ops import gru_cuda as g
    from percivaltts_tpu_torch.ops import lstm_cuda as l
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    bf16 = torch.bfloat16
    err = {name: 0.0 for name in _kernels()}
    err.update({_f32_key(f"{n}_{p}", r): 0.0
                for n in ("bilstm", "bigru") for p in ("fwd", "bwd") for r in ("narrow_f32", "simt")})

    def held(key, e):  # an f32 kernel's error on its route or beside it
        err[key] = max(err.get(key, 0.0), e)
    with torch.no_grad():
        for T, B, H in KERNEL_SHAPES:
            for dtype, tol in KERNEL_TOL.items():
                route = fwd_route(dtype, H)
                args = _gates(T, B, H, dtype, dev, seed=T + B)
                want = l.bilstm_fwd_reference(*args, with_cells=True)
                for cells in (False, True):
                    got = _launch_once(l.bilstm_fwd, *args, with_cells=cells, route=route)
                    e = _compare(f"[bilstm_fwd {route}] T={T} B={B} H={H} {str(dtype)[6:]} "
                                 f"cells={cells}", got, want[:len(got)], tol, relative=False)
                    err["bilstm_fwd"] = max(err["bilstm_fwd"], e if dtype == bf16 else 0.0)
                    if dtype != bf16:
                        held(_f32_key("bilstm_fwd", route), e)
                if dtype != bf16:  # f32: the narrow cluster kernel, and the one-block one beside it
                    other = "simt" if route == "narrow_f32" else "narrow_f32"
                    held(_f32_key("bilstm_fwd", other), _compare(
                        f"[bilstm_fwd {other}, launched] T={T} B={B} H={H} f32 cells=True",
                        l.fwd_launch(other, *args, with_cells=True), want, tol, False))
        for T, B, H in KERNEL_SHAPES:
            for dtype, tol in KERNEL_TOL.items():
                route = fwd_route(dtype, H, "gru")
                args = _gru_gates(T, B, H, dtype, dev, seed=T + B)
                want = g.bigru_fwd_reference(*args)
                got = _launch_once(g.bigru_fwd, *args, route=route)
                e = _compare(f"[bigru_fwd {route}] T={T} B={B} H={H} {str(dtype)[6:]}", got,
                             want, tol, relative=False)
                err["bigru_fwd"] = max(err["bigru_fwd"], e if dtype == bf16 else 0.0)
                if dtype != bf16:
                    held(_f32_key("bigru_fwd", route), e)
                    other = "simt" if route == "narrow_f32" else "narrow_f32"
                    held(_f32_key("bigru_fwd", other), _compare(
                        f"[bigru_fwd {other}, launched] T={T} B={B} H={H} f32",
                        g.fwd_launch(other, *args), want, tol, False))
        bwd_cases = [(shape, dtype) for shape in BWD_SHAPES for dtype in BWD_TOL]
        bwd_cases += [(shape, bf16) for shape in BWD_MMA_SHAPES]
        for (T, B, H), dtype in bwd_cases:
            tol, rel = BWD_TOL[dtype], dtype == bf16
            for unaligned in (False, True) if (T, B, H) == BWD_UNALIGNED and rel else (False,):
                route = bwd_route(dtype, H, "lstm")
                tag = f"{route}{', gx unaligned' if unaligned else ''}"
                args = _bwd_args(T, B, H, dtype, dev, seed=T + B)
                if unaligned:
                    args = (_unaligned(args[0]), *args[1:])
                got = _launch_once(l.bilstm_bwd, *args, route=route)
                want = l.bilstm_bwd_reference(*args)
                e = _compare(f"[bilstm_bwd {tag}] T={T} B={B} H={H} {str(dtype)[6:]}", got,
                             want, tol, rel)
                err["bilstm_bwd"] = max(err["bilstm_bwd"], e if rel else 0.0)
                if not rel:  # f32: the narrow cluster kernel, and the one-block one beside it
                    held(_f32_key("bilstm_bwd", route), e)
                    other = "simt" if route == "narrow_f32" else "narrow_f32"
                    held(_f32_key("bilstm_bwd", other),
                         _compare(f"[bilstm_bwd {other}, launched] T={T} B={B} H={H} f32",
                                  l.bwd_launch(other, *args), want, tol, rel))
                route = bwd_route(dtype, H, "gru")
                args = _gru_bwd_args(T, B, H, dtype, dev, seed=T + B)
                if unaligned:
                    args = (_unaligned(args[0]), *args[1:])
                got = _launch_once(g.bigru_bwd, *args, route=route)
                want = g.bigru_bwd_reference(*args)
                others = ((route, got),)
                if not rel:
                    other = "simt" if route == "narrow_f32" else "narrow_f32"
                    others += ((other, g.bwd_launch(other, *args)),)
                for r, out in others:
                    for what, sl in (("dgx", slice(0, 2)), ("dnr", slice(2, 4))):
                        e = _compare(f"[bigru_bwd {r}{'' if r == route else ', launched'}"
                                     f"{', gx unaligned' if unaligned else ''}] {what} T={T} B={B} "
                                     f"H={H} {str(dtype)[6:]}", out[sl], want[sl], tol, rel)
                        err["bigru_bwd"] = max(err["bigru_bwd"], e if rel else 0.0)
                        if not rel:
                            held(_f32_key("bigru_bwd", r), e)
        # a cluster whose last block is short, launched directly
        for name, m, make, cell in (("bilstm_bwd", l, _bwd_args, "lstm"),
                                    ("bigru_bwd", g, _gru_bwd_args, "gru")):
            T, B, H, blocks = NARROW_SHORT[cell]
            args = make(T, B, H, torch.float32, dev, seed=T + B)
            p = l.narrow_f32_plan(name[:-4], B, H, blocks)
            if not (p.U - 1) * p.Hb < H < p.U * p.Hb:
                raise AssertionError(f"{name} narrow_f32 at H={H} over {blocks} blocks: {p} "
                                     "leaves no short last block")
            held(f"{name}_narrow_f32", _compare(
                f"[{name} narrow_f32, launched, {p.U} blocks of {p.Hb} units, the last "
                f"{H - (p.U - 1) * p.Hb}] T={T} B={B} H={H} f32",
                m.bwd_launch("narrow_f32", *args, blocks=blocks), getattr(m, f"{name}_reference")(*args),
                BWD_TOL[torch.float32], False))
        # the narrow forwards with their plan's overrides: short splits, and
        # the kind of plan the entry does not take at the width
        for cell, (T, B, H), kw in NARROW_FWD_FORCED:
            gru = cell == "gru"
            m, name = (g, "bigru_fwd") if gru else (l, "bilstm_fwd")
            args = (_gru_gates if gru else _gates)(T, B, H, torch.float32, dev, seed=T + B)
            p = l.narrow_f32_fwd_plan(name[:-4], B, H, kw.get("blocks", 0), kw.get("rows", 0),
                                      kw["resident"])
            if "blocks" in kw and not (p.U - 1) * p.Hb < H < p.U * p.Hb:
                raise AssertionError(f"{name} narrow_f32 at H={H} over {kw['blocks']} blocks: "
                                     f"{p} leaves no short last block")
            cells = {} if gru else {"with_cells": True}
            want = g.bigru_fwd_reference(*args) if gru else l.bilstm_fwd_reference(*args, **cells)
            held(f"{name}_narrow_f32", _compare(
                f"[{name} narrow_f32, launched, {p.U} blocks of {p.Hb} units, R {p.R}, W_h in "
                f"{'registers' if p.resident else 'shared memory'}] T={T} B={B} H={H} f32",
                m.fwd_launch("narrow_f32", *args, **cells, **kw), want, KERNEL_TOL[torch.float32],
                False))

    # the autograd pairs: forward kernel + BPTT kernel against the twins
    T, B, H = AUTOGRAD_SHAPE
    pairs = (
        ("BiLSTM", l.bilstm_core, l.bilstm_core_reference, _gates, l.bilstm_fwd, l.bilstm_bwd,
         ("dgx_f", "dgx_b", "dW_h_f", "dW_h_b"), "lstm"),
        ("BiGRU", g.bigru_core, g.bigru_core_reference, _gru_gates, g.bigru_fwd, g.bigru_bwd,
         ("dgx_f", "dgx_b", "dW_h_f", "dW_h_b", "db_hn_f", "db_hn_b"), "gru"),
    )
    for label, core, twin, make, fwd, bwd, names, cell in pairs:
        for dtype, tol in BWD_TOL.items():
            base = make(T, B, H, dtype, dev, seed=7)
            dy = _dy(T, B, H, dtype, dev, seed=1)
            grads = []
            route, broute = fwd_route(dtype, H, cell), bwd_route(dtype, H, cell)
            for c in (core, twin):
                leaves = [t.clone().requires_grad_(True) for t in base]
                f0, b0 = fwd.routes[route], bwd.routes[broute]
                torch.autograd.backward(c(*leaves), dy)
                torch.cuda.synchronize()
                grads.append([t.grad for t in leaves])
                if c is core and (fwd.routes[route] - f0, bwd.routes[broute] - b0) != (1, 1):
                    raise RuntimeError(f"the {label} autograd pair did not launch one forward "
                                       f"kernel on the {route} route and one BPTT kernel on the "
                                       f"{broute} route")
            for name, gk, gt in zip(names, *grads):
                scale = gt.float().abs().max().item()
                limit = tol * scale if dtype == bf16 else tol * max(1.0, scale)
                _compare(f"[autograd {label}] {name} T,B,H={AUTOGRAD_SHAPE} {str(dtype)[6:]}",
                         [gk], [gt], limit, relative=False)
    return err


def _requests(n_features: int):
    """The 8 serving requests (raw labels: binary question answers and
    continuous positions, ``REQUEST_LENGTHS`` frames) and the input and
    output stats they are served with, made with numpy from ``SEED``."""
    from percivaltts_tpu_torch.eval.serve import NormStats

    rng = np.random.default_rng(SEED)
    labs = []
    for n in REQUEST_LENGTHS:
        lab = (rng.random((n, LABEL_DIM)) < 0.1).astype(np.float32)
        lab[:, -9:] = rng.random((n, 9)) * 10.0
        labs.append(lab)
    in_stats = NormStats(shift=np.full(LABEL_DIM, 0.1, np.float32),
                         scale=rng.uniform(0.5, 2.0, LABEL_DIM).astype(np.float32))
    out_stats = NormStats(shift=rng.normal(size=n_features).astype(np.float32),
                          scale=rng.uniform(0.5, 2.0, n_features).astype(np.float32))
    return labs, in_stats, out_stats


def _serve_path(dev, kind: str, n_timed: int = 7) -> dict:
    """Phase 4 for one generator: serve 8 requests, count launches, compare
    with the twins, time the serve (median of ``n_timed``)."""
    from percivaltts_tpu_torch import ModelConfig, VocoderConfig
    from percivaltts_tpu_torch.eval.serve import serve
    from percivaltts_tpu_torch.models import build_generator, count_params
    from percivaltts_tpu_torch.models.rnn import BiLSTM

    model_cfg, voc, label_dim = ModelConfig(**MODELS[kind]), VocoderConfig(), LABEL_DIM
    gen = build_generator(model_cfg, voc, label_dim,
                          generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    n_params = count_params(gen)
    if n_params != PARAMS[kind]:
        raise AssertionError(f"{kind} has {PARAMS[kind]:,} parameters, built {n_params:,}")
    labs, in_stats, out_stats = _requests(voc.feature_size)
    calls = [0]
    gen.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))

    _zero_counts()
    calls[0] = 0
    feats = serve(gen, labs, in_stats, out_stats)
    counts, gen_calls, routes, plans = _counts(), calls[0], _routes(), _plans()
    fwd = "bigru_fwd" if _is_gru(kind) else "bilstm_fwd"
    per_call = sum(isinstance(m, BiLSTM) for m in gen.modules())  # recurrent layers
    print(f"[serve {kind}] {len(labs)} requests, {gen_calls} generator calls, launches {counts}")
    if not (counts[fwd] > 0 and counts[fwd] == per_call * gen_calls
            and sum(counts.values()) == counts[fwd]):
        raise AssertionError(f"{counts} kernel launches for {gen_calls} generator calls")
    _all_mma(f"serve {kind}", routes, f32=_is_f32(kind))
    for n, f in zip(REQUEST_LENGTHS, feats):
        if f.shape != (n, voc.feature_size) or f.dtype != np.float32 or not np.isfinite(f).all():
            raise AssertionError(f"bad features for a {n}-frame request: {f.shape} {f.dtype}")

    restore = _use_twins(gen)
    plain = serve(gen, labs, in_stats, out_stats)
    restore()
    serve_err = max(np.abs(a - b).max() for a, b in zip(feats, plain))
    print(f"[serve {kind}] {n_params:,} parameters; max|kernel-plain| over all features = "
          f"{serve_err:.3g} (tol {SERVE_TOL[kind]:g})")
    if not serve_err <= SERVE_TOL[kind]:
        raise AssertionError("served features disagree with the plain twins")

    serve(gen, labs, in_stats, out_stats)  # warm-up
    lat = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(gen, labs, in_stats, out_stats)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    med = statistics.median(lat)
    frames = sum(REQUEST_LENGTHS)
    print(f"[time] serve {kind}, {len(labs)} requests ({frames} frames): median {med * 1e3:.3f} ms "
          f"(min {min(lat) * 1e3:.3f}, max {max(lat) * 1e3:.3f}), {frames / med:.0f} frames/s")
    busy_share, _ = _profiled(f"serve {kind}", lambda: serve(gen, labs, in_stats, out_stats),
                              RECURRENT)
    return {"counts": counts, "routes": routes, "plans": plans, "serve_ms": med * 1e3,
            "err": float(serve_err), "feats": feats, "busy_share": busy_share}


def _train_setup(dev, kind: str, mesh=None):
    """Config 3's data, critic and options at full width with the ``kind``
    generator, WGAN-GP, two sets of batches (5 critic batches + 1 generator
    batch each) on the device, raw, and the normalizing step (over
    ``mesh``'s ranks when one is given: the batches stay global)."""
    from percivaltts_tpu_torch import (Configuration, DataConfig, ModelConfig, TrainConfig,
                                       VocoderConfig)
    from percivaltts_tpu_torch.eval.serve import NormStats
    from percivaltts_tpu_torch.training.ondevice import make_normalizing_step
    from percivaltts_tpu_torch.training.wgan import make_wgan_step

    cfg = Configuration(
        data=DataConfig(batch_size=TRAIN_B, bucket_bounds=(TRAIN_T,), label_dim=LABEL_DIM),
        vocoder=VocoderConfig(spec_size=65, nm_size=33),
        model=ModelConfig(**MODELS[kind]),
        train=TrainConfig(trainer="wgan", n_critic=5, seed=SEED),
    )
    nc, F = cfg.train.n_critic, cfg.vocoder.feature_size
    rng = np.random.default_rng(SEED + 10)
    # padded batches as the data pipeline gives them: utterances zero-padded
    # to the bound, mask 1 on their frames and 0 after
    batches = []
    for _ in range(2 * (nc + 1)):
        lengths = rng.integers(UTT_FRAMES[0], UTT_FRAMES[1] + 1, size=TRAIN_B)
        mask = (np.arange(TRAIN_T) < lengths[:, None]).astype(np.float32)
        lab = (rng.random((TRAIN_B, TRAIN_T, LABEL_DIM)) < 0.1).astype(np.float32)
        lab[..., -9:] = rng.random((TRAIN_B, TRAIN_T, 9)) * 10.0  # continuous positions
        cmp = (rng.normal(size=(TRAIN_B, TRAIN_T, F)) * 2.0 + 1.0).astype(np.float32)
        batch = {"lab": lab * mask[..., None], "cmp": cmp * mask[..., None], "mask": mask}
        batches.append({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    if not all(b["mask"].min() == 0 for b in batches):
        raise AssertionError("the smoke batches are not all padded")
    sets = []
    for i in range(2):
        group = batches[i * (nc + 1):(i + 1) * (nc + 1)]
        critic = {k: torch.stack([b[k] for b in group[:nc]]) for k in group[0]}
        sets.append((critic, group[nc]))
    in_stats = NormStats(shift=np.full(LABEL_DIM, 0.1, np.float32),
                         scale=rng.uniform(0.5, 2.0, LABEL_DIM).astype(np.float32))
    out_stats = NormStats(shift=np.ones(F, np.float32), scale=np.full(F, 0.5, np.float32))
    step = make_normalizing_step(make_wgan_step(cfg.train, mesh=mesh), in_stats, out_stats, dev)
    return cfg, sets, step


def _busy_share(prof, wall_ms: float):
    """(device busy ms as the union of device event intervals, share of
    ``wall_ms``, [(kernel name, device ms, count)] largest first) from a
    torch.profiler run; None when the trace holds no device events."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.time_range.end > e.time_range.start]
    if not events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy = (busy + hi - lo) / 1e3
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    top = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda t: -t[1])
    return busy, busy / wall_ms, top


RECURRENT = ("bilstm", "bigru")  # the recurrent kernels' symbol names hold one of these


def _profiled(label: str, fn, keys: tuple):
    """Run ``fn`` once under ``torch.profiler``; print its wall time, the
    device's busy time and share, the device time of the kernels whose names
    hold one of ``keys``, and the 12 largest kernels. Returns (busy share,
    those kernels' device ms), or (None, None) when the trace holds no
    device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    share = _busy_share(prof, wall)
    if share is None:
        print(f"[profile {label}] {wall:.3f} ms wall; the trace holds no device events: busy "
              "share not measured")
        return None, None
    busy, busy_share, top = share
    sel = [t for t in top if any(k in t[0] for k in keys)]
    print(f"[profile {label}] {wall:.3f} ms wall (profiled), device busy {busy:.3f} ms, busy "
          f"share {busy_share:.3f}; {sum(n for *_, n in top)} device events; {'/'.join(keys)} "
          f"kernels {sum(ms for _, ms, _ in sel):.3f} ms x{sum(n for *_, n in sel)}")
    for key, ms, count in top[:12]:
        print(f"[profile {label}]   {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    return busy_share, sum(ms for _, ms, _ in sel)


def _train_path(dev, kind: str, n_checked: int = 0, n_timed: int = 0) -> dict:
    """Phase 5 and the step timing of phase 6 for one generator: ``n_checked``
    steps checked (``N_CHECKED_STEPS`` by default), ``n_timed`` timed
    (``N_TIMED_STEPS``). Returns the launch counts of the checked steps and
    the timings."""
    from percivaltts_tpu_torch.training.state import make_gan_state

    n_checked, n_timed = n_checked or N_CHECKED_STEPS, n_timed or N_TIMED_STEPS
    cfg, sets, step = _train_setup(dev, kind)
    nc = cfg.train.n_critic
    kernels = _kernels()
    fwd, bwd = (kernels["bigru_fwd"], kernels["bigru_bwd"]) if _is_gru(kind) else \
        (kernels["bilstm_fwd"], kernels["bilstm_bwd"])
    state = make_gan_state(cfg, LABEL_DIM, seed=SEED, device=dev)

    _zero_counts()
    for s in range(n_checked):
        f0, b0 = fwd.launches, bwd.launches
        state, m = step(state, *sets[s % 2])
        torch.cuda.synchronize()
        vals = {k: v.item() for k, v in m.items()}
        launched = (fwd.launches - f0, bwd.launches - b0)
        print(f"[train {kind}] step {s}: " + " ".join(f"{k} {v:.6g}" for k, v in vals.items())
              + f"; launches fwd {launched[0]} bptt {launched[1]}")
        if launched != STEP_LAUNCHES[kind]:
            raise AssertionError(f"a WGAN step launched {launched}, not {STEP_LAUNCHES[kind]}")
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite metrics at step {s}: {vals}")
    counts, routes, plans = _counts(), _routes(), _plans()
    if sum(counts.values()) != fwd.launches + bwd.launches:
        raise AssertionError(f"the {kind} steps launched another generator's kernels: {counts}")
    _all_mma(f"train {kind}", routes, f32=_is_f32(kind))
    if not all(torch.isfinite(p).all() for p in state.gen.parameters()):
        raise AssertionError("non-finite generator parameters after training")

    # one step from identical state: kernels vs plain twins (launches of
    # this comparison are not counted above)
    eps = torch.rand((nc, TRAIN_B, 1, 1), generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    ref = {}
    for name in ("kernel", "plain"):
        st = make_gan_state(cfg, LABEL_DIM, seed=SEED, device=dev)
        if name == "plain":
            _use_twins(st.gen)
        st, m = step(st, *sets[0], eps=eps)
        torch.cuda.synchronize()
        ref[name] = ({k: v.item() for k, v in m.items()},
                     {n: st.gen_opt.state[p]["exp_avg"] for n, p in st.gen.named_parameters()})
    _hold_step(f"train {kind}", "kernel vs plain step", ref["kernel"], ref["plain"])

    for i in range(2):  # warm-up
        state, _ = step(state, *sets[i])
    times = []
    for i in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, *sets[i % 2])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    frames = TRAIN_B * TRAIN_T * (nc + 1)
    print(f"[time] WGAN-GP step {kind} (B={TRAIN_B}, T={TRAIN_T}, n_critic={nc}): median "
          f"{step_ms:.3f} ms (min {min(times):.3f}, max {max(times):.3f}, {n_timed} "
          f"steps), {frames / step_ms * 1e3:.1f} frames/s")
    print(f"[time] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")

    busy_share, _ = _profiled(f"{kind}, one step", lambda: step(state, *sets[0]), RECURRENT)
    return {"counts": counts, "routes": routes, "plans": plans, "step_ms": step_ms,
            "busy_share": busy_share, "checked": n_checked}


def _hold_step(tag: str, what: str, got, want) -> None:
    """One WGAN-GP step's (metrics, generator Adam first moments by name)
    against a reference step's, at one bf16 step's tolerances; every
    comparison is printed before a disagreement raises."""
    (mk, ek), (mp, ep) = got, want
    bad = []
    for k in mk:
        err = abs(mk[k] - mp[k])
        limit = STEP_METRIC_TOL * max(1.0, abs(mp[k]))
        print(f"[{tag}] {what}, {k}: {mk[k]:.6g} vs {mp[k]:.6g} (|diff| {err:.3g}, tol "
              f"{limit:.3g})")
        if not err <= limit:
            bad.append(k)
    rel = {n: (ek[n] - ep[n]).abs().max().item() / max(ep[n].abs().max().item(), 1e-30)
           for n in ek}
    worst = max(rel, key=rel.get)
    print(f"[{tag}] {what}, generator exp_avg: worst relative |diff| {rel[worst]:.3g} "
          f"({worst}; tol {STEP_MOMENT_TOL:g}); recurrent layers: "
          + ", ".join(f"{n} {r:.3g}" for n, r in rel.items() if "blstm" in n))
    if not rel[worst] <= STEP_MOMENT_TOL:
        bad.append("generator exp_avg")
    if bad:
        raise AssertionError(f"{tag}: {what} disagrees on {bad}")


def _loop_corpus(rng, groups):
    """Raw utterances as ``_train_setup`` makes its batches' rows: binary
    question answers with continuous positions, targets N(1, 2²); for each
    (count, min frames, max frames) in ``groups``."""
    from percivaltts_tpu_torch.data.dataset import Dataset

    labs, cmps = [], []
    for count, lo, hi in groups:
        for n in rng.integers(lo, hi + 1, size=count):
            lab = (rng.random((n, LABEL_DIM)) < 0.1).astype(np.float32)
            lab[:, -9:] = rng.random((n, 9)) * 10.0
            labs.append(lab)
            cmps.append((rng.normal(size=(n, 99)) * 2.0 + 1.0).astype(np.float32))
    return Dataset(labs, cmps)


def _bucket_batches(ds, B: int, bounds, whole: bool) -> dict:
    """Batches a bucket gives an epoch, from the utterance lengths alone:
    whole ones (training drops the remainder) or all (validation pads)."""
    counts = dict.fromkeys(bounds, 0)
    for lab in ds.labs:
        counts[next((b for b in bounds if lab.shape[0] <= b), bounds[-1])] += 1
    return {b: (n // B if whole else -(-n // B)) for b, n in counts.items()}


def _trace_busy(path: str):
    """(device busy ms as the union of the trace's kernel, copy and set
    intervals, the traced span's wall ms, ms from the span's start to the
    first device event) from a Chrome trace of ``torch.profiler``; None
    when it holds no device events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    start = min(e["ts"] for e in events)
    wall = max(e["ts"] + e.get("dur", 0) for e in events) - start
    return busy / 1e3, wall / 1e3, (spans[0][0] - start) / 1e3


def _host_copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _tree_diff(a, b, path="state") -> list:
    """Paths at which two state trees differ (tensors compared bit for bit,
    on the host)."""
    if isinstance(a, torch.Tensor):
        same = isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(
            a.cpu(), b.cpu())
        return [] if same else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [path]
        return [d for k in a for d in _tree_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _tree_diff(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def _retained(scores, keep: int) -> list:
    """The checkpoints Orbax's LatestN ∪ BestN keeps when every epoch saves
    with its score (lower is better, ties to the newer)."""
    kept = []
    for epoch in range(len(scores)):
        live = [(e, v) for e, v in enumerate(scores[:epoch + 1]) if e in kept or e == epoch]
        latest = {e for e, _ in live[-keep:]}
        best = {e for e, _ in sorted(live, key=lambda ev: (ev[1], -ev[0]))[:keep]}
        kept = sorted(latest | best)
    return kept


def _loop_setup(name: str):
    """Phase 7's config (config 3 through ``Trainer``: WGAN-GP, n_critic=5,
    B=32, buckets 256/512, EMA 0.995) with its workdir ``build/<name>``
    (emptied), its numpy corpus and the normalization stats:
    (cfg, train_ds, valid_ds, in_stats, out_stats)."""
    import os
    import shutil

    from percivaltts_tpu_torch import (Configuration, DataConfig, ModelConfig, TrainConfig,
                                       VocoderConfig)
    from percivaltts_tpu_torch.eval.serve import NormStats

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", name)
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = Configuration(
        workdir=workdir,
        data=DataConfig(batch_size=TRAIN_B, bucket_bounds=LOOP_BOUNDS, label_dim=LABEL_DIM),
        vocoder=VocoderConfig(spec_size=65, nm_size=33),
        model=ModelConfig(generator="cnn_blstm"),
        train=TrainConfig(trainer="wgan", n_critic=5, seed=SEED, ema_decay=LOOP_EMA,
                          profile_steps=2, keep_checkpoints=LOOP_KEEP),
    )
    rng = np.random.default_rng(SEED + 20)
    train_ds, valid_ds = _loop_corpus(rng, LOOP_UTTS), _loop_corpus(rng, (LOOP_VALID,))
    F = cfg.vocoder.feature_size
    in_stats = NormStats(shift=np.full(LABEL_DIM, 0.1, np.float32),
                         scale=rng.uniform(0.5, 2.0, LABEL_DIM).astype(np.float32))
    out_stats = NormStats(shift=np.ones(F, np.float32), scale=np.full(F, 0.5, np.float32))
    return cfg, train_ds, valid_ds, in_stats, out_stats


def _train_loop_path(dev, card: str) -> dict:
    """Phase 7: the ``Trainer`` at config 3's width (WGAN-GP, n_critic=5,
    B=32, buckets 256/512, EMA 0.995) on a numpy corpus normalized on the
    device: 2 epochs (the second profiled for 2 steps), then a fresh
    ``Trainer`` on the same workdir resumes and runs a third. Checks the
    epoch records, the launches, the retained checkpoints, the resume bit
    for bit against the state saved at that step, the trace, and serving
    the best checkpoint's EMA. Returns the launch counts of the run."""
    import os
    import shutil

    from percivaltts_tpu_torch.eval.serve import serve
    from percivaltts_tpu_torch.models import build_generator
    from percivaltts_tpu_torch.training import Trainer
    from percivaltts_tpu_torch.training.checkpoints import STATE_FILE, CheckpointManager
    from percivaltts_tpu_torch.training.state import eval_generator, make_gan_state

    t0 = time.perf_counter()
    cfg, train_ds, valid_ds, in_stats, out_stats = _loop_setup("train_loop")
    workdir = cfg.workdir
    nbytes = sum(a.nbytes for ds in (train_ds, valid_ds) for a in ds.labs + ds.cmps)
    print(f"[train loop] ({card}) corpus {len(train_ds)} + {len(valid_ds)} utterances, "
          f"{train_ds.num_frames} + {valid_ds.num_frames} frames, {nbytes / 2**30:.3f} GiB on the "
          f"host, made in {time.perf_counter() - t0:.1f} s")

    # the prediction, from the utterance lengths alone
    group, B = cfg.train.n_critic + 1, TRAIN_B
    per_bucket = _bucket_batches(train_ds, B, LOOP_BOUNDS, whole=True)
    n_valid = sum(_bucket_batches(valid_ds, B, LOOP_BOUNDS, whole=False).values())
    carry, want_steps = dict.fromkeys(LOOP_BOUNDS, 0), []
    for epoch in range(LOOP_EPOCHS + 1):
        if epoch == LOOP_EPOCHS:  # the resumed Trainer starts with no partial group
            carry = dict.fromkeys(LOOP_BOUNDS, 0)
        total = {b: carry[b] + per_bucket[b] for b in LOOP_BOUNDS}
        want_steps.append(sum(n // group for n in total.values()))
        carry = {b: n % group for b, n in total.items()}

    saved, save_ms = {}, []

    def recording(trainer):
        """Keep a host copy of each state the trainer saves, and time the save."""
        save = trainer.ckpt.save

        def wrapped(step, state, metrics=None):
            t = time.perf_counter()
            ok = save(step, state, metrics)
            save_ms.append((time.perf_counter() - t) * 1e3)
            saved[step] = _host_copy(state.state_dict())
            return ok

        trainer.ckpt.save = wrapped
        return trainer

    _zero_counts()
    first = recording(Trainer(cfg, train_ds, valid_ds, in_stats=in_stats, out_stats=out_stats))
    hist = first.train(epochs=LOOP_EPOCHS)
    first.close()
    best_before = (first.best_epoch, first.best_valid)
    second = recording(Trainer(cfg, train_ds, valid_ds, in_stats=in_stats, out_stats=out_stats))
    t = time.perf_counter()
    if not second.resume():
        raise AssertionError("the resumed Trainer found no checkpoint")
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t) * 1e3
    resumed_at = second.ckpt.latest_step()
    diff = _tree_diff(saved[resumed_at], second.state.state_dict())
    if diff or (second.best_epoch, second.best_valid) != best_before:
        raise AssertionError(f"resume() restored another state: {diff[:8]}; best "
                             f"{(second.best_epoch, second.best_valid)} vs {best_before}")
    hist2 = second.train(epochs=LOOP_EPOCHS + 1)
    second.close()
    torch.cuda.synchronize()
    counts, routes = _counts(), _routes()

    records = hist["train"] + hist2["train"]
    valids = hist["valid"] + hist2["valid"]
    steps = [r["steps"] for r in records]
    for epoch, (r, va) in enumerate(zip(records, valids)):
        print(f"[train loop] ({card}) epoch {epoch}: {r['steps']} steps, loss {r['loss']:.6g}, "
              f"w_dist {r['w_dist']:.6g}, gp {r['gp']:.6g}, valid {va:.6g}; wall {r['sec']:.3f} s, "
              f"{r['frames_per_sec']:.1f} frames/s, step dispatch mean {r['step_mean_s'] * 1e3:.3f} "
              f"ms, max {r['step_max_s'] * 1e3:.3f} ms")
        if not all(math.isfinite(v) for v in (*r.values(), va)):
            raise AssertionError(f"non-finite record at epoch {epoch}: {r}, valid {va}")
    if steps != want_steps:
        raise AssertionError(f"epochs took {steps} steps; whole groups predict {want_steps}")
    fwd, bwd = counts["bilstm_fwd"], counts["bilstm_bwd"]
    want = (2 * sum(steps) + n_valid * len(records), sum(steps))
    print(f"[train loop] launches {counts}: {sum(steps)} steps, {n_valid} validation batches an "
          f"epoch; expected forward {want[0]}, BPTT {want[1]}")
    if (fwd, bwd) != want or sum(counts.values()) != fwd + bwd:
        raise AssertionError(f"the loop launched {counts}, not (forward, BPTT) = {want}")
    _all_mma("train loop", routes)

    # every epoch saves (checkpoint_every=1) with its validation score
    kept = _retained(valids, LOOP_KEEP)
    ckpt_dir = os.path.join(workdir, "checkpoints")
    on_disk = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    print(f"[train loop] scores {[round(v, 6) for v in valids]}; checkpoints {on_disk}, "
          f"LatestN ∪ BestN with N={LOOP_KEEP} predicts {kept}")
    if on_disk != kept:
        raise AssertionError(f"checkpoints {on_disk} retained, {kept} predicted")
    sizes = [os.path.getsize(os.path.join(ckpt_dir, str(s), STATE_FILE)) for s in on_disk]

    traces = sorted(os.listdir(os.path.join(workdir, "traces")))
    if len(traces) != 2 or not all(t.endswith(".json") for t in traces):
        raise AssertionError(f"expected one Chrome trace per run, found {traces}")
    busy = []
    for name in traces:
        got = _trace_busy(os.path.join(workdir, "traces", name))
        busy.append(None if got is None else (got[0], got[1], got[0] / got[1]))
        print(f"[train loop] ({card}) profiled epoch ({cfg.train.profile_steps} steps) {name}: "
              + ("no device events: busy share not measured" if got is None else
                 f"device busy {got[0]:.3f} of {got[1]:.3f} ms, busy share {got[0] / got[1]:.3f}; "
                 f"first device event at {got[2]:.3f} ms (the first group's assembly), busy "
                 f"share after it {got[0] / (got[1] - got[2]):.3f}"))

    # serving the best checkpoint's EMA, as cli synth does
    ckpt = CheckpointManager(ckpt_dir)
    best_step = ckpt.best_step()
    state = make_gan_state(cfg, LABEL_DIM)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ckpt.restore(state, best=True)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t) * 1e3
    served = eval_generator(state)
    plain = build_generator(cfg.model, cfg.vocoder, LABEL_DIM).to(dev).eval()
    with torch.no_grad():
        for name, p in plain.named_parameters():
            p.copy_(saved[best_step]["ema"][name])
    labs, s_in, s_out = _requests(cfg.vocoder.feature_size)
    got, ref = serve(served, labs, s_in, s_out), serve(plain, labs, s_in, s_out)
    unequal = [n for n, a, b in zip(REQUEST_LENGTHS, got, ref) if not np.array_equal(a, b)]
    ema_moved = max((saved[best_step]["ema"][n] - saved[best_step]["gen"][n].cpu()).abs().max().item()
                    for n, _ in plain.named_parameters())
    print(f"[train loop] served {len(labs)} requests from checkpoint {best_step}'s EMA "
          f"(max |EMA - live| {ema_moved:.3g}); requests unequal to the in-memory EMA's: {unequal}")
    if unequal or ema_moved == 0.0:
        raise AssertionError("serving the best checkpoint is not serving its EMA weights")
    print(f"[train loop] ({card}) checkpoint save {', '.join(f'{m:.1f}' for m in save_ms)} ms, "
          f"resume {resume_ms:.1f} ms, restore of the best {restore_ms:.1f} ms, "
          f"{sizes[0] / 2**20:.2f} MiB a checkpoint")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"counts": counts, "routes": routes, "records": records, "valid": valids,
            "busy": busy, "save_ms": save_ms, "resume_ms": resume_ms, "restore_ms": restore_ms,
            "bytes": sizes[0]}


def _trace_copies(path: str):
    """Host→device copies of a Chrome trace of ``torch.profiler``:
    {bytes: count}, from the memcpy events' ``bytes`` argument; None when
    the trace records no such copy."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    sizes = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            n = (e.get("args") or {}).get("bytes")
            sizes[n] = sizes.get(n, 0) + 1
    return sizes or None


def _profiled_epoch(label: str, workdir: str, card: str):
    """Busy share and host→device copies of the one Chrome trace a
    ``Trainer`` run wrote; fails when the traced steps copied anything the
    size of a batch to the card (the corpus is resident)."""
    import os

    traces = sorted(os.listdir(os.path.join(workdir, "traces")))
    if len(traces) != 1:
        raise AssertionError(f"{label}: expected one Chrome trace, found {traces}")
    path = os.path.join(workdir, "traces", traces[0])
    busy, copies = _trace_busy(path), _trace_copies(path)
    print(f"[{label}] ({card}) profiled device-corpus epoch: "
          + ("no device events: busy share not measured" if busy is None else
             f"device busy {busy[0]:.3f} of {busy[1]:.3f} ms, busy share {busy[0] / busy[1]:.4f}; "
             f"first device event at {busy[2]:.3f} ms")
          + "; host→device copies by size (bytes: count) "
          + ("not recorded" if copies is None else
             str(dict(sorted(copies.items(), key=lambda kv: -(kv[0] or 0))))))
    if copies and max(n or 0 for n in copies) > QS_MAX_STEP_COPY:
        raise AssertionError(f"{label}: a traced step copied {max(copies)} bytes to the card")
    return None if busy is None else busy[0] / busy[1], copies


class _CountingCorpus:
    """Within the block, every ``DeviceCorpus`` the trainer builds is kept."""

    def __enter__(self):
        from percivaltts_tpu_torch.training import loop

        self.made, self.saved = [], loop.DeviceCorpus
        made, base = self.made, loop.DeviceCorpus

        class Counting(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        loop.DeviceCorpus = Counting
        return self

    def __exit__(self, *exc):
        from percivaltts_tpu_torch.training import loop

        loop.DeviceCorpus = self.saved


class _TimedMeasures:
    """Within the block, each objective-measure validation of a ``Trainer``
    is timed (host clock, ending in a sync)."""

    def __enter__(self):
        from percivaltts_tpu_torch.training.loop import Trainer

        self.secs, self.saved = [], Trainer._validate_measures
        secs, saved = self.secs, self.saved

        def timed(trainer, epoch):
            t = time.perf_counter()
            out = saved(trainer, epoch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            return out

        Trainer._validate_measures = timed
        return self

    def __exit__(self, *exc):
        from percivaltts_tpu_torch.training.loop import Trainer

        Trainer._validate_measures = self.saved


def _finite(record: dict) -> bool:
    """Every number of a metrics record is finite."""
    return all(math.isfinite(v) for v in record.values() if isinstance(v, (int, float)))


def _records(workdir: str, kind: str) -> list:
    import os

    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _write_config(path: str, d: dict) -> str:
    with open(path, "w") as f:
        json.dump(d, f, indent=2, sort_keys=True)
    return path


def _quickstart_path(dev, card: str) -> dict:
    """Phase 8a: config 1 through the port's CLI (demo → compose → train
    --preset production → generate → measures). Returns the launch counts
    of each command, the composed corpus and the times."""
    import contextlib
    import io
    import os
    import shutil

    from percivaltts_tpu_torch import cli
    from percivaltts_tpu_torch.config import Configuration
    from percivaltts_tpu_torch.data.compose import compose, load_wav
    from percivaltts_tpu_torch.eval.generate import generate
    from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
    from percivaltts_tpu_torch.training.state import make_gan_state
    from percivaltts_tpu_torch.utils.fileio import load_binary_file, save_binary_file

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "quickstart")
    shutil.rmtree(root, ignore_errors=True)
    corpus_dir, workdir = os.path.join(root, "corpus"), os.path.join(root, "exp")
    main = lambda *argv: cli.main(list(argv), device=dev)  # noqa: E731
    out, counts = {}, {}

    t = time.perf_counter()
    if main("demo", "--out", corpus_dir, "--num", str(QS_UTTS), "--seed", str(QS_SEED)) != 0:
        raise AssertionError("cli demo failed")
    out["demo_s"] = time.perf_counter() - t
    with open(os.path.join(corpus_dir, "config.json")) as f:
        d = json.load(f)
    defaults = Configuration().to_dict()
    d["workdir"] = workdir
    d["data"].update(batch_size=TRAIN_B, bucket_bounds=QS_BOUNDS, num_valid=QS_SPLIT,
                     num_test=QS_SPLIT)
    d["vocoder"] = defaults["vocoder"]  # the default VocoderConfig: 1 + 65 + 33 features
    d["model"].update(generator="fc", hidden_size=256, num_layers=3, compute_dtype="bfloat16")
    d["train"].update(trainer="lse", epochs=QS_EPOCHS, measures_every=1, best_metric="mcd",
                      checkpoint_every=1, keep_checkpoints=QS_KEEP, profile_steps=1000)
    cfg_path = _write_config(os.path.join(root, "config1.json"), d)
    cfg = Configuration.load(cfg_path)
    ids = open(cfg.data.fileids).read().split()
    audio_s = sum(len(load_wav(os.path.join(corpus_dir, "wav", u + ".wav"))[1]) for u in ids) \
        / cfg.vocoder.fs

    # compose, then the same wavs through the DSP twins
    _zero_counts()
    t = time.perf_counter()
    if main("compose", "--config", cfg_path) != 0:
        raise AssertionError("cli compose failed")
    torch.cuda.synchronize()
    out["compose_s"] = time.perf_counter() - t
    counts["quickstart_compose"] = _counts()
    cache = os.path.join(workdir, "feature_cache")
    corpus = compose(cfg, cache_dir=cache, device=dev)
    F, L = corpus.train.feat_dim, corpus.train.label_dim
    print(f"[quickstart] ({card}) demo of {QS_UTTS} utterances ({audio_s:.2f} s of audio) in "
          f"{out['demo_s']:.2f} s; compose in {out['compose_s']:.2f} s, "
          f"{audio_s / out['compose_s']:.1f} s of audio per s; label dim {L}, {F} features; "
          f"launches {counts['quickstart_compose']}")
    if counts["quickstart_compose"]["frame_window"] == 0 or F != 99:
        raise AssertionError("compose did not frame through the kernel, or not 99 features")
    with _DspTwins():
        plain = compose(cfg, normalize=False, device=dev)
    unequal = [u for split in (plain.train, plain.valid, plain.test)
               for u, c in zip(split.ids, split.cmps)
               if not np.array_equal(load_binary_file(os.path.join(cache, u + ".cmp.f32"), F), c)]
    print(f"[quickstart] compose through the kernels vs the twins: {len(ids)} utterances, "
          f"unequal {unequal}")
    if unequal:
        raise AssertionError("compose through the kernels disagrees with the twins'")

    # train: LSE, config 1, the production preset (the corpus on the card)
    _zero_counts()
    with _CountingCorpus() as made, _TimedMeasures() as measured:
        t = time.perf_counter()
        if main("train", "--config", cfg_path, "--preset", "production") != 0:
            raise AssertionError("cli train failed")
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t
    counts["quickstart_train"] = _counts()
    records, objective = _records(workdir, "epoch"), _records(workdir, "objective")
    n_train = len(corpus.train)
    want_bytes = n_train * max(QS_BOUNDS) * ((L + F) * 4 + 4)
    if len(made.made) != 1 or made.made[0].nbytes != want_bytes:
        raise AssertionError(f"the corpus went to the card {len(made.made)} times, not once "
                             f"with {want_bytes} bytes")
    want = [len(list(made.made[0].epoch_indices(TRAIN_B, 1, e, seed=cfg.data.shuffle_seed)))
            for e in range(QS_EPOCHS)]
    real = sum(min(x.shape[0], max(QS_BOUNDS)) for x in corpus.train.labs)
    for r, o in zip(records, objective):
        print(f"[quickstart] ({card}) epoch {r['epoch']}: {r['steps']} steps, loss {r['loss']:.6g}, "
              f"valid {r['valid']:.6g}; wall {r['sec']:.3f} s, {real / r['sec']:.1f} real frames/s "
              f"({r['frames_per_sec']:.1f} padded); objective mcd {o['mcd_db']:.4f} dB, gv "
              f"{o['gv_ratio']:.4f}, ms_hi {o['ms_ratio_hi']:.4f}, vuv {o.get('vuv_error_pct')}")
    print(f"[quickstart] measure validations {', '.join(f'{x:.3f}' for x in measured.secs)} s; "
          f"device corpora built {len(made.made)}, "
          + ", ".join(f"{c.nbytes / 2**20:.2f} MiB ({c.num_utts} x {c.bound} frames)"
                      for c in made.made) + f"; launches {counts['quickstart_train']}")
    if [r["steps"] for r in records] != want:
        raise AssertionError(f"epochs took {[r['steps'] for r in records]} steps, "
                             f"epoch_indices yields {want}")
    if not all(_finite(r) for r in records):
        raise AssertionError(f"non-finite epoch records: {records}")
    if [o["epoch"] for o in objective] != list(range(QS_EPOCHS)):
        raise AssertionError(f"objective records for epochs {[o['epoch'] for o in objective]}")
    out["busy"], out["copies"] = _profiled_epoch("quickstart", workdir, card)
    kept = _retained([o["mcd_db"] for o in objective], QS_KEEP)
    ckpt_dir = os.path.join(workdir, "checkpoints")
    on_disk = sorted(int(x) for x in os.listdir(ckpt_dir) if x.isdigit())
    print(f"[quickstart] checkpoints {on_disk}; LatestN ∪ BestN on MCD with N={QS_KEEP} "
          f"predicts {kept}")
    if on_disk != kept:
        raise AssertionError(f"checkpoints {on_disk} retained, {kept} predicted")

    # generate the test split, then the same generation through the twins
    _zero_counts()
    t = time.perf_counter()
    if main("generate", "--config", cfg_path, "--split", "test", "--save-features") != 0:
        raise AssertionError("cli generate failed")
    torch.cuda.synchronize()
    out["generate_s"] = time.perf_counter() - t
    counts["quickstart_generate"] = _counts()
    with open(os.path.join(workdir, "measures.json")) as f:
        measures = json.load(f)
    gen_dir = os.path.join(workdir, "generated")
    wavs = {u: load_wav(os.path.join(gen_dir, u + ".wav"))[1] for u in corpus.test.ids}
    gen_audio = sum(len(w) for w in wavs.values()) / cfg.vocoder.fs
    print(f"[quickstart] ({card}) generate of {len(wavs)} utterances ({gen_audio:.2f} s of audio) "
          f"in {out['generate_s']:.3f} s, real-time factor {out['generate_s'] / gen_audio:.4f}; "
          f"measures {measures}; launches {counts['quickstart_generate']}")
    if not all(math.isfinite(measures.get(k, float("nan")))
               for k in ("mcd_db", "gv_ratio", "ms_ratio_hi", "vuv_error_pct")):
        raise AssertionError(f"non-finite measures: {measures}")
    if len([x for x in os.listdir(gen_dir) if x.endswith(".wav")]) != QS_SPLIT:
        raise AssertionError(f"generate wrote no {QS_SPLIT} wavs")
    if not (counts["quickstart_generate"]["frame_window"] and
            counts["quickstart_generate"]["overlap_add"]):
        raise AssertionError("generate did not launch both DSP kernels")
    ckpt = CheckpointManager(ckpt_dir)
    state = ckpt.restore(make_gan_state(cfg, L, device=dev), ckpt.best_step())
    twin_dir = os.path.join(root, "generated_twins")
    with _DspTwins():
        generate(cfg, state, corpus.test, corpus.out_stats, outdir=twin_dir)
    unequal = [u for u in wavs
               if not np.array_equal(load_wav(os.path.join(twin_dir, u + ".wav"))[1], wavs[u])]
    print(f"[quickstart] generate through the kernels vs the twins: wavs unequal {unequal}")
    if unequal:
        raise AssertionError("generation through the kernels disagrees with the twins'")

    # cli measures on the saved features against the denormalized references
    ref_dir = os.path.join(root, "ref")
    for u, c in zip(corpus.test.ids, corpus.test.cmps):
        save_binary_file(os.path.join(ref_dir, u + ".cmp"), corpus.out_stats.denormalize(c))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        if main("measures", "--config", cfg_path, "--ref", ref_dir, "--pred", gen_dir) != 0:
            raise AssertionError("cli measures failed")
    got = json.loads(text.getvalue())
    diff = abs(got["mcd_db"] - measures["mcd_db"])
    print(f"[quickstart] cli measures: {got}; |mcd - generate's| {diff:.3g} "
          f"(tol {QS_MCD_TOL * measures['mcd_db']:.3g})")
    if got["files"] != QS_SPLIT or not diff <= QS_MCD_TOL * measures["mcd_db"]:
        raise AssertionError("cli measures disagrees with generate's MCD")
    out.update(counts=counts, records=records, objective=objective, measures=measures,
               measure_s=measured.secs, real_frames=real, audio_s=audio_s, gen_audio_s=gen_audio,
               root=root, cfg=d, corpus=corpus)
    return out


def _quickstart_wgan_path(dev, card: str, qs: dict) -> dict:
    """Phase 8b: config 3 (WGAN-GP, ``cnn_blstm``) through ``cli train
    --preset production`` on phase 8a's composed corpus (its feature cache
    copied), measures every epoch selecting on ``mcd_gv``: 1 epoch of 2
    steps. Returns the launch counts."""
    import os
    import shutil

    from percivaltts_tpu_torch import cli
    from percivaltts_tpu_torch.config import Configuration
    from percivaltts_tpu_torch.models.base import TIME_MULTIPLE

    defaults = Configuration().to_dict()
    d = json.loads(json.dumps(qs["cfg"]))
    d["workdir"] = workdir = os.path.join(qs["root"], "exp3")
    d["model"] = dict(defaults["model"], generator="cnn_blstm")
    d["train"] = dict(defaults["train"], trainer="wgan", epochs=1,
                      steps_per_epoch=QS_WGAN_STEPS, measures_every=1, checkpoint_every=1,
                      profile_steps=QS_WGAN_STEPS)
    cfg_path = _write_config(os.path.join(qs["root"], "config3.json"), d)
    shutil.copytree(os.path.join(qs["cfg"]["workdir"], "feature_cache"),
                    os.path.join(workdir, "feature_cache"))
    corpus = qs["corpus"]
    _zero_counts()
    t = time.perf_counter()
    if cli.main(["train", "--config", cfg_path, "--preset", "production"], device=dev) != 0:
        raise AssertionError("cli train (config 3) failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts, routes = _counts(), _routes()
    used = Configuration.load(os.path.join(workdir, "config.json"))
    (rec,), (obj,) = _records(workdir, "epoch"), _records(workdir, "objective")
    # forwards: 2 a step, 1 a validation batch, 1 a predicted chunk (chunks
    # of 8 within each 64-frame padded length) of the measure validation
    n_valid = sum(_bucket_batches(corpus.valid, TRAIN_B, QS_BOUNDS, whole=False).values())
    groups = {}
    for x in corpus.valid.labs:
        n = -(-x.shape[0] // TIME_MULTIPLE)
        groups[n] = groups.get(n, 0) + 1
    n_chunks = sum(-(-n // 8) for n in groups.values())
    want = (2 * rec["steps"] + n_valid + n_chunks, rec["steps"])
    got = (counts["bilstm_fwd"], counts["bilstm_bwd"])
    score = obj["mcd_db"] + used.train.best_gv_weight * abs(math.log(max(obj["gv_ratio"], 1e-6)))
    print(f"[quickstart wgan] ({card}) config 3, best_metric {used.train.best_metric}: "
          f"{rec['steps']} steps, loss {rec['loss']:.6g}, w_dist {rec['w_dist']:.6g}, gp "
          f"{rec['gp']:.6g}; epoch wall {rec['sec']:.3f} s, run {wall:.2f} s; objective mcd "
          f"{obj['mcd_db']:.4f}, gv {obj['gv_ratio']:.4f} (score {score:.4f}); launches "
          f"{counts}: expected forward {want[0]} ({rec['steps']} steps, {n_valid} validation "
          f"batches, {n_chunks} predicted chunks), BPTT {want[1]}")
    if (rec["steps"] != QS_WGAN_STEPS or not _finite(rec)
            or used.train.best_metric != "mcd_gv" or not used.train.device_corpus):
        raise AssertionError(f"config 3's epoch: {rec}, best_metric {used.train.best_metric}")
    if got != want:
        raise AssertionError(f"config 3 launched (forward, BPTT) = {got}, not {want}")
    _all_mma("quickstart wgan", routes)
    metrics = json.load(open(os.path.join(workdir, "checkpoints", "0", "metrics.json")))
    if not abs(metrics["score"] - score) <= 1e-9 * abs(score):
        raise AssertionError(f"the checkpoint's score {metrics['score']} is not mcd_gv {score}")
    busy, _ = _profiled_epoch("quickstart wgan", workdir, card)
    return {"counts": counts, "routes": routes, "record": rec, "busy": busy}


def _library_layer(kind: str, ws, dtype, dev) -> torch.nn.Module:
    """cuDNN's bidirectional ``nn.LSTM`` / ``nn.GRU`` holding the port's
    layer weights ``(wi, wh, b[, bn])`` per direction: the same gate
    order, and for the GRU ``b_hn`` inside ``r ⊙ (…)``."""
    cls = torch.nn.GRU if kind == "gru" else torch.nn.LSTM
    H = ws[0][1].shape[0]
    lib = cls(LAYER_IN, H, batch_first=True, bidirectional=True).to(device=dev, dtype=dtype)
    with torch.no_grad():
        for sfx, w in (("", ws[0]), ("_reverse", ws[1])):
            getattr(lib, f"weight_ih_l0{sfx}").copy_(w[0].T)
            getattr(lib, f"weight_hh_l0{sfx}").copy_(w[1].T)
            getattr(lib, f"bias_ih_l0{sfx}").copy_(w[2])
            hh = getattr(lib, f"bias_hh_l0{sfx}")
            hh.zero_()
            if kind == "gru":
                hh[2 * H:].copy_(w[3])
    # one weight buffer, as cuDNN wants it. flatten_parameters() is a no-op in
    # bf16 (torch.backends.cudnn.is_acceptable takes f16/f32/f64 only), which
    # left cuDNN compacting the weights at every call; so the flattening op
    # that it would call runs here directly
    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(
            lib._flat_weights, 4, LAYER_IN, torch.backends.cudnn.rnn.get_cudnn_mode(lib.mode), H,
            0, 1, True, True)
    return lib


@contextlib.contextmanager
def _compact_weights():
    """cuDNN's warning that the RNN weights are not one contiguous chunk (it
    then compacts them at every call, inside the time) raised as an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*not part of single contiguous chunk of memory.*")
        yield


def _layer_times(layer, lib, x, flat, fwd: bool, runs: int, inner: int) -> dict:
    """The port's layer and cuDNN's on the same input and weights: the
    forward (``fwd``) or one backward through each, by CUDA events around the
    host calls (``layer_ms``, ``library_ms``) and by the summed device time of
    everything the call launched, the input GEMMs included
    (``layer_device_ms``, ``library_device_ms``: ``_device_ms`` without a
    name filter)."""
    if fwd:
        port_call, lib_call = (lambda: layer(x, *flat)), (lambda: lib(x))
    else:  # one forward with a graph each, then repeated backwards
        xg = x.clone().requires_grad_(True)
        leaves = [t.clone().requires_grad_(True) for t in flat]
        y = layer(xg, *leaves)
        dy = torch.randn_like(y)
        y_lib = lib(xg)[0]
        port_call = lambda: y.backward(dy, retain_graph=True)  # noqa: E731
        lib_call = lambda: y_lib.backward(dy, retain_graph=True)  # noqa: E731
    with torch.set_grad_enabled(not fwd):
        return {"layer_ms": _median_ms(port_call, runs=runs, inner=inner),
                "library_ms": _median_ms(lib_call, runs=runs, inner=inner),
                "layer_device_ms": _device_ms(port_call, calls=inner),
                "library_device_ms": _device_ms(lib_call, calls=inner)}


def _layer_weights(kind: str, H: int, dtype, dev, seed: int):
    rng = np.random.default_rng(seed)
    G = 3 if kind == "gru" else 4
    shapes = [(LAYER_IN, G * H), (H, G * H), (G * H,)] + ([(H,)] if kind == "gru" else [])
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)  # noqa: E731
    return [[to(rng.normal(size=s) / np.sqrt(s[0] if len(s) == 2 else 1.0) * 0.5)
             for s in shapes] for _ in range(2)]


def _time_kernels(dev) -> dict:
    """Phase 6, kernels: each kernel and its twin at the path's shapes, and
    the cuDNN layer beside the port's layer (forward: ``nn.LSTM`` /
    ``nn.GRU`` against ``bilstm()`` / ``bigru()``; BPTT: their backward
    against the port layer's backward, which runs the autograd pair), both
    by CUDA events and by device time (``_layer_times``). All
    bf16. Beside each forward (the tensor-core route), the CUDA-core kernel
    that bf16 took before (``simt_ms``, the same inputs, launched through
    ``fwd_launch``) and the forward kernel's own device time from
    ``torch.profiler`` (``kernel_device_ms``: without the wrapper's W_hᵀ
    packing). The same for each BPTT (the tensor-core route; the CUDA-core
    kernel through ``bwd_launch``)."""
    from percivaltts_tpu_torch.ops import gru_cuda as g
    from percivaltts_tpu_torch.ops import lstm_cuda as l
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    dt = torch.bfloat16
    out = {}
    for name, shapes in TIMED_SHAPES.items():
        gru = name.startswith("bigru")
        kind = "gru" if gru else "lstm"
        rows = []
        for T, B, H in shapes:
            if name.endswith("fwd"):
                args = _gru_gates(T, B, H, dt, dev, seed=1) if gru else _gates(T, B, H, dt, dev, 1)
                kern = g.bigru_fwd if gru else l.bilstm_fwd
                twin = g.bigru_fwd_reference if gru else l.bilstm_fwd_reference
            else:
                args = _gru_bwd_args(T, B, H, dt, dev, seed=1) if gru else \
                    _bwd_args(T, B, H, dt, dev, seed=1)
                kern = g.bigru_bwd if gru else l.bilstm_bwd
                twin = g.bigru_bwd_reference if gru else l.bilstm_bwd_reference
            fwd = name.endswith("fwd")
            launch = (g.fwd_launch if fwd else g.bwd_launch) if gru else \
                (l.fwd_launch if fwd else l.bwd_launch)
            with torch.no_grad():
                ms = _median_ms(lambda: kern(*args), runs=7, inner=10)
                plain_ms = _once_ms(lambda: twin(*args))
                routed = {"route": (fwd_route if fwd else bwd_route)(dt, H, kind),
                          "us_per_step": ms / T * 1e3,
                          "simt_ms": _median_ms(lambda: launch("simt", *args), runs=7, inner=10),
                          "kernel_device_ms": _device_ms(lambda: kern(*args), match=f"{name}_mma")}

            # the layer: the port's against cuDNN's, same weights and input
            ws = _layer_weights(kind, H, dt, dev, seed=2)
            x = torch.from_numpy(np.random.default_rng(3).normal(size=(B, T, LAYER_IN))
                                 .astype(np.float32)).to(device=dev, dtype=dt)
            layer = g.bigru if gru else l.bilstm
            flat = [t for d in ws for t in d]
            with _compact_weights():
                lib = _library_layer(kind, ws, dt, dev)
                with torch.no_grad():
                    diff = (layer(x, *flat) - lib(x)[0]).abs().max().item()
                lt = _layer_times(layer, lib, x, flat, fwd, runs=7, inner=5)
            bound_ms, bound_by = _kernel_bound(name, T, B, H, dt)
            layer_ms, library_ms = lt["layer_ms"], lt["library_ms"]
            rows.append({"shape": [T, B, H], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, **lt, **routed})
            print(f"[time] {name} T,B,H={(T, B, H)} bf16, route {routed['route']}: "
                  f"{routed['us_per_step']:.3f} us a step ({ms:.4f} ms a call; the kernel alone "
                  f"{routed['kernel_device_ms']} device ms); the CUDA-core kernel on the same "
                  f"inputs {routed['simt_ms']:.4f} ms ({routed['simt_ms'] / T * 1e3:.3f} us a step), "
                  f"{routed['simt_ms'] / ms:.2f}x")
            print(f"[time] {name} T,B,H={(T, B, H)} bf16: kernel {ms:.4f} ms "
                  f"({ms / T * 1e3:.3f} us a step), plain twin {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.5f} ms ({bound_by}); layer{' backward' if 'bwd' in name else ''}: "
                  f"port {layer_ms:.4f} ms, cuDNN {library_ms:.4f} ms (medians, CUDA events); "
                  f"device time port {lt['layer_device_ms']} ms, cuDNN {lt['library_device_ms']} "
                  f"ms, cuDNN/port {_ratio(lt['library_device_ms'], lt['layer_device_ms'])} "
                  f"(max|port-cuDNN| forward {diff:.3g})")
        out[name] = rows
    return out


def _check_dsp_kernels(dev) -> dict:
    """Phase 3, the DSP kernels: framing × window and overlap-add against
    their twins at the vocode path's shapes and the test shapes, f32 and
    bf16. Returns each kernel's largest f32 |kernel − twin|."""
    from percivaltts_tpu_torch.ops import frames_cuda as fc
    from percivaltts_tpu_torch.ops.stft import hann_window

    err = {"frame_window": 0.0, "overlap_add": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for B, n, fl, hop, windowed in FRAME_SHAPES:
            g = torch.Generator(device=dev).manual_seed(n + fl)
            x = torch.randn(B, n, generator=g, device=dev).to(dtype)
            w = hann_window(fl, device=dev).to(dtype) if windowed else None
            got = _launch_once(fc.frame_window, x, fl, hop, w)
            e = _compare(f"[frame_window] B={B} n={n} fl={fl} hop={hop} window={windowed} {dt}",
                         [got], [fc.frame_window_reference(x, fl, hop, w)], 0.0, relative=False)
            err["frame_window"] = max(err["frame_window"], e if dtype == torch.float32 else 0.0)
        for B, nf, fl, hop in OLA_SHAPES:
            g = torch.Generator(device=dev).manual_seed(nf + fl)
            frames = torch.randn(B, nf, fl, generator=g, device=dev).to(dtype)
            got = _launch_once(fc.overlap_add, frames, hop, nf * hop)
            e = _compare(f"[overlap_add] B={B} nf={nf} fl={fl} hop={hop} {dt}", [got],
                         [fc.overlap_add_reference(frames, hop, nf * hop)], 0.0, relative=False)
            err["overlap_add"] = max(err["overlap_add"], e if dtype == torch.float32 else 0.0)
        # strided frames, read in place: the iSTFT's window² normaliser (a
        # stride-0 broadcast row) and frames cut from a wider buffer
        w = hann_window(160, device=dev).to(dtype)
        w400 = hann_window(400, device=dev).to(dtype)
        g = torch.Generator(device=dev).manual_seed(11)
        views = {"stride-0 normaliser row": (w * w).expand(1, 1536, 160),
                 "stride-0 normaliser row, fl 400": (w400 * w400).expand(1, 1536, 400),
                 "frames cut from (3, 60, 330)":
                     torch.randn(3, 60, 330, generator=g, device=dev).to(dtype)[:, 3:50, 4:164]}
        for label, view in views.items():
            n_out = view.shape[1] * 80
            got = _launch_once(fc.overlap_add, view, 80, n_out)
            _compare(f"[overlap_add] {label}, strides {view.stride()} {dt}", [got],
                     [fc.overlap_add_reference(view.contiguous(), 80, n_out)], 0.0, relative=False)
        names = _device_kernels(lambda: fc.overlap_add(views["stride-0 normaliser row"], 80, 1536 * 80))
        print(f"[overlap_add] stride-0 normaliser row {dt}: device kernels {names}")
        if names is not None and (len(names) != 1 or "overlap_add" not in names[0]):
            raise AssertionError(f"the normaliser's overlap-add ran other kernels: {names}")
    return err


def _device_kernels(fn):
    """The names of the device kernels one call of ``fn`` ran
    (``torch.profiler``); None when the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


class _DspTwins:
    """Within the block, every framing and overlap-add of the port runs the
    kernels' plain twins (on whatever device the tensors lie)."""

    def __enter__(self):
        from percivaltts_tpu_torch.ops import frames_cuda as fc

        self.saved = (fc.frame_window, fc.overlap_add)
        fc.frame_window, fc.overlap_add = fc.frame_window_reference, fc.overlap_add_reference

    def __exit__(self, *exc):
        from percivaltts_tpu_torch.ops import frames_cuda as fc

        fc.frame_window, fc.overlap_add = self.saved


def _vocode_run(label: str, voc, feats, want_counts: dict) -> dict:
    """``voc.synthesize_batch(feats)`` on the card: the launches (counted
    from 0) equal to ``want_counts``, finite waveforms of nf·hop samples,
    agreement with the same vocode through the DSP kernels' twins within
    ``VOCODE_TOL`` of the twins' largest sample, the median wall of
    ``N_TIMED_VOCODES`` vocodes and one profiled vocode."""
    hop, fs = voc.cfg.shift_samples, voc.cfg.fs
    _zero_counts()
    wavs = voc.synthesize_batch(feats)
    counts = _counts()
    how = "Griffin-Lim" if voc.kind == "melspec" else f"closed_loop={voc.cfg.closed_loop}"
    print(f"[{label}] {len(feats)} utterances ({sum(f.shape[0] for f in feats)} frames), "
          f"{voc.kind}, {how}; launches {counts}")
    want = {name: want_counts.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"the {label} launched {counts}, not {want}")
    for f, w in zip(feats, wavs):
        if w.shape != (f.shape[0] * hop,) or w.dtype != np.float32 or not np.isfinite(w).all():
            raise AssertionError(f"bad waveform for {f.shape[0]} frames: {w.shape} {w.dtype}")
    with _DspTwins():
        plain = voc.synthesize_batch(feats)
    err = max(np.abs(a - b).max() for a, b in zip(wavs, plain))
    scale = max(np.abs(b).max() for b in plain)
    print(f"[{label}] max|kernels-twins| over all samples = {err:.3g} (tol {VOCODE_TOL * scale:.3g}; "
          f"max|twins| {scale:.3g}); rms of the waveforms "
          + ", ".join(f"{np.sqrt(np.mean(w ** 2)):.3g}" for w in wavs))
    if not err <= VOCODE_TOL * scale:
        raise AssertionError(f"the {label} through the kernels disagrees with the twins'")

    audio_s = sum(len(w) for w in wavs) / fs
    lat = []
    for _ in range(N_TIMED_VOCODES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        voc.synthesize_batch(feats)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    med = statistics.median(lat)
    print(f"[time] {label} of {audio_s:.2f} s of audio: median {med * 1e3:.3f} ms (min "
          f"{min(lat) * 1e3:.3f}, max {max(lat) * 1e3:.3f}, {N_TIMED_VOCODES} runs), real-time "
          f"factor {med / audio_s:.4f}, {audio_s / med:.1f} s of audio per s")
    print(f"[time] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    busy_share, dsp_ms = _profiled(label, lambda: voc.synthesize_batch(feats),
                                   ("frame_window", "overlap_add"))
    return {"counts": counts, "vocode_ms": med * 1e3, "audio_s": audio_s,
            "busy_share": busy_share, "dsp_device_ms": dsp_ms, "err": float(err)}


def _vocode_path(dev, feats) -> dict:
    """Phase 4b and the vocode timing of phase 6: config 3's served features
    through the default PML vocoder on the card."""
    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.vocoders import get_vocoder

    return _vocode_run("vocode", get_vocoder(VocoderConfig(), device=dev), feats, VOCODE_LAUNCHES)


def _demo_wavs(qs: dict) -> list:
    """Phase 8's demo waveforms, in file-id order."""
    import os

    from percivaltts_tpu_torch.data.compose import load_wav

    corpus_dir = qs["cfg"]["data"]["corpus_dir"]
    ids = open(qs["cfg"]["data"]["fileids"]).read().split()
    return [load_wav(os.path.join(corpus_dir, "wav", u + ".wav"))[1] for u in ids]


def _analysis_run(label: str, voc, wavs) -> dict:
    """``voc.analyze_batch`` over ``wavs`` in compose's chunks of 8 on the
    card (the framing kernel launched), equal, bit for bit, to the same
    analysis through the twins."""
    from percivaltts_tpu_torch.data.compose import ANALYSIS_CHUNK

    def run():
        return [f for k in range(0, len(wavs), ANALYSIS_CHUNK)
                for f in voc.analyze_batch(wavs[k:k + ANALYSIS_CHUNK])]

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    with _DspTwins():
        plain = run()
    unequal = [i for i, (a, b) in enumerate(zip(feats, plain)) if not np.array_equal(a, b)]
    audio_s = sum(len(w) for w in wavs) / voc.cfg.fs
    print(f"[{label}] analyze_batch of {len(wavs)} demo wavs ({audio_s:.2f} s of audio) in "
          f"{wall:.3f} s, {audio_s / wall:.1f} s of audio per s; {feats[0].shape[1]} features; "
          f"launches {counts}; kernels vs twins unequal {unequal}")
    if counts["frame_window"] == 0 or unequal or not all(np.isfinite(f).all() for f in feats):
        raise AssertionError(f"{label}: the analysis did not frame through the kernel, or "
                             "disagrees with the twins', or is not finite")
    return {"counts": counts, "feats": feats, "wall_s": wall, "audio_s": audio_s}


def _mel_path(dev, qs: dict) -> dict:
    """Phase 9a: config 4 at full width (``bench.py:94-96``): phase 4's 8
    requests served by the ``cnn`` generator with 80 mel outputs, vocoded
    by Griffin-Lim (64 iterations, 2 chunks of 4) against the twins; then
    phase 8's demo wavs analyzed against the twins."""
    from percivaltts_tpu_torch import ModelConfig, VocoderConfig
    from percivaltts_tpu_torch.eval.serve import serve
    from percivaltts_tpu_torch.models import build_generator, count_params
    from percivaltts_tpu_torch.vocoders import get_vocoder

    vcfg = VocoderConfig(kind="melspec", mel_size=80)
    gen = build_generator(ModelConfig(generator="cnn"), vcfg, LABEL_DIM,
                          generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    labs, in_stats, out_stats = _requests(vcfg.feature_size)
    feats = serve(gen, labs, in_stats, out_stats)
    print(f"[serve cnn, melspec] config 4's generator, {count_params(gen):,} parameters; "
          f"{len(feats)} requests served")
    for n, f in zip(REQUEST_LENGTHS, feats):
        if f.shape != (n, 80) or not np.isfinite(f).all():
            raise AssertionError(f"bad mel features for a {n}-frame request: {f.shape}")
    voc = get_vocoder(vcfg, device=dev)
    out = _vocode_run("vocode melspec", voc, feats, MEL_LAUNCHES)
    out["analysis"] = _analysis_run("analyze melspec", voc, _demo_wavs(qs))
    return out


def _world_path(dev, qs: dict) -> dict:
    """Phase 9b: WORLD at ``VocoderConfig(kind="world")`` (65 + 33 bands,
    closed loop, 2 passes, the d4c_gd bap): phase 8's demo wavs analyzed
    against the twins, and the first ``WORLD_COPY_UTTS`` of them
    copy-synthesized (2 chunks of 4) against the twins."""
    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.vocoders import get_vocoder

    voc = get_vocoder(VocoderConfig(kind="world"), device=dev)
    ana = _analysis_run("analyze world", voc, _demo_wavs(qs))
    out = _vocode_run("vocode world", voc, ana["feats"][:WORLD_COPY_UTTS], WORLD_LAUNCHES)
    out["analysis"] = ana
    return out


def _cli_vocoder_path(dev, card: str, qs: dict, kind: str) -> dict:
    """Phase 9c (and 10e) for one vocoder on phase 8's demo corpus through
    the CLI: ``compose`` (the features equal a compose through the twins),
    ``train --preset production``, ``generate --split test
    --save-features`` (the wavs equal a generation through the twins) and
    ``measures`` (generate's MCD within ``QS_MCD_TOL``). ``"melspec"``:
    config 4 (the ``cnn`` generator, WGAN-GP, 1 epoch of
    ``CLI9_WGAN_STEPS`` steps, best on ``mcd_gv`` without F0). ``"world"``:
    config 1's FC generator, LSE, ``CLI9_WORLD_EPOCHS`` epochs (the preset
    switches ``vuv_rule`` to ``bap``). ``"te"``: phase 10a's
    reference-faithful model (WGAN-GP as config 4, its BiLSTM launches on
    the tensor-core route) over PML's ``envelope="te"`` features. Returns
    the launch counts of each command and the walls."""
    import contextlib
    import io
    import os

    from percivaltts_tpu_torch import cli
    from percivaltts_tpu_torch.config import Configuration
    from percivaltts_tpu_torch.data.compose import compose, load_wav
    from percivaltts_tpu_torch.eval.generate import generate
    from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
    from percivaltts_tpu_torch.training.state import make_gan_state
    from percivaltts_tpu_torch.utils.fileio import load_binary_file, save_binary_file

    defaults = Configuration().to_dict()
    d = json.loads(json.dumps(qs["cfg"]))
    d["workdir"] = workdir = os.path.join(qs["root"], f"exp_{kind}")
    wgan = dict(defaults["train"], trainer="wgan", epochs=1, steps_per_epoch=CLI9_WGAN_STEPS,
                measures_every=1, checkpoint_every=1)
    if kind == "melspec":
        d["vocoder"] = dict(defaults["vocoder"], kind="melspec", mel_size=80)
        d["model"] = dict(defaults["model"], generator="cnn")
        d["train"] = wgan
        epochs = 1
    elif kind == "world":
        d["vocoder"] = dict(defaults["vocoder"], kind="world")
        d["train"].update(epochs=CLI9_WORLD_EPOCHS, profile_steps=0)
        epochs = CLI9_WORLD_EPOCHS
    else:  # "te": phase 10e, the reference-faithful model over PML's "te" features
        d["vocoder"] = dict(defaults["vocoder"], envelope="te")
        d["model"] = dict(defaults["model"], **MODELS["cnn_blstm_2d"])
        d["train"] = wgan
        epochs = 1
    cfg_path = _write_config(os.path.join(qs["root"], f"config_{kind}.json"), d)
    cfg = Configuration.load(cfg_path)
    main = lambda *argv: cli.main(list(argv), device=dev)  # noqa: E731
    out, counts = {}, {}

    def timed(name, *argv):
        _zero_counts()
        t = time.perf_counter()
        if main(*argv) != 0:
            raise AssertionError(f"cli {argv[0]} ({kind}) failed")
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t
        counts[name] = _counts()
        out[f"{name}_routes"] = _routes()

    timed("compose", "compose", "--config", cfg_path)
    cache = os.path.join(workdir, "feature_cache")
    corpus = compose(cfg, cache_dir=cache, device=dev)
    F = corpus.train.feat_dim
    with _DspTwins():
        plain = compose(cfg, normalize=False, device=dev)
    unequal = [u for split in (plain.train, plain.valid, plain.test)
               for u, c in zip(split.ids, split.cmps)
               if not np.array_equal(load_binary_file(os.path.join(cache, u + ".cmp.f32"), F), c)]
    print(f"[cli {kind}] ({card}) compose in {out['compose_s']:.2f} s, "
          f"{qs['audio_s'] / out['compose_s']:.1f} s of audio per s, {F} features; launches "
          f"{counts['compose']}; through the kernels vs the twins unequal {unequal}")
    if counts["compose"]["frame_window"] == 0 or F != cfg.vocoder.feature_size or unequal:
        raise AssertionError(f"{kind} compose: no framing launch, {F} features, or unequal "
                             "to the twins'")

    timed("train", "train", "--config", cfg_path, "--preset", "production")
    used = Configuration.load(os.path.join(workdir, "config.json"))
    records, objective = _records(workdir, "epoch"), _records(workdir, "objective")
    for r, o in zip(records, objective):
        print(f"[cli {kind}] ({card}) epoch {r['epoch']}: {r['steps']} steps, loss "
              f"{r['loss']:.6g}, valid {r['valid']:.6g}, wall {r['sec']:.3f} s; objective mcd "
              f"{o['mcd_db']:.4f} dB, gv {o['gv_ratio']:.4f}, f0 rmse {o.get('f0_rmse_hz')}, "
              f"vuv {o.get('vuv_error_pct')}")
    print(f"[cli {kind}] train {out['train_s']:.2f} s, best_metric {used.train.best_metric}, "
          f"vuv_rule {used.vocoder.vuv_rule}; launches {counts['train']}")
    if (len(records) != epochs or len(objective) != epochs
            or not all(_finite(r) for r in records + objective)):
        raise AssertionError(f"{kind} training records: {records} {objective}")
    if kind == "melspec" and (used.train.best_metric != "mcd_gv" or "f0_rmse_hz" in objective[0]):
        raise AssertionError(f"config 4 selected on {used.train.best_metric}, {objective[0]}")
    if kind == "world" and used.vocoder.vuv_rule != "bap":
        raise AssertionError("the production preset left WORLD's vuv_rule at "
                             f"{used.vocoder.vuv_rule!r}")
    if kind == "te":
        if (used.train.best_metric != "mcd_gv" or used.model.conv_style != "2d"
                or used.vocoder.envelope != "te"):
            raise AssertionError(f"the te run trained {used.model} on {used.vocoder}, best on "
                                 f"{used.train.best_metric}")
        if not (counts["train"]["bilstm_fwd"] and counts["train"]["bilstm_bwd"]):
            raise AssertionError(f"the 2d model's training launched {counts['train']}")
        _all_mma(f"cli {kind} train", out["train_routes"])

    timed("generate", "generate", "--config", cfg_path, "--split", "test", "--save-features")
    with open(os.path.join(workdir, "measures.json")) as f:
        measures = json.load(f)
    gen_dir = os.path.join(workdir, "generated")
    wavs = {u: load_wav(os.path.join(gen_dir, u + ".wav"))[1] for u in corpus.test.ids}
    gen_audio = sum(len(w) for w in wavs.values()) / cfg.vocoder.fs
    print(f"[cli {kind}] ({card}) generate of {len(wavs)} utterances ({gen_audio:.2f} s of "
          f"audio) in {out['generate_s']:.3f} s, real-time factor "
          f"{out['generate_s'] / gen_audio:.4f}; measures {measures}; launches "
          f"{counts['generate']}")
    keys = ("mcd_db", "gv_ratio", "ms_ratio_hi") + (("vuv_error_pct",) if kind != "melspec" else ())
    if not all(math.isfinite(measures.get(k, float("nan"))) for k in keys):
        raise AssertionError(f"non-finite measures: {measures}")
    if not (counts["generate"]["frame_window"] and counts["generate"]["overlap_add"]):
        raise AssertionError(f"{kind} generate did not launch both DSP kernels")
    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    state = ckpt.restore(make_gan_state(cfg, corpus.train.label_dim, device=dev), ckpt.best_step())
    twin_dir = os.path.join(qs["root"], f"generated_twins_{kind}")
    with _DspTwins():
        generate(cfg, state, corpus.test, corpus.out_stats, outdir=twin_dir)
    unequal = [u for u in wavs
               if not np.array_equal(load_wav(os.path.join(twin_dir, u + ".wav"))[1], wavs[u])]
    print(f"[cli {kind}] generate through the kernels vs the twins: wavs unequal {unequal}")
    if unequal:
        raise AssertionError(f"{kind} generation through the kernels disagrees with the twins'")

    ref_dir = os.path.join(qs["root"], f"ref_{kind}")
    for u, c in zip(corpus.test.ids, corpus.test.cmps):
        save_binary_file(os.path.join(ref_dir, u + ".cmp"), corpus.out_stats.denormalize(c))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        if main("measures", "--config", cfg_path, "--ref", ref_dir, "--pred", gen_dir) != 0:
            raise AssertionError(f"cli measures ({kind}) failed")
    got = json.loads(text.getvalue())
    diff = abs(got["mcd_db"] - measures["mcd_db"])
    print(f"[cli {kind}] cli measures: {got}; |mcd - generate's| {diff:.3g} "
          f"(tol {QS_MCD_TOL * measures['mcd_db']:.3g})")
    if got["files"] != len(wavs) or not diff <= QS_MCD_TOL * measures["mcd_db"]:
        raise AssertionError(f"cli measures ({kind}) disagrees with generate's MCD")
    out.update(counts=counts, records=records, measures=measures, gen_audio_s=gen_audio)
    return out


def _te_path(dev, qs: dict) -> dict:
    """Phase 10c: PML with ``envelope="te"`` (the true envelope and the
    harmonicity noise mask; open-loop synthesis whatever ``closed_loop``
    says): phase 8's demo wavs analyzed against the twins, and the first
    ``TE_COPY_UTTS`` of them copy-synthesized (2 chunks of 4) against the
    twins, timed and profiled."""
    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.vocoders import get_vocoder

    voc = get_vocoder(VocoderConfig(envelope="te"), device=dev)
    ana = _analysis_run("analyze pml te", voc, _demo_wavs(qs))
    out = _vocode_run("vocode pml te", voc, ana["feats"][:TE_COPY_UTTS], TE_LAUNCHES)
    out["analysis"] = ana
    return out


def _analysis_variants_path(dev, qs: dict) -> dict:
    """Phase 10d: phase 8's demo wavs analyzed through the kernels against
    the twins under each of ``ANALYSIS_VARIANTS`` (WORLD's "te" envelope;
    PML's boundary-aware and windowed readers); each one's features differ
    from the same vocoder's default analysis (the option reached its
    reader)."""
    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.config import AnalysisParams
    from percivaltts_tpu_torch.data.compose import ANALYSIS_CHUNK
    from percivaltts_tpu_torch.vocoders import get_vocoder

    wavs = _demo_wavs(qs)
    base = {}
    out = {}
    for label, voc_kw, ap_kw in ANALYSIS_VARIANTS:
        kind = voc_kw.get("kind", "pml")
        if kind not in base:
            voc = get_vocoder(VocoderConfig(kind=kind), device=dev)
            base[kind] = [f for k in range(0, len(wavs), ANALYSIS_CHUNK)
                          for f in voc.analyze_batch(wavs[k:k + ANALYSIS_CHUNK])]
        voc = get_vocoder(VocoderConfig(**voc_kw, analysis=AnalysisParams(**ap_kw)), device=dev)
        run = _analysis_run(f"analyze {label}", voc, wavs)
        moved = max(float(np.abs(a - b).max()) for a, b in zip(run["feats"], base[kind]))
        print(f"[analyze {label}] largest difference from the default {kind} analysis {moved:.3g}")
        if not moved > 0.0:
            raise AssertionError(f"{label}: the analysis equals the default's")
        run.pop("feats")
        out[label] = run
    return out


def _export_generator_path(dev, kind: str, bounds) -> dict:
    """Phase 11a/11b for one generator (phase 4's seeded weights): export at
    ``bounds``, batch 1 and ``EXPORT_BATCH``, save, reload on the card and
    serve phase 4's requests that fit; the artifacts' rows equal, bit for
    bit, the live generator run on the same bucket-bound padded batches
    (normalized and denormalized on the host); the recurrent forwards
    launched inside the artifact calls, on the tensor-core route; a request
    past the largest bound refused; export, save and load seconds, bytes
    per bound, and the median serve through the batched artifact beside
    eager ``serve``'s."""
    import dataclasses
    import os
    import shutil

    from percivaltts_tpu_torch import ModelConfig, VocoderConfig
    from percivaltts_tpu_torch.eval.export import ExportedGenerator, export_generator, write_export
    from percivaltts_tpu_torch.eval.serve import serve
    from percivaltts_tpu_torch.models import build_generator

    voc = VocoderConfig()
    gen = build_generator(ModelConfig(**MODELS[kind]), voc, LABEL_DIM,
                          generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    labs, in_stats, out_stats = _requests(voc.feature_size)
    fit = [lab for lab in labs if lab.shape[0] <= max(bounds)]
    fwd, per_call = ("bigru_fwd", 2) if _is_gru(kind) else ("bilstm_fwd", 1)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", f"export_{kind}")
    shutil.rmtree(root, ignore_errors=True)
    out = {"counts": {name: 0 for name in _kernels()}, "routes": _no_routes()}
    for batch in (1, EXPORT_BATCH):
        d = os.path.join(root, f"b{batch}")
        arts, secs = {}, {}
        for b in bounds:
            t = time.perf_counter()
            arts.update(export_generator(gen, in_stats, out_stats, LABEL_DIM, (b,), batch=batch))
            secs[b] = time.perf_counter() - t
        t = time.perf_counter()
        write_export(d, arts, LABEL_DIM, voc.feature_size, dataclasses.asdict(voc), batch=batch)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        ex = ExportedGenerator(d, device=dev)
        load_s = time.perf_counter() - t
        sizes = {b: os.path.getsize(os.path.join(d, f"gen_t{b}.pt2")) for b in bounds}
        print(f"[export {kind}] batch {batch}: export s by bound "
              + ", ".join(f"{b}: {v:.3f}" for b, v in secs.items())
              + f"; save {save_s:.3f} s, load {load_s:.3f} s; bytes by bound {sizes}")

        groups = ex.groups(fit)
        _zero_counts()
        got = ex.predict_batch(fit)
        torch.cuda.synchronize()
        counts, routes = _counts(), _routes()
        print(f"[export {kind}] batch {batch}: {len(fit)} requests in {len(groups)} artifact "
              f"calls {[(b, len(g)) for b, g in groups]}; launches {counts}")
        if not (counts[fwd] == per_call * len(groups) and sum(counts.values()) == counts[fwd]):
            raise AssertionError(f"{counts} launches for {len(groups)} artifact calls")
        _all_mma(f"export {kind}", routes)
        for name in out["counts"]:
            out["counts"][name] += counts[name]
        for name, by_route in routes.items():
            for route, n in by_route.items():
                out["routes"][name][route] += n

        unequal = []
        for bound, group in groups:
            x = np.zeros((batch, bound, LABEL_DIM), np.float32)
            for r, j in enumerate(group):
                x[r, : fit[j].shape[0]] = in_stats.normalize(fit[j])
            with torch.inference_mode():
                y = gen(torch.from_numpy(x).to(dev)).float().cpu().numpy()
            for r, j in enumerate(group):
                n = fit[j].shape[0]
                want = out_stats.denormalize(y[r, :n]).astype(np.float32)
                if got[j].shape != want.shape or not np.array_equal(got[j], want):
                    unequal.append((n, float(np.abs(got[j] - want).max())))
        print(f"[export {kind}] batch {batch}: artifact rows against the live generator under "
              f"the same padding: unequal {unequal}")
        if unequal:
            raise AssertionError(f"the {kind} artifact disagrees with the live generator")
        longest = max(labs, key=len)
        try:
            ex(longest)
        except ValueError as e:
            print(f"[export {kind}] a {longest.shape[0]}-frame request is refused: {e}")
        else:
            raise AssertionError(f"a {longest.shape[0]}-frame request past the bounds was served")

        if batch == EXPORT_BATCH:
            lat = {"artifact": [], "eager serve": []}
            for _ in range(N_TIMED_EXPORT):
                for label, fn in (("artifact", lambda: ex.predict_batch(fit)),
                                  ("eager serve", lambda: serve(gen, fit, in_stats, out_stats))):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    lat[label].append((time.perf_counter() - t) * 1e3)
            med = {k: statistics.median(v) for k, v in lat.items()}
            print(f"[time] export {kind}: {len(fit)} requests "
                  f"({sum(lab.shape[0] for lab in fit)} frames), median of {N_TIMED_EXPORT}: "
                  f"batch-{batch} artifacts {med['artifact']:.3f} ms (min "
                  f"{min(lat['artifact']):.3f}), eager serve {med['eager serve']:.3f} ms (min "
                  f"{min(lat['eager serve']):.3f})")
            out.update(serve_ms=med, export_s=secs, save_s=save_s, load_s=load_s, bytes=sizes)
    shutil.rmtree(root, ignore_errors=True)
    return out


def _mel_requests(dev):
    """Phase 9a's config-4 features: phase 4's requests served by the
    ``cnn`` generator with 80 mel outputs (seeded as in phase 9a)."""
    from percivaltts_tpu_torch import ModelConfig, VocoderConfig
    from percivaltts_tpu_torch.eval.serve import serve
    from percivaltts_tpu_torch.models import build_generator

    vcfg = VocoderConfig(kind="melspec", mel_size=80)
    gen = build_generator(ModelConfig(generator="cnn"), vcfg, LABEL_DIM,
                          generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    labs, in_stats, out_stats = _requests(vcfg.feature_size)
    return serve(gen, labs, in_stats, out_stats)


def _export_synthesis_path(dev, card: str, feats_by_kind: dict, pml_syn) -> dict:
    """Phase 11c: the default PML synthesis (closed loop, 2 passes; the
    ``syn_t512.pt2`` that phase 11d's ``cli export`` wrote, loaded there as
    ``pml_syn``) and config 4's Griffin-Lim exported here at ``SYN_BOUND``,
    saved and reloaded on the card; each served request of 385–512 (PML)
    or 129–256 frames (Griffin-Lim) rendered by the artifact equals
    ``synthesize_batch([feats], seed=0, chunk=1)`` (the same padding to the
    bound, the same noise), bit for bit;
    the framing and overlap-add launches counted inside each artifact call;
    Griffin-Lim's export, save and load seconds and bytes, and the median
    ms of an artifact call beside ``synthesize_batch``'s."""
    import dataclasses
    import os
    import shutil

    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.eval.export import ExportedSynthesizer, export_synthesis, write_export
    from percivaltts_tpu_torch.vocoders import get_vocoder

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "export_synthesis")
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for kind, vcfg in (("pml", VocoderConfig()), ("melspec", VocoderConfig(kind="melspec",
                                                                            mel_size=80))):
        voc = get_vocoder(vcfg, device=dev)
        bound = CLI_EXPORT_BOUND if kind == "pml" else SYN_BOUND
        sel = [f for f in feats_by_kind[kind] if bound - voc.frame_multiple < f.shape[0] <= bound]
        run = {}
        if kind == "pml":
            syn = pml_syn
            print(f"[export pml synthesis] ({card}) phase 11d's cli export artifacts, bounds "
                  f"{syn.bounds}")
        else:
            d = os.path.join(root, kind)
            t = time.perf_counter()
            arts = export_synthesis(voc, (SYN_BOUND,))
            run["export_s"] = time.perf_counter() - t
            t = time.perf_counter()
            write_export(d, {}, LABEL_DIM, voc.feature_size, dataclasses.asdict(vcfg),
                         syn_artifacts=arts, hop=vcfg.shift_samples)
            run["save_s"] = time.perf_counter() - t
            t = time.perf_counter()
            syn = ExportedSynthesizer(d, device=dev)
            run["load_s"] = time.perf_counter() - t
            run["bytes"] = os.path.getsize(os.path.join(d, f"syn_t{SYN_BOUND}.pt2"))
            run["nodes"] = len(arts[SYN_BOUND].graph.nodes)
            print(f"[export {kind} synthesis] ({card}) bound {SYN_BOUND}: {run['nodes']} graph "
                  f"nodes; export {run['export_s']:.3f} s, save {run['save_s']:.3f} s, load "
                  f"{run['load_s']:.3f} s; {run['bytes']} bytes")
        want_counts = {name: SYN_LAUNCHES[kind].get(name, 0) * len(sel) for name in _kernels()}
        _zero_counts()
        wavs = [syn(f) for f in sel]
        torch.cuda.synchronize()
        counts = _counts()
        print(f"[export {kind} synthesis] {len(sel)} requests ({[f.shape[0] for f in sel]} "
              f"frames), launches inside the artifact calls {counts}")
        if counts != want_counts:
            raise AssertionError(f"the {kind} synthesis artifact launched {counts}, not "
                                 f"{want_counts}")
        unequal = []
        for f, w in zip(sel, wavs):
            want = voc.synthesize_batch([f], seed=0, chunk=1)[0]
            if w.shape != want.shape or not np.isfinite(w).all() or not np.array_equal(w, want):
                unequal.append((f.shape[0], float(np.abs(w - want).max())))
        print(f"[export {kind} synthesis] artifact against synthesize_batch(seed=0): unequal "
              f"{unequal}")
        if not sel or unequal:
            raise AssertionError(f"the {kind} synthesis artifact disagrees with synthesize_batch")
        lat = {"artifact": [], "synthesize_batch": []}
        for _ in range(N_TIMED_EXPORT):
            for label, fn in (("artifact", lambda: syn(sel[0])),
                              ("synthesize_batch",
                               lambda: voc.synthesize_batch([sel[0]], seed=0, chunk=1))):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                lat[label].append((time.perf_counter() - t) * 1e3)
        med = {k: statistics.median(v) for k, v in lat.items()}
        print(f"[time] export {kind} synthesis ({card}): one {sel[0].shape[0]}-frame request, "
              f"median of {N_TIMED_EXPORT}: artifact {med['artifact']:.3f} ms (min "
              f"{min(lat['artifact']):.3f}), synthesize_batch {med['synthesize_batch']:.3f} ms "
              f"(min {min(lat['synthesize_batch']):.3f})")
        out[kind] = dict(run, counts=counts, ms=med)
    shutil.rmtree(root, ignore_errors=True)
    return out


def _start_cli_export(qs: dict) -> dict:
    """Phase 11d's ``cli export`` on phase 8's quick-start workdir (config 1,
    the best checkpoint's EMA, the default PML synthesis) through a copy of
    its config with the one bucket bound ``CLI_EXPORT_BOUND``, started as
    soon as phase 8 has written that workdir: the command line (on the
    card) in a subprocess one nice level down, so that its trace of the PML
    synthesis graph (85–210 s of host time, most of phase 11) runs while
    phases 9–10 use the card; ``_cli_export_path`` waits for it (a process
    still running when the script exits is killed)."""
    import atexit
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    d = json.loads(json.dumps(qs["cfg"]))
    d["data"]["bucket_bounds"] = [CLI_EXPORT_BOUND]
    cfg_path = _write_config(os.path.join(qs["root"], "config1_export.json"), d)
    outdir = os.path.join(qs["root"], "export")
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the command's own wall time, printed by the wrapper around it
    code = ("import sys, time; t = time.perf_counter(); from percivaltts_tpu_torch import cli; "
            "rc = cli.main(sys.argv[1:]); print(f'EXPORT_S {time.perf_counter() - t:.3f}'); "
            "sys.exit(rc)")
    log = os.path.join(qs["root"], "cli_export.log")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code, "export", "--config", cfg_path,
                                 "--out", outdir], cwd=repo, env=env, stdout=f,
                                stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(1))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "cfg_path": cfg_path, "outdir": outdir, "log": log}


def _cli_export_path(dev, card: str, qs: dict, started: dict) -> dict:
    """Phase 11d: ``cli export`` (started by ``_start_cli_export``) must exit
    0 within ``CLI_EXPORT_TIMEOUT_S``; then its artifacts on the card turn
    the test split's label files into features and wavs: the features
    within phase 4's tolerance of those ``cli synth`` serves from the same
    checkpoint, 7 framings and 6 overlap-adds a wav, finite wavs of nf·80
    samples."""
    import os

    from percivaltts_tpu_torch.config import Configuration
    from percivaltts_tpu_torch.data.hts_labels import QuestionSet, binarize_label_file
    from percivaltts_tpu_torch.eval.export import ExportedGenerator, ExportedSynthesizer
    from percivaltts_tpu_torch.eval.serve import serve
    from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
    from percivaltts_tpu_torch.training.state import eval_generator, make_gan_state

    cfg_path, outdir = started["cfg_path"], started["outdir"]
    cfg = Configuration.load(cfg_path)
    started["proc"].wait(timeout=CLI_EXPORT_TIMEOUT_S)
    with open(started["log"]) as f:
        out = f.read()
    for line in out.strip().splitlines()[-6:]:
        print(f"[cli export] | {line}")
    if started["proc"].returncode != 0:
        raise AssertionError(f"cli export failed ({started['proc'].returncode})")
    export_s = float(re.findall(r"^EXPORT_S (\S+)$", out, re.M)[-1])
    with open(os.path.join(outdir, "manifest.json")) as f:
        manifest = json.load(f)
    sizes = {n: os.path.getsize(os.path.join(outdir, n)) for n in sorted(os.listdir(outdir))
             if n.endswith(".pt2")}
    print(f"[cli export] ({card}) {export_s:.2f} s (in the background beside phases 9–10); "
          f"manifest bounds {manifest['bounds']}, "
          f"synthesis {manifest['synthesis']}; bytes {sizes}")
    if manifest["bounds"] != [CLI_EXPORT_BOUND] or \
            manifest["synthesis"]["bounds"] != [CLI_EXPORT_BOUND]:
        raise AssertionError(f"cli export wrote {manifest}")

    questions = QuestionSet.from_hed(cfg.data.question_file)
    label_dir = os.path.join(cfg.data.corpus_dir, cfg.data.label_dir)
    ids = qs["corpus"].test.ids
    labs = [binarize_label_file(os.path.join(label_dir, u + ".lab"), questions,
                                cfg.vocoder.shift_ms / 1000.0) for u in ids]
    t = time.perf_counter()
    ex, syn = ExportedGenerator(outdir, device=dev), ExportedSynthesizer(outdir, device=dev)
    load_s = time.perf_counter() - t
    _zero_counts()
    t = time.perf_counter()
    feats = ex.predict_batch(labs)
    wavs = [syn(f) for f in feats]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    counts = _counts()
    want = {name: 0 for name in counts}
    want.update({name: n * len(labs) for name, n in SYN_LAUNCHES["pml"].items()})
    audio_s = sum(len(w) for w in wavs) / cfg.vocoder.fs
    print(f"[cli export] {len(labs)} test label files → features and wavs through the "
          f"artifacts in {serve_s:.3f} s ({audio_s:.2f} s of audio, load {load_s:.2f} s); "
          f"launches {counts}")
    if counts != want:
        raise AssertionError(f"the exported chain launched {counts}, not {want}")
    for lab, f, w in zip(labs, feats, wavs):
        n = lab.shape[0]
        if f.shape != (n, 99) or w.shape != (n * 80,) or not np.isfinite(w).all():
            raise AssertionError(f"bad exported output for a {n}-frame label file")

    from percivaltts_tpu_torch.data.normalize import NormStats

    in_stats = NormStats.load(os.path.join(cfg.workdir, "in_stats.npz"))
    out_stats = NormStats.load(os.path.join(cfg.workdir, "out_stats.npz"))
    ckpt = CheckpointManager(os.path.join(cfg.workdir, "checkpoints"))
    state = ckpt.restore(make_gan_state(cfg, labs[0].shape[1], device=dev), ckpt.best_step())
    served = serve(eval_generator(state), labs, in_stats, out_stats)
    err = max(float(np.abs(a - b).max()) for a, b in zip(feats, served))
    print(f"[cli export] max|exported - cli synth's served features| = {err:.3g} (tol "
          f"{SERVE_TOL['cnn_blstm']:g})")
    if not err <= SERVE_TOL["cnn_blstm"]:
        raise AssertionError("the exported generator disagrees with cli synth's features")
    return {"counts": counts, "export_s": export_s, "bytes": sizes, "serve_s": serve_s,
            "audio_s": audio_s, "err": err, "load_s": load_s, "syn": syn}


def _dispatch_cost(dev, card: str, mel_feats) -> dict:
    """Phase 11e: what the registered operators would cost eager code. One
    overlap-add of one frame through the op (``torch.ops.percival``, as an
    exported graph calls it) against the eager wrapper
    (``frames_cuda.overlap_add``, which calls the same CUDA function without
    the dispatcher), ``DISPATCH_CALLS`` calls each, host µs a call; then
    config 4's Griffin-Lim vocode (388 launches) with ``ops/stft.py``
    calling the ops and calling the wrappers, in turns (op, eager, eager,
    op), medians of ``N_DISPATCH_VOCODES``."""
    import types

    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.ops import frames_cuda as fc
    from percivaltts_tpu_torch.ops import stft
    from percivaltts_tpu_torch.vocoders import get_vocoder

    frames = torch.randn(1, 1, 80, device=dev)
    per_call = {}
    for label, fn in (("op", torch.ops.percival.overlap_add), ("eager", fc.overlap_add)) * 2:
        fn(frames, 80, 80)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn(frames, 80, 80)
        torch.cuda.synchronize()
        per_call.setdefault(label, []).append((time.perf_counter() - t) / DISPATCH_CALLS * 1e6)

    voc = get_vocoder(VocoderConfig(kind="melspec", mel_size=80), device=dev)
    # ops/stft.py reaches the kernels as frames_cuda.frame_window / overlap_add
    through_op = types.SimpleNamespace(frame_window=torch.ops.percival.frame_window,
                                       overlap_add=torch.ops.percival.overlap_add)
    vocode = {}
    try:
        for label in ("op", "eager", "eager", "op"):
            stft.frames_cuda = through_op if label == "op" else fc
            voc.synthesize_batch(mel_feats)
            lat = []
            for _ in range(N_DISPATCH_VOCODES):
                torch.cuda.synchronize()
                t = time.perf_counter()
                voc.synthesize_batch(mel_feats)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t) * 1e3)
            vocode.setdefault(label, []).append(statistics.median(lat))
    finally:
        stft.frames_cuda = fc
    us = {k: statistics.mean(v) for k, v in per_call.items()}
    ms = {k: statistics.mean(v) for k, v in vocode.items()}
    print(f"[dispatch] ({card}) one overlap-add a call, host µs: through the op "
          f"{per_call['op']}, eager {per_call['eager']}: {us['op'] - us['eager']:.2f} µs a call "
          f"for the operator")
    print(f"[dispatch] ({card}) Griffin-Lim vocode (388 launches), medians of "
          f"{N_DISPATCH_VOCODES} in turns op/eager/eager/op: op {vocode['op']} ms, eager "
          f"{vocode['eager']} ms: {ms['op'] - ms['eager']:.3f} ms a vocode, "
          f"{(ms['op'] - ms['eager']) / 388 * 1e3:.2f} µs a launch")
    return {"us": us, "vocode_ms": ms}


def _dsp_bound(name: str, shape) -> tuple:
    """(least ms, "bytes" or "operations") of one f32 DSP call: inputs read
    once, outputs written once, against its multiplies or adds at the f32
    rate."""
    if name == "frame_window":
        B, n, fl, hop, windowed = shape
        nf = -(-n // hop)
        nbytes = 4 * (B * n + B * nf * fl + (fl if windowed else 0))
        ops = B * nf * fl if windowed else 0
    else:
        B, nf, fl, hop, *broadcast = shape
        nbytes = 4 * ((fl if broadcast else B * nf * fl) + B * nf * hop)
        ops = B * nf * fl
    return _bound(nbytes, ops, torch.float32)


def _library_dsp(name: str, shape, args):
    """The one PyTorch call that computes the same function, as a
    zero-argument callable: ``F.unfold`` (im2col) of the zero-padded signal,
    times the window, for framing; ``F.fold`` (col2im) cut to the centred
    span, for overlap-add. Timed here only; the port never calls them."""
    import torch.nn.functional as F

    if name == "frame_window":
        B, n, fl, hop, _ = shape
        x, w = args
        nf = -(-n // hop)

        def call():
            xp = F.pad(x, (fl // 2, nf * hop + fl - n))[:, None, None, :]
            cols = F.unfold(xp, (1, fl), stride=(1, hop))[..., :nf].transpose(1, 2)
            return cols if w is None else cols * w
        return call
    B, nf, fl, hop, *_ = shape
    (frames,) = args
    span = (nf - 1) * hop + fl

    def call():
        out = F.fold(frames.transpose(1, 2), (1, span), (1, fl), stride=(1, hop))
        return out[:, 0, 0, fl // 2: fl // 2 + nf * hop]
    return call


def _device_ms(fn, calls: int = 20, match: str = "", tries: int = 3):
    """Device time of one call of ``fn`` from ``torch.profiler`` over
    ``calls`` calls (after one warm-up call): for each name of device event
    (only those holding ``match``), the mean of its durations times the
    times it runs a call, ``ceil(found / calls)``, summed. A trace now and
    then drops some of a kernel's events (the cluster kernels' most: the
    plain sum over ``calls`` read a third of a wide layer's time in one run
    on the H100), so counts are not taken from the sum. None when ``tries``
    traces in a row hold no such device events (the profiler now and then
    records none). A DSP call is a few microseconds of device work behind
    tens of microseconds of host work, so CUDA events around back-to-back
    calls time the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name:
                spans.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
        if spans:
            return sum(sum(v) / len(v) * -(-len(v) // calls) for v in spans.values()) / 1e3
    return None


def _time_dsp_kernels(dev) -> dict:
    """Phase 6, DSP kernels: each at the vocode path's shapes in f32 beside
    its twin, its bound and its library call; device time per call
    (``torch.profiler``) for all three, and the CUDA-event time per call of
    back-to-back calls, host work included (``call_ms``). Each row also
    carries its share of the bound and the launch floor (``floor_ms``: the
    device time of a one-element ``fill_``, the least any launch costs), so
    that a shape whose bound lies below the floor is judged by the floor."""
    from percivaltts_tpu_torch.ops import frames_cuda as fc
    from percivaltts_tpu_torch.ops.stft import hann_window

    one = torch.zeros(1, device=dev)
    floor_ms = _device_ms(lambda: one.fill_(1.0), calls=50)
    print(f"[time] launch floor: a one-element fill_ takes {floor_ms} device ms (torch.profiler, "
          "mean of 50)")
    out = {"frame_window": [], "overlap_add": []}
    for name, shapes in (("frame_window", FRAME_SHAPES[:3] + [GL_FRAME]), ("overlap_add", OLA_TIMED)):
        for shape in shapes:
            g = torch.Generator(device=dev).manual_seed(5)
            if name == "frame_window":
                B, n, fl, hop, windowed = shape
                args = (torch.randn(B, n, generator=g, device=dev),
                        hann_window(fl, device=dev) if windowed else None)
                kern = lambda: fc.frame_window(args[0], fl, hop, args[1])  # noqa: E731
                twin = lambda: fc.frame_window_reference(args[0], fl, hop, args[1])  # noqa: E731
            else:
                B, nf, fl, hop, *broadcast = shape
                w = hann_window(fl, device=dev)
                args = ((w * w).expand(B, nf, fl) if broadcast else
                        torch.randn(B, nf, fl, generator=g, device=dev),)
                kern = lambda: fc.overlap_add(args[0], hop, nf * hop)  # noqa: E731
                twin = lambda: fc.overlap_add_reference(args[0], hop, nf * hop)  # noqa: E731
            lib = _library_dsp(name, shape, args)
            lib_err = (lib() - twin()).abs().max().item()
            call_ms = {k: _median_ms(f, runs=7, inner=20)
                       for k, f in (("kernel", kern), ("plain", twin), ("library", lib))}
            dev_ms = {k: _device_ms(f) for k, f in (("kernel", kern), ("plain", twin), ("library", lib))}
            ms = dev_ms["kernel"] or call_ms["kernel"]
            bound_ms, bound_by = _dsp_bound(name, shape)
            out[name].append({"shape": list(shape), "ms": ms, "plain_ms": dev_ms["plain"],
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "share_of_bound": bound_ms / ms, "floor_ms": floor_ms,
                              "library_ms": dev_ms["library"], "call_ms": call_ms})
            floor = (f"{ms - floor_ms:.5f} ms above the launch floor {floor_ms:.5f} ms"
                     + (" (the bound lies below the floor: judged by the floor)"
                        if bound_ms < floor_ms else "")) if floor_ms else "launch floor not measured"
            clock = ("device ms" if dev_ms["kernel"] else "ms by CUDA events, host work "
                     "included: the profiler recorded no device event")
            print(f"[time] {name} {shape} f32: {ms:.5f} {clock}, bound {bound_ms:.5f} ms "
                  f"({bound_by}), {bound_ms / ms:.3f} of the bound, {floor}")
            print(f"[time] {name} {shape} f32, device time per call: kernel {dev_ms['kernel']} ms, "
                  f"plain twin {dev_ms['plain']} ms, library {dev_ms['library']} ms (max|library-plain| "
                  f"{lib_err:.3g}); bound {bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.3f} of the "
                  f"bound; per call with host work (CUDA events, medians): kernel "
                  f"{call_ms['kernel']:.4f} ms, plain {call_ms['plain']:.4f} ms, library "
                  f"{call_ms['library']:.4f} ms")
    return out


def _state_on_host(state) -> dict:
    """A host copy of the generator's Adam first moments by parameter name."""
    return {n: state.gen_opt.state[p]["exp_avg"].detach().to("cpu", copy=True)
            for n, p in state.gen.named_parameters()}


def _sets_corpus(sets):
    """The utterances of ``_train_setup``'s batches (each row cut to its
    mask) as a ``Dataset``: 2 sets × 6 batches × 32 rows."""
    from percivaltts_tpu_torch.data.dataset import Dataset

    labs, cmps = [], []
    for critic, gen in sets:
        nc = critic["lab"].shape[0]
        for b in [{k: v[i] for k, v in critic.items()} for i in range(nc)] + [gen]:
            lab, cmp, mask = (b[k].cpu().numpy() for k in ("lab", "cmp", "mask"))
            for j in range(lab.shape[0]):
                n = int(mask[j].sum())
                labs.append(lab[j, :n])
                cmps.append(cmp[j, :n])
    return Dataset(labs, cmps)


def _mesh_world1_path(dev, card: str) -> dict:
    """Phase 12a: phase 7's config and corpus through ``Trainer(mesh=
    make_mesh())`` over an NCCL group of one, 2 epochs, against the same
    ``Trainer`` without a mesh, both with cuDNN's deterministic algorithms:
    every state tensor equal bit for bit, the launches of #1/#2, the epoch
    walls; then a WGAN-GP step's wall at B=32 under the mesh against
    without it, in turns, and the all-reduces a step."""
    import torch.distributed as dist

    from percivaltts_tpu_torch.parallel import distributed, make_mesh
    from percivaltts_tpu_torch.training import Trainer
    from percivaltts_tpu_torch.training.state import make_gan_state

    distributed.initialize(backend="nccl")
    try:
        mesh = make_mesh()
        if mesh.shape != {"data": 1, "model": 1} or mesh.device != dev:
            raise AssertionError(f"make_mesh() gave {mesh}")
        flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        runs = {}
        try:
            for name, m in (("no mesh", None), ("mesh", mesh)):
                cfg, train_ds, valid_ds, in_stats, out_stats = _loop_setup(
                    "mesh_world1" if m else "mesh_none")
                _zero_counts()
                trainer = Trainer(cfg, train_ds, valid_ds, mesh=m, in_stats=in_stats,
                                  out_stats=out_stats)
                hist = trainer.train(epochs=LOOP_EPOCHS)
                trainer.close()
                torch.cuda.synchronize()
                runs[name] = {"hist": hist, "state": _host_copy(trainer.state.state_dict()),
                              "counts": _counts(), "routes": _routes(), "workdir": cfg.workdir}
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        a, b = runs["no mesh"], runs["mesh"]
        diffs = {}
        for part in ("gen", "critic"):
            for n, t in a["state"][part].items():
                diffs[f"{part}.{n}"] = (t.float() - b["state"][part][n].float()).abs().max().item()
        print(f"[mesh world 1] ({card}) NCCL group of one against no mesh, {LOOP_EPOCHS} epochs, "
              f"max |diff| of each of the {len(diffs)} parameters: "
              + ", ".join(f"{n} {d:.3g}" for n, d in diffs.items()))
        rest = _tree_diff(a["state"], b["state"])
        steps = [r["steps"] for r in b["hist"]["train"]]
        n_valid = sum(_bucket_batches(valid_ds, TRAIN_B, LOOP_BOUNDS, whole=False).values())
        want = (2 * sum(steps) + n_valid * LOOP_EPOCHS, sum(steps))
        got = (b["counts"]["bilstm_fwd"], b["counts"]["bilstm_bwd"])
        for name, run in runs.items():
            print(f"[mesh world 1] ({card}) {name}: epochs "
                  + ", ".join(f"{r['sec']:.3f} s ({r['steps']} steps, loss {r['loss']:.6g})"
                              for r in run["hist"]["train"])
                  + f"; valid {run['hist']['valid']}; launches {run['counts']}")
        if any(diffs.values()) or rest:
            raise AssertionError(f"the mesh of one trained another state: {rest[:8]}")
        if a["hist"]["valid"] != b["hist"]["valid"] or got != want \
                or a["counts"] != b["counts"]:
            raise AssertionError(f"mesh of one: launches {got} (expected {want}), valid "
                                 f"{b['hist']['valid']} vs {a['hist']['valid']}")
        _all_mma("mesh world 1", b["routes"])
        for run in runs.values():
            shutil.rmtree(run["workdir"], ignore_errors=True)

        # a step's wall with and without the mesh, in turns; the all-reduces a step
        setups = {"no mesh": _train_setup(dev, "cnn_blstm"),
                  "mesh": _train_setup(dev, "cnn_blstm", mesh)}
        states = {k: make_gan_state(cfg, LABEL_DIM, seed=SEED, device=dev,
                                    mesh=mesh if k == "mesh" else None)
                  for k, (cfg, _, _) in setups.items()}
        reduce, calls = dist.all_reduce, []
        dist.all_reduce = lambda *args, **kw: calls.append(1) or reduce(*args, **kw)
        try:
            _, sets, step = setups["mesh"]
            step(states["mesh"], *sets[0])
        finally:
            dist.all_reduce = reduce
        times = {k: [] for k in setups}
        for k, (_, sets, step) in setups.items():  # warm-up
            step(states[k], *sets[0])
        for k in ("no mesh", "mesh", "mesh", "no mesh") * 2:  # the host's spread is wide
            _, sets, step = setups[k]
            for i in range(N_TIMED_STEPS // 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(states[k], *sets[i % 2])
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
        step_ms = {k: statistics.median(v) for k, v in times.items()}
        print(f"[mesh world 1] ({card}) WGAN-GP step (B={TRAIN_B}, T={TRAIN_T}): median "
              f"{step_ms['mesh']:.3f} ms (min {min(times['mesh']):.3f}) over an NCCL group of one "
              f"({len(calls)} all-reduces a step) against {step_ms['no mesh']:.3f} ms (min "
              f"{min(times['no mesh']):.3f}) without a mesh ({len(times['mesh'])} steps each, "
              "in turns)")
    finally:
        dist.destroy_process_group()
    return {"counts": b["counts"], "routes": b["routes"], "records": b["hist"]["train"],
            "records_no_mesh": a["hist"]["train"], "step_ms": step_ms, "all_reduces": len(calls)}


def _mesh_rank(rank: int, world: int, init_file: str, out_path: str) -> None:
    """Phase 12b, one rank (a spawned process): config 3's WGAN-GP step over
    a gloo group of ``world`` ranks on ``DEVICE`` from the seeded state on
    this rank's rows of ``_train_setup``'s first set, its launches, a few
    timed steps, then the same step gathered from a ``shard_corpus=True``
    device corpus, and from a per-process one (``make_mesh(per_process=
    True)``) built from this rank's own ``Dataset.shard`` of the first
    ``PER_PROCESS_UTTS`` utterances, its collectives counted; written to
    ``out_path``."""
    import torch.distributed as dist

    from percivaltts_tpu_torch.data.dataset import Dataset
    from percivaltts_tpu_torch.data.device_corpus import DeviceCorpus, make_device_wgan_step
    from percivaltts_tpu_torch.parallel import distributed, make_mesh
    from percivaltts_tpu_torch.parallel.mesh import shard_batch, shard_stacked_batch
    from percivaltts_tpu_torch.training.state import make_gan_state

    dev = torch.device(DEVICE)
    distributed.initialize(f"file://{init_file}", world, rank, "gloo")
    mesh = make_mesh(devices=[dev] * world)
    cfg, sets, step = _train_setup(dev, "cnn_blstm", mesh)
    nc = cfg.train.n_critic
    out = {}
    state = make_gan_state(cfg, LABEL_DIM, seed=SEED, mesh=mesh)
    cb, gb = shard_stacked_batch(sets[0][0], mesh), shard_batch(sets[0][1], mesh)
    _zero_counts()
    state, m = step(state, cb, gb)
    torch.cuda.synchronize()
    out["step"] = {"metrics": {k: v.item() for k, v in m.items()}, "exp_avg": _state_on_host(state),
                   "state": _host_copy(state.state_dict()), "counts": _counts(),
                   "routes": _routes(), "rows": cb["lab"].shape[1]}
    local = [(shard_stacked_batch(c, mesh), shard_batch(g, mesh)) for c, g in sets]
    step(state, *local[1])  # warm-up
    times = []
    for i in range(N_TIMED_STEPS // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *local[i % 2])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = statistics.median(times)

    corpus = DeviceCorpus(_sets_corpus(sets), bound=TRAIN_T, mesh=mesh, shard_corpus=True,
                          device=dev)
    idx = next(corpus.epoch_indices(TRAIN_B, nc + 1, 0, seed=SEED))
    state = make_gan_state(cfg, LABEL_DIM, seed=SEED, mesh=mesh)
    _zero_counts()
    state, m = make_device_wgan_step(step, nc)(state, corpus.data, corpus.shard_indices(idx))
    torch.cuda.synchronize()
    out["corpus"] = {"metrics": {k: v.item() for k, v in m.items()},
                     "exp_avg": _state_on_host(state), "state": _host_copy(state.state_dict()),
                     "counts": _counts(), "routes": _routes(),
                     "rows_held": corpus.data["lab"].shape[0],
                     "idx": torch.from_numpy(idx), "padded": corpus.num_utts_padded}

    # the per-process corpus: this rank reads only its own shard
    whole = _sets_corpus(sets)
    own = Dataset(whole.labs[:PER_PROCESS_UTTS], whole.cmps[:PER_PROCESS_UTTS]).shard(world, rank)
    del whole, corpus
    pmesh = make_mesh(devices=[dev] * world, per_process=True)
    collectives = dict.fromkeys(CORPUS_COLLECTIVES, 0)
    saved = {name: getattr(dist, name) for name in CORPUS_COLLECTIVES}

    def counted(name):
        return lambda *a, **kw: collectives.__setitem__(name, collectives[name] + 1) \
            or saved[name](*a, **kw)

    for name in CORPUS_COLLECTIVES:
        setattr(dist, name, counted(name))
    try:
        corpus = DeviceCorpus(own, bound=TRAIN_T, mesh=pmesh, shard_corpus=True, device=dev)
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    idx = next(corpus.epoch_indices(TRAIN_B, nc + 1, 0, seed=SEED))
    state = make_gan_state(cfg, LABEL_DIM, seed=SEED, mesh=pmesh)
    _zero_counts()
    state, m = make_device_wgan_step(step, nc)(state, corpus.data, corpus.shard_indices(idx))
    torch.cuda.synchronize()
    out["per_process"] = {
        "metrics": {k: v.item() for k, v in m.items()}, "exp_avg": _state_on_host(state),
        "state": _host_copy(state.state_dict()), "counts": _counts(), "routes": _routes(),
        "rows_held": corpus.data["lab"].shape[0], "idx": torch.from_numpy(idx),
        "padded": corpus.num_utts_padded, "num_utts": corpus.num_utts,
        "nbytes": corpus.nbytes, "collectives": collectives,
        "host_bytes": sum(a.nbytes for a in own.labs + own.cmps)}
    torch.save(out, out_path)
    dist.destroy_process_group()


def _mesh_world2_path(dev, card: str) -> dict:
    """Phase 12b: ``_mesh_rank`` on 2 spawned ranks sharing the card over
    gloo (NCCL refuses two ranks on one device), each held against the
    world-size-1 step on the whole batches (``STEP_METRIC_TOL`` /
    ``STEP_MOMENT_TOL``), the ranks' states bit-equal, (2, 1) launches a
    step at B=16 on each rank; the same for the step from the sharded
    device corpus (each rank holding half the corpus) and from the
    per-process corpus (each rank given its own ``Dataset.shard`` of
    ``PER_PROCESS_UTTS`` utterances; one all-gather, its bytes beside the
    one-host layout's); bf16's spread at world size 1 beside them. The gloo wall is no scaling number: the
    ranks share one card and gloo stages the all-reduces through the
    host."""
    import os

    from percivaltts_tpu_torch.data.dataset import Dataset
    from percivaltts_tpu_torch.data.device_corpus import DeviceCorpus, make_device_wgan_step
    from percivaltts_tpu_torch.parallel.mesh import Mesh
    from percivaltts_tpu_torch.training.state import make_gan_state

    world = 2
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mesh_world2")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    # the world-size-1 references, on the whole batches
    cfg, sets, step = _train_setup(dev, "cnn_blstm")
    nc = cfg.train.n_critic
    state, m = step(make_gan_state(cfg, LABEL_DIM, seed=SEED, device=dev), *sets[0])
    refs = {"step": ({k: v.item() for k, v in m.items()}, _state_on_host(state))}
    ds = _sets_corpus(sets)
    # the sharded corpus's index columns index each rank's block: shifted
    # by the block's first row, they index the whole corpus
    half = DeviceCorpus(ds, bound=TRAIN_T, mesh=Mesh(rank=0, size=world, device=dev),
                        shard_corpus=True, device=dev)
    idx = next(half.epoch_indices(TRAIN_B, nc + 1, 0, seed=SEED))
    per = TRAIN_B // world
    block = half.num_utts_padded // world
    whole_idx = idx + np.repeat(np.arange(world) * block, per)[None, :]
    whole = DeviceCorpus(ds, bound=TRAIN_T, device=dev)
    state, m = make_device_wgan_step(step, nc)(
        make_gan_state(cfg, LABEL_DIM, seed=SEED, device=dev), whole.data,
        whole.shard_indices(whole_idx))
    refs["corpus"] = ({k: v.item() for k, v in m.items()}, _state_on_host(state))
    # the per-process corpus: rank r's block row j holds utterance j mod N_r
    # of its shard, global r + world·(j mod N_r); its index arrays are the
    # one-host corpus's (the same padded rows a block, 192)
    first = Dataset(ds.labs[:PER_PROCESS_UTTS], ds.cmps[:PER_PROCESS_UTTS])
    n_own = [len(range(r, PER_PROCESS_UTTS, world)) for r in range(world)]
    rank_of = np.repeat(np.arange(world), per)[None, :]
    pp_idx = rank_of + world * (idx % np.asarray(n_own)[rank_of])
    del whole
    whole = DeviceCorpus(first, bound=TRAIN_T, device=dev)
    state, m = make_device_wgan_step(step, nc)(
        make_gan_state(cfg, LABEL_DIM, seed=SEED, device=dev), whole.data,
        whole.shard_indices(pp_idx))
    refs["per_process"] = ({k: v.item() for k, v in m.items()}, _state_on_host(state))
    one_host = DeviceCorpus(first, bound=TRAIN_T, mesh=Mesh(rank=0, size=world, device=dev),
                            shard_corpus=True, device=dev)
    layout_bytes = {"one-host block": one_host.nbytes, "replicated": whole.nbytes,
                    "host, whole corpus": sum(a.nbytes for a in first.labs + first.cmps)}
    del one_host, first
    # bf16's own spread at world size 1: the same step on each batch's rows
    # reversed (ε reversed with them) sums the weight gradients in another
    # order, as splitting the rows over ranks does
    eps = torch.rand((nc, TRAIN_B, 1, 1), generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    spread = []
    for flip in (False, True):
        cb, gb = sets[0]
        if flip:
            cb, gb = {k: v.flip(1) for k, v in cb.items()}, {k: v.flip(0) for k, v in gb.items()}
        state, m = step(make_gan_state(cfg, LABEL_DIM, seed=SEED, device=dev), cb, gb,
                        eps=eps.flip(1) if flip else eps)
        spread.append(({k: v.item() for k, v in m.items()}, _state_on_host(state)))
    _hold_step("mesh world 2", "world size 1, rows reversed against in order", *spread[::-1])
    del half, whole, state, sets
    torch.cuda.synchronize()

    ctx = torch.multiprocessing.get_context("spawn")
    outs = [os.path.join(root, f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, os.path.join(root, "group"), outs[r]))
             for r in range(world)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(MESH_TIMEOUT_S - (time.perf_counter() - t), 1.0))
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t
    if hung or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"the gloo ranks failed: exit codes {[p.exitcode for p in procs]}"
                             + (f", killed after {MESH_TIMEOUT_S} s: {hung}" if hung else ""))
    ranks = [torch.load(o, weights_only=True) for o in outs]
    want_launches = {"bilstm_fwd": STEP_LAUNCHES["cnn_blstm"][0],
                     "bilstm_bwd": STEP_LAUNCHES["cnn_blstm"][1]}
    counts, routes = {}, _no_routes()
    for case in ("step", "corpus", "per_process"):
        for r, got in enumerate(ranks):
            c = got[case]
            for name, by_route in c["routes"].items():
                for route, n in by_route.items():
                    routes[name][route] += n
            print(f"[mesh world 2] ({card}) rank {r}, {case}: launches {c['counts']}"
                  + (f", {c['rows']} rows a batch" if case == "step" else
                     f", {c['rows_held']} of {c['padded']} padded utterances held"))
            launched = {k: c["counts"][k] for k in want_launches}
            if launched != want_launches or sum(c["counts"].values()) != sum(launched.values()):
                raise AssertionError(f"rank {r} launched {c['counts']}, not {want_launches}")
            _hold_step(f"mesh world 2, rank {r}", f"{case} against world size 1",
                       (c["metrics"], c["exp_avg"]), refs[case])
            counts[f"mesh_world2_{case}_rank{r}"] = c["counts"]
        diff = _tree_diff(ranks[0][case]["state"], ranks[1][case]["state"])
        if diff:
            raise AssertionError(f"the ranks' states differ after the {case} step: {diff[:8]}")
        _all_mma(f"mesh world 2 {case}", ranks[0][case]["routes"])
    if ranks[0]["step"]["rows"] != per or ranks[0]["corpus"]["rows_held"] != block \
            or not torch.equal(ranks[0]["corpus"]["idx"], torch.from_numpy(idx)):
        raise AssertionError("the ranks did not take their halves")
    pp = [got["per_process"] for got in ranks]
    want_collectives = {**dict.fromkeys(CORPUS_COLLECTIVES, 0), "all_gather": 1}
    for r, c in enumerate(pp):
        print(f"[mesh world 2] ({card}) rank {r}, per_process: {c['num_utts']} utterances of its "
              f"own shard ({c['host_bytes']} bytes on the host, against "
              f"{layout_bytes['host, whole corpus']} for the whole corpus), padded to "
              f"{c['rows_held']} rows, {c['nbytes']} bytes on the card (the one-host layout's "
              f"block {layout_bytes['one-host block']}, the replicated corpus "
              f"{layout_bytes['replicated']}); collectives while it was built "
              f"{ {k: v for k, v in c['collectives'].items() if v} }")
        if (c["num_utts"], c["rows_held"], c["padded"]) != (n_own[r], max(n_own),
                                                            world * max(n_own)) \
                or c["collectives"] != want_collectives \
                or not torch.equal(c["idx"], torch.from_numpy(idx)):
            raise AssertionError(f"rank {r}'s per-process corpus: {c['num_utts']} utterances, "
                                 f"{c['rows_held']} rows of {c['padded']}, collectives "
                                 f"{c['collectives']}")
    step_ms = [r["step_ms"] for r in ranks]
    print(f"[mesh world 2] ({card}) both ranks' states bit-equal after each step; WGAN-GP step "
          f"median {step_ms} ms a rank (B={per} a rank; 2 ranks on one card over gloo, which "
          f"stages each all-reduce through the host: not a scaling number); ranks' run "
          f"{wall:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return {"counts": counts, "routes": routes, "step_ms": step_ms, "wall_s": wall,
            "per_process_bytes": [c["nbytes"] for c in pp], "layout_bytes": layout_bytes}


def _mesh_cli_path(dev, card: str, qs: dict) -> dict:
    """Phase 12c: ``python -m torch.distributed.run --standalone
    --nproc-per-node 1 -m percivaltts_tpu_torch.cli train --mesh
    --device-corpus`` with config 3 (WGAN-GP) on phase 8's corpus (its
    feature cache copied), 1 epoch of 2 steps with measures: exit 0, one
    record of each epoch, the checkpoint, and ``cli synth`` serving it."""
    import os

    from percivaltts_tpu_torch import cli
    from percivaltts_tpu_torch.config import Configuration
    from percivaltts_tpu_torch.data.compose import load_wav

    repo = os.path.dirname(os.path.abspath(__file__))
    defaults = Configuration().to_dict()
    d = json.loads(json.dumps(qs["cfg"]))
    d["workdir"] = workdir = os.path.join(qs["root"], "exp_mesh")
    d["model"] = dict(defaults["model"], generator="cnn_blstm")
    d["train"] = dict(defaults["train"], trainer="wgan", epochs=1,
                      steps_per_epoch=QS_WGAN_STEPS, measures_every=1, checkpoint_every=1)
    cfg_path = _write_config(os.path.join(qs["root"], "config_mesh.json"), d)
    shutil.copytree(os.path.join(qs["cfg"]["workdir"], "feature_cache"),
                    os.path.join(workdir, "feature_cache"))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "percivaltts_tpu_torch.cli", "train", "--mesh", "--device-corpus",
           "--config", cfg_path]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                          timeout=MESH_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-12:]
    for line in tail:
        print(f"[mesh cli] | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"torch.distributed.run ... cli train --mesh exited {proc.returncode}")
    epochs, objective = _records(workdir, "epoch"), _records(workdir, "objective")
    ckpts = sorted(os.listdir(os.path.join(workdir, "checkpoints")))
    print(f"[mesh cli] ({card}) torchrun, 1 rank: {wall:.2f} s; "
          + "; ".join(f"epoch {r['epoch']}: {r['steps']} steps, loss {r['loss']:.6g}, wall "
                      f"{r['sec']:.3f} s" for r in epochs)
          + f"; objective records {len(objective)}; checkpoints {ckpts}")
    if len(epochs) != 1 or epochs[0]["steps"] != QS_WGAN_STEPS or not _finite(epochs[0]) \
            or len(objective) != 1 or ckpts != ["0"]:
        raise AssertionError("cli train --mesh did not write one epoch's records and checkpoint")
    cfg = Configuration.load(cfg_path)
    label_dir = os.path.join(cfg.data.corpus_dir, cfg.data.label_dir)
    labels = [os.path.join(label_dir, u + ".lab") for u in qs["corpus"].test.ids[:2]]
    out_dir = os.path.join(workdir, "synth")
    if cli.main(["synth", "--config", cfg_path, "--out", out_dir, *labels], device=dev) != 0:
        raise AssertionError("cli synth from the mesh run's checkpoint failed")
    wavs = [load_wav(os.path.join(out_dir, os.path.basename(p)[:-4] + ".wav"))[1] for p in labels]
    print(f"[mesh cli] cli synth served the checkpoint: {[len(w) for w in wavs]} samples")
    if not all(len(w) and np.isfinite(w).all() for w in wavs):
        raise AssertionError("cli synth wrote empty or non-finite wavs")
    return {"wall_s": wall, "record": epochs[0]}


def _wide_plans(dev, cell: str = "lstm") -> None:
    """The launch plans of the wide kernels at phase 13's (LSTM) or 14's
    (GRU) widths and rows: the cluster split of each must be
    ``ops/wide_layout.py::plan``'s, with at most one gate pair a thread.
    Printed: blocks a cluster, units a block, threads, batch rows a cluster,
    W_h in shared memory or L2, the clusters the card holds at once, the
    waves and the shared memory a block. The same for the f32 cluster BPTT
    (``wide_f32``) where it takes H: its split must be ``wide_layout``'s, its
    rows and resident chunks ``ops/wide_f32_layout.py::rows``'s (printed with
    the slice's resident, streamed and ring bytes); for the f32 cluster
    forward where it takes H, ``fwd_rows``'s (chunks in shared memory and in
    registers); and for the tensor-core
    kernels (``wide_mma``): the split of both must be
    ``ops/wide_mma_layout.py::plan``'s, the BPTT's rows ``rows``'s and the
    forward's (rows, tiles a warp, h buffers) ``fwd_rows``'s, B <= 32 in one
    wave at H = 512 (the forward's B = 160 too); then ``ptxas``'s registers
    and spills of every instantiation of the wide kernels, none of the
    tensor-core ones and none of the f32 cluster forwards spilling."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_f32_layout, wide_layout, wide_mma_layout

    lib = _build.library()
    gru = cell == "gru"
    gates = 3 if gru else 4
    shapes = sorted({(B, H) for _, B, H in (
        WIDE_GRU_FWD_SHAPES + WIDE_GRU_BWD_SHAPES if gru else WIDE_FWD_SHAPES + WIDE_BWD_SHAPES)
        + WIDE_TIMED + [ROUTE_SHAPE]})
    name = "bigru" if gru else "bilstm"
    for B, H in shapes:
        p = wide_layout.plan(H, 3 if gru else 4)
        for kind, fn in (("fwd", getattr(lib, f"percival_{name}_fwd_wide_plan")),
                         ("bwd", getattr(lib, f"percival_{name}_bwd_wide_plan"))):
            for dtype in (torch.float32, torch.bfloat16):
                out = (ctypes.c_int * 9)()
                _build.check(fn(B, H, p.Hb, p.U, 0 if dtype == torch.float32 else 1, out),
                             f"the wide {kind} plan at B={B} H={H}")
                U, Hb, NC, KS, NT, R, w_smem, clusters, smem = out
                if (U, Hb, NC, KS, NT) != tuple(p) or R * Hb > NT or clusters < 1:
                    raise AssertionError(f"the wide {name} {kind} plan {list(out)} is not {p}")
                print(f"[wide plan] {name} {kind} B={B} H={H} {str(dtype)[6:]}: {U} blocks of {Hb} "
                      f"units, {NT} threads, {R} rows a cluster, W_h in "
                      f"{'shared memory' if w_smem else 'L2'}, {clusters} clusters at once "
                      f"({-(-2 * -(-B // R) // clusters)} waves), {smem} B shared memory")
        if wide_f32_layout.fits(H, gates):
            _wide_f32_bwd_plan(lib, name, gates, B, H)
        if wide_f32_layout.fwd_fits(H, gates):
            Hp = wide_f32_layout.padded(H)
            pf = wide_layout.plan(Hp, gates)
            out = (ctypes.c_int * 9)()
            _build.check(getattr(lib, f"percival_{name}_fwd_wide_f32_plan")(B, Hp, pf.Hb, pf.U, out),
                         f"the f32 wide forward plan at B={B} H={Hp}")
            U, Hb, NC, R, nres, nreg, clusters, waves, smem = out
            rows = wide_f32_layout.fwd_rows(B, Hp, gates, clusters)
            if (U, Hb, NC) != (pf.U, pf.Hb, pf.NC) or (R, nres, nreg, waves, smem) != tuple(rows):
                raise AssertionError(f"the {name} forward wide_f32 plan {list(out)} is not {pf}, "
                                     f"{rows}")
            slot = wide_f32_layout.slot_bytes(NC)
            print(f"[wide plan] {name} fwd wide_f32 B={B} H={H} (run at {Hp}) f32: {U} blocks of "
                  f"{Hb} units, {wide_f32_layout.fwd_threads(Hp, gates)} threads, {R} rows a "
                  f"cluster, {clusters} clusters at once ({waves} waves), W_h slice "
                  f"{Hp * NC * 4} B: {nres} chunks in shared memory ({nres * slot} B), {nreg} in "
                  f"registers ({nreg * wide_f32_layout.CHUNK * NC * 4} B), {smem} B shared memory")
        if not wide_mma_layout.fits(H, gates):
            continue
        Hp = wide_mma_layout.padded(H)
        pm = wide_mma_layout.plan(Hp, gates)
        out = (ctypes.c_int * 9)()
        _build.check(getattr(lib, f"percival_{name}_bwd_wide_mma_plan")(B, Hp, pm.Hb, pm.U, out),
                     f"the tensor-core wide BPTT plan at B={B} H={Hp}")
        U, Hb, NC, R, MPW, clusters, waves, dbuf, smem = out
        rows = wide_mma_layout.rows(B, Hp, gates, clusters)
        if (U, Hb, NC) != tuple(pm) or (R, MPW, waves, dbuf, smem) != tuple(rows):
            raise AssertionError(f"the {name} wide_mma plan {list(out)} is not {pm}, {rows}")
        if B <= 32 and H == 512 and waves != 1:
            raise AssertionError(f"the {name} wide_mma plan runs B={B} in {waves} waves")
        print(f"[wide plan] {name} bwd wide_mma B={B} H={H} (run at {Hp}) bf16: {U} blocks of "
              f"{Hb} units, 512 threads, {R} rows a cluster ({MPW} dh tiles a warp), {clusters} "
              f"clusters at once ({waves} waves), {1 + dbuf} buffer(s) of partials, {smem} B "
              f"shared memory")
        out = (ctypes.c_int * 11)()
        _build.check(getattr(lib, f"percival_{name}_fwd_wide_mma_plan")(B, Hp, pm.Hb, pm.U, 0, out),
                     f"the tensor-core wide forward plan at B={B} H={Hp}")
        U, Hb, NC, R, TPW, WPG, KSP, clusters, waves, dbuf, smem = out
        rows = wide_mma_layout.fwd_rows(B, Hp, gates, clusters)
        if (U, Hb, NC) != tuple(pm) or (R, TPW, WPG, KSP, waves, dbuf, smem) != tuple(rows):
            raise AssertionError(f"the {name} forward wide_mma plan {list(out)} is not {pm}, {rows}")
        if (B <= 32 or B == 160) and H == 512 and waves != 1:
            raise AssertionError(f"the {name} forward wide_mma plan runs B={B} in {waves} waves")
        print(f"[wide plan] {name} fwd wide_mma B={B} H={H} (run at {Hp}) bf16: {U} blocks of "
              f"{Hb} units, 512 threads, {R} rows a cluster ({TPW} row tiles a warp, {WPG} warps "
              f"a unit group, K in {KSP} part(s)), {clusters} clusters at once ({waves} waves), "
              f"{1 + dbuf} h buffer(s), {smem} B shared memory")
    # registers and spills of every instantiation of the wide kernels: 0 spills
    # on "wide_mma" and on the wide_f32 forwards ("wide_mma_stream"'s: phase 17a)
    for line in _ptxas_usage(BUILD_LOG):
        if f"{name}_bwd_wide" in line or f"{name}_fwd_wide" in line:
            print(f"[wide ptxas] {line}")
            held = "wide_mma_kernel" in line or f"{name}_fwd_wide_f32" in line
            if held and not line.split("spill ")[1].startswith("0/0 "):
                raise AssertionError(f"a wide kernel instantiation spills: {line}")


def _wide_f32_clusters(lib, name: str, Hp: int) -> dict:
    """The clusters the card holds at once of each kernel of the f32 BPTT at
    width ``Hp`` (a multiple of 32), by R: its plan with R forced (an R that
    does not fit left out)."""
    import ctypes

    from percivaltts_tpu_torch.ops import wide_f32_layout, wide_layout

    pf = wide_layout.plan(Hp, 4 if name == "bilstm" else 3)
    out = {}
    for R in wide_f32_layout.FEW_ROWS + tuple(8 * nt for nt in wide_f32_layout.ROW_TILES):
        buf = (ctypes.c_int * 9)()
        if getattr(lib, f"percival_{name}_bwd_wide_f32_plan")(1, Hp, pf.Hb, pf.U, R, buf) == 0:
            out[R] = buf[6]
    return out


def _wide_f32_bwd_plan(lib, name: str, gates: int, B: int, H: int, rows: int = 0):
    """The f32 BPTT's launch plan at (B, H) (``rows``: R forced) against
    ``ops/wide_f32_layout.py::bwd_plan`` at the card's clusters by R: the
    split must be ``wide_layout``'s, the rows, chunks, waves and bytes the
    layout's; printed. Returns it."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_f32_layout, wide_layout

    Hp = wide_f32_layout.padded(H)
    pf = wide_layout.plan(Hp, gates)
    out = (ctypes.c_int * 9)()
    _build.check(getattr(lib, f"percival_{name}_bwd_wide_f32_plan")(B, Hp, pf.Hb, pf.U, rows, out),
                 f"the f32 wide BPTT plan at B={B} H={Hp} rows={rows}")
    plan = wide_f32_layout.BwdPlan(*out)
    want = wide_f32_layout.bwd_plan(B, Hp, gates, _wide_f32_clusters(lib, name, Hp), rows)
    if plan[:3] != (pf.U, pf.Hb, pf.NC) or (plan.R, plan.nres, plan.nstr, plan.waves,
                                             plan.smem) != tuple(want):
        raise AssertionError(f"the {name} wide_f32 plan {plan} is not {pf}, {want}")
    head = (f"[wide plan] {name} bwd wide_f32 B={B} H={H} (run at {Hp}) f32"
            + (f", R = {rows} forced" if rows else "") + f": {plan.U} blocks of {plan.Hb} units, ")
    if plan.R <= 4:
        print(head + f"few-row kernel, {wide_f32_layout.few_threads(Hp, gates)} threads, {plan.R} "
              f"rows a cluster, {plan.clusters} clusters at once ({plan.waves} waves), the W_h "
              f"slice ({Hp * plan.NC * 4} B) resident, {plan.smem} B shared memory")
    else:
        slot = wide_f32_layout.slot_bytes(plan.NC)
        ring = wide_f32_layout.RING if plan.nstr else 0
        print(head + f"chunked kernel, {wide_f32_layout.THREADS} threads, {plan.R} rows a cluster, "
              f"{plan.clusters} clusters at once ({plan.waves} waves), W_h slice "
              f"{Hp * plan.NC * 4} B: {plan.nres} chunks resident ({plan.nres * slot} B), "
              f"{plan.nstr} streamed a step ({plan.nstr * wide_f32_layout.CHUNK * plan.NC * 4} B) "
              f"through {ring} ring slots ({ring * slot} B), {plan.smem} B shared memory")
    return plan


def _few_plans(dev) -> None:
    """Phase 16a: the f32 BPTT's plan at every B up to 8 at the widths of
    ``F32_WIDE_KEPT`` and ``FEW_EDGES``, and at ``FEW_FORCED``'s forced rows,
    against ``wide_f32_layout.bwd_plan`` (``_wide_f32_bwd_plan``): the
    few-row kernels wherever one of their R fits; then ``ptxas``'s registers
    and spills of their instantiations (a spill fails)."""
    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_f32_layout

    lib = _build.library()
    for cell, gates, name in (("lstm", 4, "bilstm"), ("gru", 3, "bigru")):
        widths = {H for _, _, H in F32_WIDE_KEPT[cell] + FEW_EDGES[cell]}
        for H in sorted(widths):
            for B in range(1, 9):
                plan = _wide_f32_bwd_plan(lib, name, gates, B, H)
                fits = any(wide_f32_layout.few_fits(wide_f32_layout.padded(H), gates, R)
                           for R in wide_f32_layout.FEW_ROWS)
                if fits != (plan.R <= 4):
                    raise AssertionError(f"{name} at B={B} H={H}: plan R = {plan.R}")
        for _, B, H, R in FEW_FORCED[cell]:
            if _wide_f32_bwd_plan(lib, name, gates, B, H, rows=R).R != R:
                raise AssertionError(f"{name} at B={B} H={H} did not take R = {R}")
    for line in _ptxas_usage(BUILD_LOG):
        if "_few_kernel" in line:
            print(f"[few ptxas] {line}")
            if not line.split("spill ")[1].startswith("0/0 "):
                raise AssertionError(f"a few-row BPTT instantiation spills: {line}")


def _check_few_kernels(dev) -> dict:
    """Phase 16b: the f32 BPTTs through their entries (``bilstm_bwd`` /
    ``bigru_bwd``, route ``"wide_f32"``) at every row ``F32_WIDE_KEPT`` kept
    on ``"wide"`` before the few-row plan and at ``FEW_EDGES``, each launch
    counted on the few-row kernel, held against the twins within
    ``KERNEL_TOL[f32]``·max(1, max|twin|), with the ``"wide"`` kernel
    launched directly on the same inputs and held the same way; the few-row
    kernels also at ``FEW_FORCED``'s forced rows. Returns the largest
    |kernel − twin| of each: ``*_bwd_wide_f32_few``,
    ``*_bwd_wide_f32_few_earlier`` (``"wide"``)."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route

    f32 = torch.float32
    err = {}

    def hold(label, got, want):
        limit = KERNEL_TOL[f32] * max(1.0, max(w.abs().max().item() for w in want))
        return _compare(label, got, want, limit, relative=False)

    with torch.no_grad():
        for cell, m, name in (("lstm", lstm_cuda, "bilstm_bwd"), ("gru", gru_cuda, "bigru_bwd")):
            args_fn = _gru_bwd_args if cell == "gru" else _bwd_args
            wrapper, twin = getattr(m, name), getattr(m, f"{name}_reference")
            few, earlier = f"{name}_wide_f32_few", f"{name}_wide_f32_few_earlier"
            err[few] = err[earlier] = 0.0
            for T, B, H in F32_WIDE_KEPT[cell] + FEW_EDGES[cell]:
                route = bwd_route(f32, H, cell)
                if route != "wide_f32":
                    raise AssertionError(f"{name} routes f32 B={B} H={H} to {route!r}")
                args = args_fn(T, B, H, f32, dev, seed=T + B + H)
                want = twin(*args)
                tag = f"T={T} B={B} H={H} f32"
                before = wrapper.wide_f32_plans["few"]
                got = _launch_once(wrapper, *args, route=route)
                if wrapper.wide_f32_plans["few"] != before + 1:
                    raise AssertionError(f"{name} at {tag} did not launch the few-row kernel")
                err[few] = max(err[few], hold(f"[{name} wide_f32 few-row] {tag}", got, want))
                got = m.bwd_launch("wide", *args)  # the kernel it replaced, uncounted
                torch.cuda.synchronize()
                err[earlier] = max(err[earlier],
                                   hold(f"[{name} wide, launched directly] {tag}", got, want))
            for T, B, H, R in FEW_FORCED[cell]:
                args = args_fn(T, B, H, f32, dev, seed=T + B + H + R)
                got = m.bwd_launch("wide_f32", *args, rows=R)
                torch.cuda.synchronize()
                err[few] = max(err[few], hold(f"[{name} wide_f32 few-row, R = {R} forced] T={T} "
                                              f"B={B} H={H} f32", got, twin(*args)))
    return err


def _few_models_path(dev, card: str) -> dict:
    """Phase 16c: ``FEW_MODELS`` served and trained at ``FEW_TRAIN_B`` rows
    (``_cluster_models_path`` at ``FEW_DEPTH``), every BPTT launch of the
    steps on the few-row kernels."""
    global TRAIN_B
    saved, TRAIN_B = TRAIN_B, FEW_TRAIN_B
    try:
        runs = _cluster_models_path(dev, card, FEW_MODELS, depth=FEW_DEPTH)
    finally:
        TRAIN_B = saved
    for kind, run in runs.items():
        name = f"{'bigru' if _is_gru(kind) else 'bilstm'}_bwd"
        n, few = run["train"]["counts"][name], run["train"]["plans"][name]["few"]
        print(f"[few] ({card}) {kind} at B = {FEW_TRAIN_B}: {few} of {n} BPTT launches on the "
              "few-row kernels")
        if not n or few != n:
            raise AssertionError(f"train {kind}: {few} of {n} BPTT launches on the few-row kernels")
    return runs


def _narrow_plans(dev) -> dict:
    """Phase 15a: the f32 narrow cluster kernels' launch plans at the widths
    and rows of phases 3, 15 and the route tables, against
    ``ops/narrow_f32_layout.py::plan`` (the BPTTs) and ``::fwd_plan`` (the
    forwards, whose W_h may stay in registers) replayed at the card's
    clusters of each split (the launchers' plan with that split forced);
    printed with the blocks, units, rows, waves and bytes; then ``ptxas``'s
    registers and spills of every instantiation (a forward's spill fails).
    Returns the card's clusters by cell and U, and the forwards' by cell."""
    from percivaltts_tpu_torch.ops import lstm_cuda
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    shapes = {(B, H) for _, B, H in BWD_SHAPES + F32_SIMT_TIMED + KERNEL_SHAPES}
    shapes |= {(B, 128) for B in F32_NARROW_BATCHES}
    shapes |= {(B, H) for _, (_, B, H), _ in NARROW_FWD_FORCED}
    clusters, fwd_clusters = {}, {}
    for cell, gates, name in (("lstm", 4, "bilstm"), ("gru", 3, "bigru")):
        card, fcard = clusters.setdefault(cell, {}), fwd_clusters.setdefault(cell, {})
        widths = shapes | {(B, nf.MAX_H[gates]) for B in (1, 32, 160)}
        widths |= {(B, H) for H in F32_NARROW_WIDTHS[cell] for B in F32_NARROW_BATCHES}
        for B, H in sorted(widths):
            Hp = nf.padded(H)
            for s, R, _ in nf.candidates(Hp, gates):
                if s.U not in card:
                    card[s.U] = lstm_cuda.narrow_f32_plan(name, 1, Hp, s.U, R).clusters
            for s, R, _ in nf.candidates(Hp, gates, fwd=True):
                if s.U not in fcard:
                    fcard[s.U] = lstm_cuda.narrow_f32_fwd_plan(name, 1, Hp, s.U, R, 0).clusters
            if nf.reg_fits(Hp, gates) and "resident" not in fcard:
                fcard["resident"] = lstm_cuda.narrow_f32_fwd_plan(name, 1, Hp, 1, 1, 1).clusters
            for kind, got, want in (
                    ("bwd", lstm_cuda.narrow_f32_plan(name, B, Hp), nf.plan(B, Hp, gates, card)),
                    ("fwd", lstm_cuda.narrow_f32_fwd_plan(name, B, Hp),
                     nf.fwd_plan(B, Hp, gates, fcard))):
                if got != want:
                    raise AssertionError(f"the {name} {kind} narrow_f32 plan at B={B} H={Hp}: "
                                         f"{got}, the layout's {want}")
                where = ("W_h in registers, " if kind == "fwd" and got.resident else
                         f"{got.U} blocks of {got.Hb} units ({got.NC} gate columns, {got.NCP} "
                         "with padding), ")
                print(f"[narrow plan] {name} {kind} narrow_f32 B={B} H={H} (run at {Hp}) f32: "
                      f"{where}{got.R} rows a cluster, {got.clusters} clusters at once "
                      f"({got.waves} waves), {got.smem} B shared memory")
        print(f"[narrow plan] {name}: clusters the card holds at once by blocks a cluster, BPTT "
              f"{card}, forward {fcard}")
    for line in _ptxas_usage(BUILD_LOG):
        if "_narrow_f32" in line:
            print(f"[narrow ptxas] {line}")
            if "_fwd_narrow_f32" in line and not line.split("spill ")[1].startswith("0/0 "):
                raise AssertionError(f"a narrow forward instantiation spills: {line}")
    return {"bwd": clusters, "fwd": fwd_clusters}


def _route_times(m, fargs, bargs) -> dict:
    """ROUTE_SHAPE in bf16: the one-block, cluster and tensor-core cluster
    forwards and BPTTs, each timed in turns (a, b, c, c, b, a: the mean of 2
    medians each) on the same inputs."""
    ms = {}
    for kind, launch, args, routes in (("fwd", m.fwd_launch, fargs, ("simt", "wide", "wide_mma")),
                                       ("bwd", m.bwd_launch, bargs, ("simt", "wide", "wide_mma"))):
        for r in routes + routes[::-1]:
            ms.setdefault(f"{kind}_{r}_ms", []).append(
                _median_ms(lambda: launch(r, *args), runs=5, inner=3))
    return {k: statistics.mean(v) for k, v in ms.items()}


def _wide_bwd_key(name: str, route: str, bf16: bool):
    """The key of ``_check_wide_kernels`` / ``_check_wide_gru_kernels``'
    error table for a cluster BPTT route in bf16 or f32, None for the
    others: the f32 cluster BPTT is ``*_bwd_wide_f32``, the CUDA-core one in
    f32 ``*_bwd_wide_f32_earlier``."""
    if bf16:
        return f"{name}{WIDE_BWD_KEYS[route]}" if route in WIDE_BWD_KEYS else None
    return {"wide_f32": f"{name}_bwd_wide_f32", "wide": f"{name}_bwd_wide_f32_earlier"}.get(route)


def _wide_fwd_route(dtype, H: int, cell: str, B: int) -> str:
    """The route of a forward of ``B`` rows that one block cannot hold: bf16
    on the tensor-core cluster kernels, f32 up to H = 512 on the f32 cluster
    kernels (``"wide_f32"``) but at the rows ``mma_layout.F32_WIDE_FWD``
    keeps, there and past H = 512 on the CUDA-core ones (``"wide"``)."""
    from percivaltts_tpu_torch.ops import wide_f32_layout
    from percivaltts_tpu_torch.ops.mma_layout import F32_WIDE_FWD

    if dtype == torch.bfloat16:
        return "wide_mma"
    kept = any(H <= h and B <= b for h, b in F32_WIDE_FWD[cell])
    return "wide_f32" if wide_f32_layout.fits(H, 3 if cell == "gru" else 4) and not kept else "wide"


def _wide_fwd_key(name: str, route: str, dtype) -> str:
    """The key of ``_check_wide_kernels`` / ``_check_wide_gru_kernels``' error
    table for a cluster forward: bf16 ``*_fwd_wide_mma`` and ``*_fwd`` (the
    CUDA-core one); f32 ``*_fwd_wide_f32`` and ``*_fwd_wide_f32_earlier``
    (the CUDA-core one in f32)."""
    if dtype == torch.bfloat16:
        return f"{name}_fwd_wide_mma" if route == "wide_mma" else f"{name}_fwd"
    return f"{name}_fwd_wide_f32" + ("" if route == "wide_f32" else "_earlier")


def _check_wide_kernels(dev) -> dict:
    """Phase 13a: both wide kernels against their twins (forward with and
    without cells, BPTT, the autograd pair), each launch counted on its
    route; H = 256 on the route that takes it, and in bf16 the one-block
    kernels against the cluster ones there (checked and timed). The f32
    BPTT runs on its route (``bwd_route``: ``wide_f32``, or ``wide`` at few
    rows where that measured faster) and the other of the two cluster
    kernels, launched directly, on the same inputs, wherever ``wide_f32``
    takes H, the fakes pass's (512, 160, 512) included; the f32 forward as
    well (``fwd_route``: ``wide_f32`` up to H = 512, beside the CUDA-core
    cluster forward it replaced there). Returns the largest bf16 |kernel −
    twin| of each wrapper, the largest f32 one of the f32 cluster forward
    (``*_fwd_wide_f32``), of the CUDA-core cluster forward in f32
    (``*_fwd_wide_f32_earlier``), of the f32 cluster BPTT
    (``*_bwd_wide_f32``) and of the CUDA-core cluster BPTT in f32
    (``*_bwd_wide_f32_earlier``), and the route timings."""
    from percivaltts_tpu_torch.ops import lstm_cuda as l
    from percivaltts_tpu_torch.ops import wide_f32_layout
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    bf16 = torch.bfloat16
    err = {"bilstm_fwd": 0.0, "bilstm_fwd_wide_mma": 0.0, "bilstm_bwd": 0.0,
           "bilstm_bwd_wide_mma": 0.0, "bilstm_fwd_wide_f32": 0.0, "bilstm_bwd_wide_f32": 0.0,
           "bilstm_fwd_wide_f32_earlier": 0.0, "bilstm_bwd_wide_f32_earlier": 0.0}
    with torch.no_grad():
        for T, B, H in WIDE_FWD_SHAPES:
            for dtype, tol in KERNEL_TOL.items():
                route = fwd_route(dtype, H, "lstm", B)
                if route != _wide_fwd_route(dtype, H, "lstm", B):
                    raise AssertionError(f"H={H} {dtype} takes the {route} route")
                args = _gates(T, B, H, dtype, dev, seed=T + B)
                want = l.bilstm_fwd_reference(*args, with_cells=True)
                tag = f"T={T} B={B} H={H} {str(dtype)[6:]}"
                for cells in (False, True):
                    got = _launch_once(l.bilstm_fwd, *args, with_cells=cells, route=route)
                    e = _compare(f"[bilstm_fwd {route}] {tag} cells={cells}", got,
                                 want[:len(got)], tol, relative=False)
                    key = _wide_fwd_key("bilstm", route, dtype)
                    err[key] = max(err[key], e)
                    if route != "wide":
                        # the CUDA-core cluster kernel on the same inputs, launched directly
                        got = l.fwd_launch("wide", *args, with_cells=cells)
                        torch.cuda.synchronize()
                        e = _compare(f"[bilstm_fwd wide, launched directly] {tag} cells={cells}",
                                     got, want[:len(got)], tol, relative=False)
                        key = _wide_fwd_key("bilstm", "wide", dtype)
                        err[key] = max(err[key], e)
        for T, B, H in WIDE_BWD_SHAPES + [WIDE_MMA_SHAPE]:
            for dtype, tol in BWD_TOL.items():
                rel, route = dtype == bf16, bwd_route(dtype, H, "lstm")
                if (T, B, H) == WIDE_MMA_SHAPE and route not in ("wide_mma", "wide_f32"):
                    continue
                args = _bwd_args(T, B, H, dtype, dev, seed=T + B)
                want = l.bilstm_bwd_reference(*args)
                tag = f"T={T} B={B} H={H} {str(dtype)[6:]}"
                got = _launch_once(l.bilstm_bwd, *args, route=route)
                e = _compare(f"[bilstm_bwd {route}] {tag}", got, want, tol, rel)
                key = _wide_bwd_key("bilstm", route, rel)
                if key:
                    err[key] = max(err[key], e)
                # the dtype's other cluster kernels on the same inputs,
                # launched directly (uncounted)
                for other in ("wide", "wide_mma") if rel else ("wide", "wide_f32"):
                    if other == route or (other == "wide_f32" and not wide_f32_layout.fits(H)):
                        continue
                    got = l.bwd_launch(other, *args)
                    torch.cuda.synchronize()
                    e = _compare(f"[bilstm_bwd {other}, launched directly] {tag}", got, want, tol,
                                 rel)
                    key = _wide_bwd_key("bilstm", other, rel)
                    err[key] = max(err[key], e)

        # H = 256 on the route that takes it; in bf16 the one-block kernels too
        T, B, H = ROUTE_SHAPE
        timed = {}
        for dtype, tol in KERNEL_TOL.items():
            route = fwd_route(dtype, H)
            fargs = _gates(T, B, H, dtype, dev, seed=5)
            bargs = _bwd_args(T, B, H, dtype, dev, seed=5)
            fwant = l.bilstm_fwd_reference(*fargs, with_cells=True)
            bwant = l.bilstm_bwd_reference(*bargs)
            tag = f"T={T} B={B} H={H} {str(dtype)[6:]}"
            _compare(f"[bilstm_fwd {route}] {tag}",
                     _launch_once(l.bilstm_fwd, *fargs, with_cells=True, route=route), fwant,
                     tol, relative=False)
            broute = bwd_route(dtype, H)
            _compare(f"[bilstm_bwd {broute}] {tag}",
                     _launch_once(l.bilstm_bwd, *bargs, route=broute), bwant, BWD_TOL[dtype],
                     dtype == bf16)
            if dtype != bf16:
                continue
            for other in ("simt", "wide", "wide_mma"):
                _compare(f"[bilstm_fwd {other}, launched directly] {tag}",
                         l.fwd_launch(other, *fargs, with_cells=True), fwant, tol, relative=False)
            for other in ("simt", "wide", "wide_mma"):
                _compare(f"[bilstm_bwd {other}, launched directly] {tag}",
                         l.bwd_launch(other, *bargs), bwant, BWD_TOL[dtype], True)
            timed = _route_times(l, fargs, bargs)
            print(f"[time] ROUTE {tag}: forward one-block {timed['fwd_simt_ms']:.4f} ms, cluster "
                  f"{timed['fwd_wide_ms']:.4f} ms, tensor-core cluster "
                  f"{timed['fwd_wide_mma_ms']:.4f} ms; BPTT one-block {timed['bwd_simt_ms']:.4f} ms, "
                  f"cluster {timed['bwd_wide_ms']:.4f} ms, tensor-core cluster "
                  f"{timed['bwd_wide_mma_ms']:.4f} ms (each the mean of 2 medians, in turns); "
                  f"routed: {fwd_route(dtype, H)}, BPTT {broute}")

    # the autograd pair: forward kernel + BPTT kernel against the twins
    T, B, H = WIDE_AUTOGRAD_SHAPE
    for dtype, tol in BWD_TOL.items():
        base = _gates(T, B, H, dtype, dev, seed=7)
        dy = _dy(T, B, H, dtype, dev, seed=1)
        grads = []
        froute, broute = fwd_route(dtype, H), bwd_route(dtype, H, "lstm")
        for c in (l.bilstm_core, l.bilstm_core_reference):
            leaves = [t.clone().requires_grad_(True) for t in base]
            f0, b0 = l.bilstm_fwd.routes[froute], l.bilstm_bwd.routes[broute]
            torch.autograd.backward(c(*leaves), dy)
            torch.cuda.synchronize()
            grads.append([t.grad for t in leaves])
            moved = (l.bilstm_fwd.routes[froute] - f0, l.bilstm_bwd.routes[broute] - b0)
            if c is l.bilstm_core and moved != (1, 1):
                raise RuntimeError(f"the wide autograd pair did not launch one forward on {froute} "
                                   f"and one BPTT on {broute}")
        for name, gk, gt in zip(("dgx_f", "dgx_b", "dW_h_f", "dW_h_b"), *grads):
            scale = gt.float().abs().max().item()
            limit = tol * scale if dtype == bf16 else tol * max(1.0, scale)
            _compare(f"[autograd BiLSTM, forward {froute}, BPTT {broute}] {name} "
                     f"T,B,H={WIDE_AUTOGRAD_SHAPE} "
                     f"{str(dtype)[6:]}", [gk], [gt], limit, relative=False)
    return {"err": err, "route_ms": timed}


def _check_wide_gru_kernels(dev) -> dict:
    """Phase 14a: both wide GRU kernels against their twins (forward, BPTT,
    the autograd pair), each launch counted on its route; the BPTT at H =
    100 on its entry's route and on the cluster kernel launched directly;
    H = 256 on the route that takes it, and in bf16 the one-block kernels
    against the cluster ones there (checked and timed in turns). The f32
    forward and BPTT as in phase 13a. Returns the largest bf16 |kernel −
    twin| of each wrapper, the largest f32 one of the f32 cluster forward,
    the CUDA-core cluster forward in f32 (keys as ``_wide_fwd_key``), the f32
    cluster BPTT and the CUDA-core cluster BPTT in f32 (keys as
    ``_wide_bwd_key``) and the route timings."""
    from percivaltts_tpu_torch.ops import gru_cuda as g
    from percivaltts_tpu_torch.ops import wide_f32_layout
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    bf16 = torch.bfloat16
    err = {"bigru_fwd": 0.0, "bigru_fwd_wide_mma": 0.0, "bigru_bwd": 0.0,
           "bigru_bwd_wide_mma": 0.0, "bigru_fwd_wide_f32": 0.0, "bigru_bwd_wide_f32": 0.0,
           "bigru_fwd_wide_f32_earlier": 0.0, "bigru_bwd_wide_f32_earlier": 0.0}

    def hold_bwd(label, got, want, dtype, route=None):
        rel = dtype == bf16
        e = max(_compare(f"{label} {what}", got[sl], want[sl], BWD_TOL[dtype], rel)
                for what, sl in (("dgx", slice(0, 2)), ("dnr", slice(2, 4))))
        key = _wide_bwd_key("bigru", route, rel) if route else None
        if key:
            err[key] = max(err[key], e)

    with torch.no_grad():
        for T, B, H in WIDE_GRU_FWD_SHAPES:
            for dtype, tol in KERNEL_TOL.items():
                route = fwd_route(dtype, H, "gru", B)
                if route != _wide_fwd_route(dtype, H, "gru", B):
                    raise AssertionError(f"H={H} {dtype} takes the GRU's {route} route")
                args = _gru_gates(T, B, H, dtype, dev, seed=T + B)
                want = g.bigru_fwd_reference(*args)
                tag = f"T={T} B={B} H={H} {str(dtype)[6:]}"
                got = _launch_once(g.bigru_fwd, *args, route=route)
                e = _compare(f"[bigru_fwd {route}] {tag}", got, want, tol, relative=False)
                key = _wide_fwd_key("bigru", route, dtype)
                err[key] = max(err[key], e)
                if route != "wide":
                    # the CUDA-core cluster kernel on the same inputs, launched directly
                    got = g.fwd_launch("wide", *args)
                    torch.cuda.synchronize()
                    e = _compare(f"[bigru_fwd wide, launched directly] {tag}", got, want, tol,
                                 relative=False)
                    key = _wide_fwd_key("bigru", "wide", dtype)
                    err[key] = max(err[key], e)
        for T, B, H in WIDE_GRU_BWD_SHAPES + [WIDE_MMA_SHAPE]:
            for dtype in BWD_TOL:
                route = bwd_route(dtype, H, "gru")
                if (T, B, H) == WIDE_MMA_SHAPE and route not in ("wide_mma", "wide_f32"):
                    continue
                args = _gru_bwd_args(T, B, H, dtype, dev, seed=T + B)
                want = g.bigru_bwd_reference(*args)
                tag = f"T={T} B={B} H={H} {str(dtype)[6:]}"
                hold_bwd(f"[bigru_bwd {route}] {tag}",
                         _launch_once(g.bigru_bwd, *args, route=route), want, dtype, route)
                # the dtype's other cluster kernels on the same inputs,
                # launched directly (uncounted)
                for other in ("wide", "wide_mma") if dtype == bf16 else ("wide", "wide_f32"):
                    if other == route or (other == "wide_f32" and not wide_f32_layout.fits(H, 3)):
                        continue
                    got = g.bwd_launch(other, *args)
                    torch.cuda.synchronize()
                    hold_bwd(f"[bigru_bwd {other}, launched directly] {tag}", got, want, dtype,
                             other)

        # H = 256 on the route that takes it; in bf16 the one-block kernels too
        T, B, H = ROUTE_SHAPE
        timed = {}
        for dtype, tol in KERNEL_TOL.items():
            route = fwd_route(dtype, H, "gru")
            fargs = _gru_gates(T, B, H, dtype, dev, seed=5)
            bargs = _gru_bwd_args(T, B, H, dtype, dev, seed=5)
            fwant, bwant = g.bigru_fwd_reference(*fargs), g.bigru_bwd_reference(*bargs)
            tag = f"T={T} B={B} H={H} {str(dtype)[6:]}"
            _compare(f"[bigru_fwd {route}] {tag}", _launch_once(g.bigru_fwd, *fargs, route=route),
                     fwant, tol, relative=False)
            broute = bwd_route(dtype, H, "gru")
            hold_bwd(f"[bigru_bwd {broute}] {tag}",
                     _launch_once(g.bigru_bwd, *bargs, route=broute), bwant, dtype)
            if dtype != bf16:
                continue
            for other in ("simt", "wide", "wide_mma"):
                _compare(f"[bigru_fwd {other}, launched directly] {tag}",
                         g.fwd_launch(other, *fargs), fwant, tol, relative=False)
            for other in ("simt", "wide", "wide_mma"):
                hold_bwd(f"[bigru_bwd {other}, launched directly] {tag}",
                         g.bwd_launch(other, *bargs), bwant, dtype)
            timed = _route_times(g, fargs, bargs)
            print(f"[time] GRU ROUTE {tag}: forward one-block {timed['fwd_simt_ms']:.4f} ms, "
                  f"cluster {timed['fwd_wide_ms']:.4f} ms, tensor-core cluster "
                  f"{timed['fwd_wide_mma_ms']:.4f} ms; BPTT one-block "
                  f"{timed['bwd_simt_ms']:.4f} ms, cluster {timed['bwd_wide_ms']:.4f} ms, "
                  f"tensor-core cluster {timed['bwd_wide_mma_ms']:.4f} ms (each the mean of 2 "
                  f"medians, in turns); routed: {fwd_route(dtype, H, 'gru')}, BPTT {broute}")

    # the autograd pair: forward kernel + BPTT kernel against the twins
    T, B, H = WIDE_AUTOGRAD_SHAPE
    for dtype, tol in BWD_TOL.items():
        base = _gru_gates(T, B, H, dtype, dev, seed=7)
        dy = _dy(T, B, H, dtype, dev, seed=1)
        grads = []
        froute, broute = fwd_route(dtype, H, "gru"), bwd_route(dtype, H, "gru")
        for c in (g.bigru_core, g.bigru_core_reference):
            leaves = [t.clone().requires_grad_(True) for t in base]
            f0, b0 = g.bigru_fwd.routes[froute], g.bigru_bwd.routes[broute]
            torch.autograd.backward(c(*leaves), dy)
            torch.cuda.synchronize()
            grads.append([t.grad for t in leaves])
            moved = (g.bigru_fwd.routes[froute] - f0, g.bigru_bwd.routes[broute] - b0)
            if c is g.bigru_core and moved != (1, 1):
                raise RuntimeError(f"the wide GRU autograd pair did not launch one forward on "
                                   f"{froute} and one BPTT on {broute}")
        names = ("dgx_f", "dgx_b", "dW_h_f", "dW_h_b", "db_hn_f", "db_hn_b")
        for name, gk, gt in zip(names, *grads):
            scale = gt.float().abs().max().item()
            limit = tol * scale if dtype == bf16 else tol * max(1.0, scale)
            _compare(f"[autograd BiGRU, forward {froute}, BPTT {broute}] {name} "
                     f"T,B,H={WIDE_AUTOGRAD_SHAPE} "
                     f"{str(dtype)[6:]}", [gk], [gt], limit, relative=False)
    return {"err": err, "route_ms": timed}


def _time_wide_kernels(dev, cell: str = "lstm") -> dict:
    """Phase 13's (LSTM) or 14's (GRU) timings: each wide kernel at the
    serving chunk, the generator update and the fakes pass (bf16), beside
    its twin, its bound and cuDNN's bidirectional ``nn.LSTM`` / ``nn.GRU``
    (``hidden_size=H``; forward, the BPTT beside its backward) on the same
    input, the layers by CUDA events and by device time (``_layer_times``),
    each kernel also by its own device time (``kernel_device_ms``). The bf16
    route of each (``fwd_route`` / ``bwd_route``: ``"wide_mma"``) is timed
    in turns with the CUDA-core cluster kernel it replaced (``"wide"``,
    launched through ``fwd_launch`` / ``bwd_launch``) on the same inputs:
    earlier, routed, routed, earlier; where ``FWD_ALT_ROWS`` names another
    forward plan (the LSTM at B = 160 on R = 40: two h buffers in two waves,
    against the plan's R = 56 with one buffer in one wave), that too, in
    the same turns. (The replaced kernel's and the port's layer on it by
    device time stand in ``PERF.md``'s kernel table; the CUDA-core cluster
    kernels are timed in f32, the route they serve, by ``_time_wide_f32``.)"""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    cls = "nn.GRU" if gru else "nn.LSTM"
    dt = torch.bfloat16
    out = {}
    for name in (("bigru_fwd", "bigru_bwd") if gru else ("bilstm_fwd", "bilstm_bwd")):
        fwd = name.endswith("fwd")
        rows = []
        for T, B, H in WIDE_TIMED:
            route = (fwd_route if fwd else bwd_route)(dt, H, cell)
            launch = m.fwd_launch if fwd else m.bwd_launch
            alt = FWD_ALT_ROWS.get((cell, B)) if fwd else None
            if fwd:
                args = (_gru_gates if gru else _gates)(T, B, H, dt, dev, seed=1)
            else:
                args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, dt, dev, seed=1)
            kern = getattr(m, name)
            twin = getattr(m, f"{name}_reference")
            layer = m.bigru if gru else m.bilstm
            row = {"shape": [T, B, H], "route": route}
            with torch.no_grad():
                if route == "wide":
                    ms = _median_ms(lambda: kern(*args), runs=5, inner=3)
                else:  # in turns with the kernel it replaced (and another plan's rows)
                    turns = [("wide", 0), (route, 0)] + ([(route, alt)] if alt else [])
                    times = {t: [] for t in turns}
                    for r, nr in turns + turns[::-1]:
                        kw = {"rows": nr} if nr else {}
                        times[(r, nr)].append(_median_ms(lambda: launch(r, *args, **kw), runs=5,
                                                         inner=3))
                    ms = statistics.mean(times[(route, 0)])
                    row["earlier_ms"] = statistics.mean(times[("wide", 0)])
                    if alt:
                        row[f"rows_{alt}_ms"] = statistics.mean(times[(route, alt)])
                row["kernel_device_ms"] = _device_ms(lambda: kern(*args), calls=3,
                                                     match=f"{name}_{route}_kernel")
                # the twins loop over T in Python (~1 s a call): timed once, and not
                # at the fakes pass
                plain_ms = _once_ms(lambda: twin(*args)) if B <= 32 else None
            ws = _layer_weights(cell, H, dt, dev, seed=2)
            x = torch.from_numpy(np.random.default_rng(3).normal(size=(B, T, LAYER_IN))
                                 .astype(np.float32)).to(device=dev, dtype=dt)
            flat = [t for d in ws for t in d]
            with _compact_weights():
                lt = _layer_times(layer, _library_layer(cell, ws, dt, dev), x, flat, fwd, runs=5,
                                  inner=3)
            bound_ms, bound_by = _kernel_bound(name, T, B, H, dt)
            row.update({"ms": ms, "us_per_step": ms / T * 1e3, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, **lt})
            rows.append(row)
            if None not in (lt["layer_device_ms"], row["kernel_device_ms"]) and \
                    lt["layer_device_ms"] < row["kernel_device_ms"]:
                print(f"[time] {name} T,B,H={(T, B, H)}: the layer's trace lost the kernel's "
                      "events (its device time is under the kernel's): not a measurement")
            earlier = (f"; the earlier CUDA-core cluster kernel on the same inputs "
                       f"{row['earlier_ms']:.4f} ms ({row['earlier_ms'] / T * 1e3:.3f} us a step), "
                       f"{row['earlier_ms'] / ms:.2f}x "
                       f"(means of 2 medians, in turns)" if "earlier_ms" in row else "")
            if alt:
                earlier += (f"; the plan's rows against R = {alt}: {ms:.4f} against "
                            f"{row[f'rows_{alt}_ms']:.4f} ms")
            print(f"[time] {name} {route} T,B,H={(T, B, H)} bf16: kernel {ms:.4f} ms "
                  f"({ms / T * 1e3:.3f} us a step; {row['kernel_device_ms']} device ms){earlier}; "
                  f"plain twin {plain_ms} ms, bound {bound_ms:.5f} ms ({bound_by}); "
                  f"layer{'' if fwd else ' backward'}: port {lt['layer_ms']:.4f} ms, cuDNN "
                  f"{cls}(hidden_size={H}, bidirectional=True) {lt['library_ms']:.4f} ms (medians, "
                  f"CUDA events); device time port {lt['layer_device_ms']} ms, cuDNN "
                  f"{lt['library_device_ms']} ms, cuDNN/port "
                  f"{_ratio(lt['library_device_ms'], lt['layer_device_ms'])}")
        out[name] = rows
    return out


def _once_ms(fn) -> float:
    """The CUDA-event time of one call of ``fn``, with no warm-up (for the
    twins, which loop over T in Python: ~1 s a call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _in_turns(calls: dict, order, once=()) -> dict:
    """The mean time in ms of each of ``calls`` (name → function) timed in
    ``order`` (e.g. earlier, kernel, twin, kernel, earlier): a call named
    ``"twin"`` or in ``once`` (the kernels of seconds a call) by one call a
    turn with no warm-up (``_once_ms``), any other as the median of 5 calls
    (``_median_ms``)."""
    times = {who: [] for who in calls}
    for who in order:
        fn = calls[who]
        times[who].append(_once_ms(fn) if who == "twin" or who in once else _median_ms(fn, runs=5))
    return {who: statistics.mean(t) for who, t in times.items()}


# the f32 kernel each f32 cluster route replaced at its widths: the BPTT's
# "wide_f32" the "wide" one, "narrow_f32" the one-block kernels ("simt"),
# forward and BPTT
EARLIER_F32 = {"wide_f32": "wide", "narrow_f32": "simt"}


def _time_wide_f32(dev, cell: str = "lstm", shapes=None, route: str = "wide_f32",
                   what=("fwd", "bwd")) -> dict:
    """Phases 13d / 14d: the kernels that f32 takes at ``shapes``
    (``WIDE_TIMED`` by default), whose forward must take ``route``: past
    H = 256 (LSTM) / 320 (GRU) the f32 cluster forward and BPTT
    (``"wide_f32"``; the BPTT's route is ``bwd_route``'s), each in turns with
    the CUDA-core cluster kernel it replaced (``"wide"``) and the twin
    (earlier, routed, twin, routed, earlier; the kernels' medians of 5
    calls, the twin's one call, ``_in_turns``; a BPTT row records its plan's
    rows, R <= 4 the few-row kernels); with ``route="narrow_f32"``
    (phase 15d, ``python3 chip_smoke.py --f32-times``) the forward and the
    BPTT on ``"narrow_f32"``, each in turns with the one-block kernel it
    replaced (``"simt"``); a route with no earlier kernel (``"wide"``) in
    turns with its twin alone (kernel, twin, kernel). ``what``: the
    kernels timed (``"fwd"``, ``"bwd"``). Each row beside the
    bound at the f32 rate and cuDNN's bidirectional ``nn.LSTM`` / ``nn.GRU``
    in f32 (TF32 off, as ``main`` sets it) by CUDA events and by device time
    (``_layer_times``: medians of 2 × 3 calls, device time over 3 calls), and
    the kernel also by its own device time. A port layer's device
    time under half its kernel's time is a trace that lost the kernel's
    events (the cluster kernels' now and then; the kernel is nearly all of
    its layer): it is printed as such and kept as None, not measured."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda, wide_f32_layout
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: cuDNN's f32 layer would not compute in f32")
    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    cls = "nn.GRU" if gru else "nn.LSTM"
    dt = torch.float32
    out = {}
    for name in (f"{'bigru' if gru else 'bilstm'}_{w}" for w in what):
        fwd = name.endswith("fwd")
        rows = []
        for T, B, H in shapes or WIDE_TIMED:
            taken = fwd_route(dt, H, cell, B) if fwd else bwd_route(dt, H, cell)
            # a BPTT may be asked on the kernel its route replaced
            if taken != route and (fwd or (taken != EARLIER_F32.get(route)
                                           and EARLIER_F32.get(taken) != route)):
                raise AssertionError(f"{name} routes f32 at H = {H} to {taken!r}, not {route!r}")
            if fwd:
                args = (_gru_gates if gru else _gates)(T, B, H, dt, dev, seed=1)
            else:
                args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, dt, dev, seed=1)
            kern, twin = getattr(m, name), getattr(m, f"{name}_reference")
            calls = {"kernel": lambda: kern(*args), "twin": lambda: twin(*args)}
            turns = ("kernel", "twin", "kernel")
            earlier = EARLIER_F32.get(taken)
            if earlier:  # the route's kernel in turns with the one it replaced
                launch = m.fwd_launch if fwd else m.bwd_launch
                calls["earlier"] = lambda: launch(earlier, *args)
                turns = ("earlier", "kernel", "twin", "kernel", "earlier")
            with torch.no_grad():
                times = _in_turns(calls, turns)
                kernel_device_ms = _device_ms(lambda: kern(*args), calls=3,
                                              match=f"{name}_{taken}")
            ws = _layer_weights(cell, H, dt, dev, seed=2)
            x = torch.from_numpy(np.random.default_rng(3).normal(size=(B, T, LAYER_IN))
                                 .astype(np.float32)).to(dev)
            with _compact_weights():
                lt = _layer_times(m.bigru if gru else m.bilstm, _library_layer(cell, ws, dt, dev),
                                  x, [t for d in ws for t in d], fwd, runs=2, inner=3)
            ms, plain_ms = times["kernel"], times["twin"]
            if lt["layer_device_ms"] is not None and lt["layer_device_ms"] < 0.5 * ms:
                print(f"[time] {name} {taken} T,B,H={(T, B, H)} f32: the layer's trace lost the "
                      f"kernel's events ({lt['layer_device_ms']:.4f} device ms, the kernel "
                      f"{ms:.4f} ms): not a measurement")
                lt["layer_device_ms"] = None
            bound_ms, bound_by = _kernel_bound(name, T, B, H, dt)
            row = {"shape": [T, B, H], "route": taken, "ms": ms, "us_per_step": ms / T * 1e3,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "kernel_device_ms": kernel_device_ms, **lt}
            beside = f"; {kernel_device_ms} device ms"
            if taken == "wide_f32" and not fwd:  # the plan's rows: R <= 4 the few-row kernels
                row["rows"] = lstm_cuda.wide_f32_plan(name[:-4], B, wide_f32_layout.padded(H),
                                                      0, dev.index or 0).R
                beside += f"; R = {row['rows']} ({'few-row' if row['rows'] <= 4 else 'chunked'})"
            if "earlier" in times:
                row["earlier_ms"] = times["earlier"]
                beside = (f"; the earlier kernel ({earlier}) on the same inputs "
                          f"{row['earlier_ms']:.4f} ms ({row['earlier_ms'] / T * 1e3:.3f} us a "
                          f"step), {row['earlier_ms'] / ms:.2f}x{beside}")
            rows.append(row)
            print(f"[time] {name} {taken} T,B,H={(T, B, H)} f32: kernel {ms:.4f} ms "
                  f"({ms / T * 1e3:.3f} us a step){beside}, plain twin {plain_ms:.1f} ms "
                  f"(one call; the kernels' means of 2 medians, in turns), bound "
                  f"{bound_ms:.5f} ms ({bound_by}, {bound_ms / ms:.2%} of it); layer"
                  f"{'' if fwd else ' backward'}: port {lt['layer_ms']:.4f} ms, cuDNN "
                  f"{cls}(hidden_size={H}, bidirectional=True) f32 {lt['library_ms']:.4f} ms "
                  f"(medians, CUDA events); device time port {lt['layer_device_ms']} ms, cuDNN "
                  f"{lt['library_device_ms']} ms, cuDNN/port "
                  f"{_ratio(lt['library_device_ms'], lt['layer_device_ms'])}")
        out[name] = rows
    return out


def _f32_route_times(dev, cell: str = "lstm", what: str = "bwd") -> list:
    """Where the f32 BPTT (``what="bwd"``) or forward (``"fwd"``) takes
    ``"wide_f32"``: both cluster kernels, ``{bwd,fwd}_launch("wide", …)`` and
    ``{bwd,fwd}_launch("wide_f32", …)``, on the same inputs in turns (wide,
    wide_f32, wide_f32, wide; medians of 5 calls, ``_in_turns``) at T = 512,
    each B of ``F32_ROUTE_BATCHES`` and each H of ``F32_ROUTE_WIDTHS``
    (widths not a multiple of 32 run zero-padded on ``"wide_f32"``), beside
    each kernel's plan (rows a cluster, waves; for ``"wide"`` whether W_h
    stays in shared memory; for ``"wide_f32"`` the chunks resident, and the
    forward's in registers) and the route ``bwd_route`` / ``fwd_route``
    takes there (``python3 chip_smoke.py --f32-times``). Where the BPTT's
    plan takes the few-row kernels (R <= 4), its chunked kernel at R = 8
    (``bwd_launch("wide_f32", …, rows=8)``) in the same turns
    (``"chunked"``)."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda, wide_f32_layout, wide_layout
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    gru, fwd = cell == "gru", what == "fwd"
    m, gates, name = (gru_cuda, 3, "bigru") if gru else (lstm_cuda, 4, "bilstm")
    launch = m.fwd_launch if fwd else m.bwd_launch
    lib = _build.library()
    dt = torch.float32
    rows = []
    for H in F32_ROUTE_WIDTHS[cell]:
        for B in F32_ROUTE_BATCHES:
            T = 512
            p, Hp = wide_layout.plan(H, gates), wide_f32_layout.padded(H)
            old, new = (ctypes.c_int * 9)(), (ctypes.c_int * 9)()
            _build.check(getattr(lib, f"percival_{name}_{what}_wide_plan")(B, H, p.Hb, p.U, 0, old),
                         f"the wide {what} plan at B={B} H={H}")
            pf = wide_layout.plan(Hp, gates)
            _build.check(getattr(lib, f"percival_{name}_{what}_wide_f32_plan")(
                B, Hp, pf.Hb, pf.U, *(() if fwd else (0,)), new),
                f"the f32 wide {what} plan at B={B} H={Hp}")
            R_old, w_smem, c_old = old[5], old[6], old[7]
            plans = {"wide": {"R": R_old, "w_smem": w_smem,
                              "waves": -(-2 * -(-B // R_old) // c_old)},
                     "wide_f32": {"R": new[3], "nres": new[4], "waves": new[7]}}
            if fwd:
                plans["wide_f32"]["nreg"] = new[5]
                args = (_gru_gates if gru else _gates)(T, B, H, dt, dev, seed=1)
                route = fwd_route(dt, H, cell, B)
            else:
                args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, dt, dev, seed=1)
                route = bwd_route(dt, H, cell)
            calls = {r: (lambda r=r: launch(r, *args)) for r in ("wide", "wide_f32")}
            order = ("wide", "wide_f32", "wide_f32", "wide")
            few = not fwd and new[3] <= 4
            if few:  # the chunked kernel beside the few-row ones
                calls["chunked"] = lambda: launch("wide_f32", *args, rows=8)
                order = ("wide", "chunked", "wide_f32", "wide_f32", "chunked", "wide")
            with torch.no_grad():
                t = _in_turns(calls, order)
            rows.append({"cell": cell, "what": what, "shape": [T, B, H], "route": route, "ms": t,
                         "plans": plans})
            held = f"{new[5]} in registers, " if fwd else ""
            kind = "few-row" if few else f"{new[4]} chunks resident, {held}".rstrip(", ")
            beside = (f"; the chunked kernel at R 8 {t['chunked']:.4f} ms, "
                      f"{t['chunked'] / t['wide_f32']:.2f}x" if few else "")
            print(f"[f32 route] {cell} {what} T,B,H={(T, B, H)}: wide {t['wide']:.4f} ms (R "
                  f"{R_old}, W_h in {'shared memory' if w_smem else 'L2'}, "
                  f"{plans['wide']['waves']} waves), wide_f32 {t['wide_f32']:.4f} ms (R {new[3]}, "
                  f"{kind}, {new[7]} waves), "
                  f"{t['wide'] / t['wide_f32']:.2f}x{beside} (means of 2 medians, in turns); "
                  f"{what}_route takes {route!r}"
                  + ("" if t[route] <= min(t[r] for r in ("wide", "wide_f32"))
                     else " (the slower one)"))
    return rows


def _f32_narrow_route_times(dev, cell: str = "lstm", what: str = "bwd") -> list:
    """Where the f32 BPTT (``what="bwd"``) or forward (``"fwd"``) takes
    ``"narrow_f32"``: it and the one-block kernel it replaced,
    ``{bwd,fwd}_launch("simt", …)``, on the same inputs in turns (simt,
    narrow_f32, narrow_f32, simt; medians of 5 calls, ``_in_turns``) at
    T = 512, each B of ``F32_NARROW_BATCHES`` and each H of
    ``F32_NARROW_WIDTHS``, beside the narrow plan (blocks, rows, waves; the
    forward's W_h in registers or shared memory) and the route
    ``bwd_route`` / ``fwd_route`` takes there (``python3 chip_smoke.py
    --f32-times``)."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    gru, fwd = cell == "gru", what == "fwd"
    m, name = (gru_cuda, "bigru") if gru else (lstm_cuda, "bilstm")
    launch = m.fwd_launch if fwd else m.bwd_launch
    rows = []
    for H in F32_NARROW_WIDTHS[cell]:
        for B in F32_NARROW_BATCHES:
            T = 512
            if fwd:
                p = lstm_cuda.narrow_f32_fwd_plan(name, B, nf.padded(H))
                args = (_gru_gates if gru else _gates)(T, B, H, torch.float32, dev, seed=1)
                route = fwd_route(torch.float32, H, cell)
                kind = ", W_h in registers" if p.resident else ""
            else:
                p = lstm_cuda.narrow_f32_plan(name, B, nf.padded(H))
                args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, torch.float32, dev, seed=1)
                route, kind = bwd_route(torch.float32, H, cell), ""
            with torch.no_grad():
                t = _in_turns({r: (lambda r=r: launch(r, *args)) for r in ("simt", "narrow_f32")},
                              ("simt", "narrow_f32", "narrow_f32", "simt"))
            rows.append({"cell": cell, "what": what, "shape": [T, B, H], "route": route, "ms": t,
                         "plan": p._asdict()})
            print(f"[f32 route] {cell} {what} T,B,H={(T, B, H)}: simt {t['simt']:.4f} ms, "
                  f"narrow_f32 {t['narrow_f32']:.4f} ms ({t['narrow_f32'] / T * 1e3:.3f} us a "
                  f"step; {p.U} blocks, R {p.R}, {p.waves} waves{kind}), "
                  f"{t['simt'] / t['narrow_f32']:.2f}x (means of 2 medians, in turns); "
                  f"{what}_route takes {route!r}"
                  + ("" if t[route] <= min(t.values()) else " (the slower one)"))
    return rows


def _f32_times(dev) -> int:
    """``python3 chip_smoke.py --f32-times``: after the build, the f32
    kernels of the default width at ``F32_SIMT_TIMED`` (``_time_wide_f32``
    with ``route="narrow_f32"``: the ``"narrow_f32"`` forwards and BPTTs in
    turns with the one-block ones), the ``"narrow_f32"`` route tables of the
    forward and the BPTT (``_f32_narrow_route_times``), the BPTT rows that
    kept ``"wide"`` before the few-row plan (``F32_WIDE_KEPT``) on
    ``"wide_f32"`` in turns with ``"wide"``, beside cuDNN's layer, and the
    ``"wide_f32"`` route tables of the forward and the BPTT
    (``_f32_route_times``), for both cells."""
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route

    for cell in ("lstm", "gru"):
        _time_wide_f32(dev, cell, F32_SIMT_TIMED, route="narrow_f32")
    for cell in ("lstm", "gru"):
        for what in ("fwd", "bwd"):
            _f32_narrow_route_times(dev, cell, what)
    for cell in ("lstm", "gru"):
        for T, B, H in F32_WIDE_KEPT[cell]:
            _time_wide_f32(dev, cell, [(T, B, H)], route=bwd_route(torch.float32, H, cell),
                           what=("bwd",))
    for cell in ("lstm", "gru"):
        for what in ("fwd", "bwd"):
            _f32_route_times(dev, cell, what)
    _f32_wide_fwd_times(dev)
    return 0


# python3 chip_smoke.py --first-port-times: the kernels still in their first
# port, by (cell, pass, dtype, route, shapes): the bf16 "wide" BPTT and
# forward past the tensor-core widths (at 640 / 704 and 1024 the kernels the
# streamed ones replaced, at 2048 past the streamed widths: blstm_size=4096),
# the f32 "wide" ones past H = 512, the GRU's "wide" forward at
# F32_WIDE_FWD's width, the bf16 "simt" ones at an H that is not a multiple
# of 16
FIRST_PORT_ROWS = [
    *((cell, what, torch.bfloat16, "wide",
       [(512, B, H) for H in (hs, 1024, 2048) for B in (8, 32, 160)])
      for cell, hs in (("lstm", 640), ("gru", 704)) for what in ("bwd", "fwd")),
    *((cell, what, torch.float32, "wide", [(512, B, H) for H in (768, 1024) for B in (8, 32, 160)])
      for cell in ("lstm", "gru") for what in ("bwd", "fwd")),
    ("gru", "fwd", torch.float32, "wide", [(512, 1, 336), (512, 2, 336), (512, 3, 336)]),
    *((cell, what, torch.bfloat16, "simt", [(512, 8, 100), (512, 32, 100)])
      for cell in ("lstm", "gru") for what in ("bwd", "fwd")),
    # the bf16 "wide" BPTTs the deep streamed layout replaced past 2048, up
    # to the widest width the port takes (blstm_size=6144 and 8192)
    *((cell, "bwd", torch.bfloat16, "wide", [(512, B, H) for H in (3072, 4096) for B in (8, 32)])
      for cell in ("lstm", "gru")),
]


def _first_port_times(dev, rows=None) -> list:
    """``python3 chip_smoke.py --first-port-times``: each kernel of
    ``FIRST_PORT_ROWS`` launched on its route (``{fwd,bwd}_launch``,
    uncounted) at each shape: its time by CUDA events (median of 5 calls) and
    by device time (``_device_ms``, 3 calls), the bound at its dtype's peak,
    and the port's layer and cuDNN's bidirectional ``nn.LSTM`` / ``nn.GRU``
    (TF32 off) forward or backward by events and device time
    (``_layer_times``: medians of 2 × 3 calls; the port's layer takes the
    route ``fwd_route`` / ``bwd_route`` gives)."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda

    out = []
    for cell, what, dt, route, shapes in rows or FIRST_PORT_ROWS:
        gru, fwd = cell == "gru", what == "fwd"
        m, name = (gru_cuda, f"bigru_{what}") if gru else (lstm_cuda, f"bilstm_{what}")
        launch = m.fwd_launch if fwd else m.bwd_launch
        for T, B, H in shapes:
            if fwd:
                args = (_gru_gates if gru else _gates)(T, B, H, dt, dev, seed=1)
            else:
                args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, dt, dev, seed=1)
            with torch.no_grad():
                ms = _median_ms(lambda: launch(route, *args), runs=5)
                kernel_device_ms = _device_ms(lambda: launch(route, *args), calls=3, match=name)
            ws = _layer_weights(cell, H, dt, dev, seed=2)
            x = torch.from_numpy(np.random.default_rng(3).normal(size=(B, T, LAYER_IN))
                                 .astype(np.float32)).to(device=dev, dtype=dt)
            with _compact_weights():
                lt = _layer_times(m.bigru if gru else m.bilstm, _library_layer(cell, ws, dt, dev),
                                  x, [t for d in ws for t in d], fwd, runs=2, inner=3)
            bound_ms, bound_by = _kernel_bound(name, T, B, H, dt)
            row = {"cell": cell, "what": what, "dtype": str(dt)[6:], "route": route,
                   "shape": [T, B, H], "ms": ms, "kernel_device_ms": kernel_device_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, **lt}
            out.append(row)
            print(f"[first port] {name} {route} {row['dtype']} T,B,H={(T, B, H)}: kernel "
                  f"{ms:.4f} ms ({ms / T * 1e3:.3f} us a step), device {kernel_device_ms} ms; "
                  f"bound {bound_ms:.5f} ms ({bound_by}); layer{'' if fwd else ' backward'}: "
                  f"port {lt['layer_ms']:.4f} ms (device {lt['layer_device_ms']}), cuDNN "
                  f"{lt['library_ms']:.4f} ms (device {lt['library_device_ms']}), port/cuDNN by "
                  f"device time {_ratio(lt['layer_device_ms'], lt['library_device_ms'])}")
    return out


def _f32_wide_fwd_times(dev, widths=(336,), batches=(1, 2, 3, 4)) -> list:
    """The f32 GRU forward where ``mma_layout.F32_WIDE_FWD`` may keep
    ``"wide"``: ``fwd_launch("wide")`` and ``fwd_launch("wide_f32")`` on the
    same inputs in turns, twice over (wide, wide_f32, wide_f32, wide, wide,
    wide_f32, wide_f32, wide; medians of 5 calls, ``_in_turns``), beside the
    route ``fwd_route`` takes there (``python3 chip_smoke.py --f32-times``)."""
    from percivaltts_tpu_torch.ops import gru_cuda
    from percivaltts_tpu_torch.ops.mma_layout import fwd_route

    rows = []
    for H in widths:
        for B in batches:
            T = 512
            args = _gru_gates(T, B, H, torch.float32, dev, seed=1)
            route = fwd_route(torch.float32, H, "gru", B)
            with torch.no_grad():
                t = _in_turns({r: (lambda r=r: gru_cuda.fwd_launch(r, *args))
                               for r in ("wide", "wide_f32")}, ("wide", "wide_f32") * 2
                              + ("wide_f32", "wide") * 2)
            rows.append({"shape": [T, B, H], "route": route, "ms": t})
            print(f"[f32 wide fwd] gru T,B,H={(T, B, H)}: wide {t['wide']:.4f} ms, wide_f32 "
                  f"{t['wide_f32']:.4f} ms, wide_f32/wide {t['wide_f32'] / t['wide']:.3f} (means "
                  f"of 4 medians, in turns); fwd_route takes {route!r}")
    return rows


def _stream_plans(dev) -> None:
    """Phases 17a and 18a's plans: the streamed BPTTs' and forwards' launch
    plans at every width and B of phases 17–18 and of ``--bf16-wide-times``
    (the forwards' up to ``wide_mma_layout.stream_fwd_max_h``) must be
    ``ops/wide_mma_layout.py::stream_plan``'s / ``stream_fwd_plan``'s at the
    clusters the card holds (the layout, rows, pairs a compute warp, chunks
    resident and streamed, waves, slot or h buffers, shared memory, the deep
    layout's scratch); then ``ptxas``'s registers and spills of every
    instantiation of the four kernels, the BPTTs' deep ones included: none
    may spill more than ``STREAM_SPILL_MAX`` allows it (0 if not listed)."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_mma_layout as wm

    lib = _build.library()
    for cell, name, gates in (("lstm", "bilstm", 4), ("gru", "bigru", 3)):
        shapes = STREAM_SHAPES[cell] + STREAM_TIMED + DEEP_SHAPES[cell] + DEEP_TIMED
        widths = sorted({H for _, _, H in shapes} | set(BF16_WIDE_WIDTHS[cell]))
        batches = sorted({B for _, B, _ in shapes}
                         | set(BF16_WIDE_BATCHES) | set(BF16_WIDE_FWD_BATCHES))
        for H in widths:
            Hp = wm.padded(H)
            pm = wm.plan(Hp, gates)
            for B in batches:
                out = (ctypes.c_int * 14)()
                _build.check(getattr(lib, f"percival_{name}_bwd_wide_mma_stream_plan")(
                    B, Hp, pm.Hb, pm.U, out), f"the streamed BPTT plan at B={B} H={Hp}")
                got = wm.StreamPlan(*out)
                want = wm.stream_plan(B, Hp, gates, got.clusters)
                if got != want:
                    raise AssertionError(f"the {name} wide_mma_stream plan {got} is not {want}")
                print(f"[stream plan] {name} bwd B={B} H={H} (run at {Hp}) bf16: {got.U} blocks of "
                      f"{got.Hb} units, {32 * wm.STREAM_WARPS} threads, {got.R} rows a cluster, "
                      + (f"deep layout: {got.ppw} pairs a compute warp, {got.nstr} chunks of "
                         f"{got.chunk} k streamed through {got.ring} slots "
                         f"({got.nstr * wm.tile_bytes(got.NC, got.chunk)} B a step a block), "
                         f"{got.scratch} B of partials a cluster in global memory"
                         if got.chunk == wm.DEEP_CHUNK else
                         f"{got.nres} chunks resident / {got.nstr} streamed "
                         f"({got.nstr * wm.tile_bytes(got.NC)} B a step a block), "
                         f"{1 + got.dbuf} buffer(s) of partials")
                      + f", {got.clusters} clusters at once ({got.waves} waves), {got.smem} B "
                      "shared memory")
                if Hp > wm.stream_fwd_max_h(gates):
                    continue  # the forward stays on "wide" there
                out = (ctypes.c_int * 11)()
                _build.check(getattr(lib, f"percival_{name}_fwd_wide_mma_stream_plan")(
                    B, Hp, pm.Hb, pm.U, 0, out), f"the streamed forward plan at B={B} H={Hp}")
                got = wm.StreamFwdPlan(*out)
                want = wm.stream_fwd_plan(B, Hp, gates, got.clusters)
                if got != want:
                    raise AssertionError(f"the {name} wide_mma_stream forward plan {got} is not "
                                         f"{want}")
                print(f"[stream plan] {name} fwd B={B} H={H} (run at {Hp}) bf16: {got.U} blocks of "
                      f"{got.Hb} units, {got.R} rows a cluster, {got.PPW} pairs a compute warp, "
                      f"{got.nres} chunks resident / {got.nstr} streamed "
                      f"({got.nstr * wm.tile_bytes(got.NC)} B a step a block), {got.clusters} "
                      f"clusters at once ({got.waves} waves), {1 + got.dbuf} h buffer(s), "
                      f"{got.smem} B shared memory")
    lines = [line for line in _ptxas_usage(BUILD_LOG) if "wide_mma_stream" in line]
    for line in lines:
        print(f"[stream ptxas] {line}")
        stores = re.match(r"(\d+)/", line.split("spill ")[1])
        limit = next((b for k, b in STREAM_SPILL_MAX.items() if k in line), 0)
        if stores is None or int(stores.group(1)) > limit:
            raise AssertionError(f"a streamed kernel instantiation spills past {limit} B: {line}")
    # the BPTTs at R = 8, 16, 24 for each cell and their deep layout's
    # (R, pairs) (wide_mma_layout.STREAM_DEEP_KERNELS); the forwards at each
    # pairs a compute warp (wide_mma_layout.STREAM_FWD_MAX_PPW)
    want = (6 + sum(map(len, wm.STREAM_DEEP_KERNELS.values()))
            + sum(wm.STREAM_FWD_MAX_PPW.values()))
    if len(lines) != want:
        raise AssertionError(f"ptxas reported {len(lines)} streamed kernels, not {want}")


def _check_stream_kernels(dev) -> dict:
    """Phase 17a/17b: each streamed BPTT and forward (``bwd_route``'s /
    ``fwd_route``'s ``"wide_mma_stream"``, counted) against its twin at
    ``STREAM_SHAPES`` within ``KERNEL_TOL[bf16]``·max(1, max|twin|) (the LSTM
    forward with and without its cells), and the CUDA-core cluster kernel it
    replaced (``"wide"``, launched directly) on the same inputs; then the
    autograd pair through ``bilstm_core`` / ``bigru_core`` at
    ``STREAM_AUTOGRAD_SHAPE`` (one forward and one BPTT on
    ``"wide_mma_stream"``) against the twins' gradients. Returns the largest
    |kernel − twin| of each (``*_{fwd,bwd}_wide_mma_stream``, and
    ``*_earlier`` for ``"wide"``)."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    bf16, tol = torch.bfloat16, KERNEL_TOL[torch.bfloat16]
    err = {}
    for cell, name in (("lstm", "bilstm_bwd"), ("gru", "bigru_bwd")):
        gru = cell == "gru"
        m = gru_cuda if gru else lstm_cuda
        fname = f"{name[:-4]}_fwd"
        key, fkey = f"{name}_wide_mma_stream", f"{fname}_wide_mma_stream"
        err[key] = err[f"{key}_earlier"] = err[fkey] = err[f"{fkey}_earlier"] = 0.0
        with torch.no_grad():
            for T, B, H in STREAM_SHAPES[cell]:
                route = bwd_route(bf16, H, cell, B)
                if route != "wide_mma_stream":
                    raise AssertionError(f"{name} routes bf16 H={H} to {route!r}")
                args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, bf16, dev, seed=T + B)
                want = getattr(m, f"{name}_reference")(*args)
                limit = tol * max(1.0, max(w.float().abs().max().item() for w in want))
                tag = f"T={T} B={B} H={H} bf16"
                got = _launch_once(getattr(m, name), *args, route=route)
                err[key] = max(err[key], _compare(f"[{name} {route}] {tag}", got, want, limit,
                                                  relative=False))
                got = m.bwd_launch("wide", *args)
                torch.cuda.synchronize()
                err[f"{key}_earlier"] = max(err[f"{key}_earlier"], _compare(
                    f"[{name} wide, launched directly] {tag}", got, want, limit, relative=False))
                # the forward on the same width and rows, with and without cells
                route = fwd_route(bf16, H, cell, B)
                if route != "wide_mma_stream":
                    raise AssertionError(f"{fname} routes bf16 H={H} B={B} to {route!r}")
                fargs = (_gru_gates if gru else _gates)(T, B, H, bf16, dev, seed=T + B)
                for kw in ({},) if gru else ({"with_cells": True}, {"with_cells": False}):
                    want = getattr(m, f"{fname}_reference")(*fargs, **kw)
                    limit = tol * max(1.0, max(w.float().abs().max().item() for w in want))
                    tag = f"T={T} B={B} H={H} bf16" + (f" cells={kw['with_cells']}" if kw else "")
                    got = _launch_once(getattr(m, fname), *fargs, route=route, **kw)
                    err[fkey] = max(err[fkey], _compare(f"[{fname} {route}] {tag}", got, want,
                                                        limit, relative=False))
                    got = m.fwd_launch("wide", *fargs, **kw)
                    torch.cuda.synchronize()
                    err[f"{fkey}_earlier"] = max(err[f"{fkey}_earlier"], _compare(
                        f"[{fname} wide, launched directly] {tag}", got, want, limit,
                        relative=False))
        # the autograd pair: forward kernel + BPTT kernel against the twins
        T, B, H = STREAM_AUTOGRAD_SHAPE
        core, ref = (m.bigru_core, m.bigru_core_reference) if gru else \
            (m.bilstm_core, m.bilstm_core_reference)
        base = (_gru_gates if gru else _gates)(T, B, H, bf16, dev, seed=7)
        dy = _dy(T, B, H, bf16, dev, seed=1)
        fwd_w, bwd_w = getattr(m, f"{name[:-4]}_fwd"), getattr(m, name)
        froute, broute = fwd_route(bf16, H, cell), bwd_route(bf16, H, cell)
        grads = []
        for c in (core, ref):
            leaves = [t.clone().requires_grad_(True) for t in base]
            f0, b0 = fwd_w.routes[froute], bwd_w.routes[broute]
            torch.autograd.backward(c(*leaves), dy)
            torch.cuda.synchronize()
            grads.append([t.grad for t in leaves])
            moved = (fwd_w.routes[froute] - f0, bwd_w.routes[broute] - b0)
            if c is core and moved != (1, 1):
                raise RuntimeError(f"the {cell} autograd pair did not launch one forward on "
                                   f"{froute} and one BPTT on {broute}")
        names = ("dgx_f", "dgx_b", "dW_h_f", "dW_h_b") + (("db_hn_f", "db_hn_b") if gru else ())
        for n, gk, gt in zip(names, *grads):
            _compare(f"[autograd {'BiGRU' if gru else 'BiLSTM'}, forward {froute}, BPTT {broute}] "
                     f"{n} T,B,H={STREAM_AUTOGRAD_SHAPE} bf16", [gk], [gt],
                     tol * gt.float().abs().max().item(), relative=False)
    return err


def _check_deep_kernels(dev) -> dict:
    """Phase 18a/18b: each streamed BPTT on its deep layout (``bwd_route``'s
    ``"wide_mma_stream"`` past ``wide_mma_layout.stream_max_h``, counted on
    the route and on ``.stream_layouts["deep"]``) against its twin at
    ``DEEP_SHAPES`` within ``KERNEL_TOL[bf16]``·max(1, max|twin|); then the
    autograd pair through ``bilstm_core`` / ``bigru_core`` at
    ``DEEP_AUTOGRAD_SHAPE`` (the forward on ``"wide"``, one BPTT on the deep
    layout) against the twins' gradients. Returns the largest
    |kernel − twin| of each (``*_bwd_wide_mma_stream_deep``)."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    bf16, tol = torch.bfloat16, KERNEL_TOL[torch.bfloat16]
    err = {}
    for cell, name in (("lstm", "bilstm_bwd"), ("gru", "bigru_bwd")):
        gru = cell == "gru"
        m = gru_cuda if gru else lstm_cuda
        wrapper = getattr(m, name)
        key = f"{name}_wide_mma_stream_deep"
        err[key] = 0.0
        with torch.no_grad():
            for T, B, H in DEEP_SHAPES[cell]:
                route = bwd_route(bf16, H, cell, B)
                if route != "wide_mma_stream":
                    raise AssertionError(f"{name} routes bf16 H={H} to {route!r}")
                args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, bf16, dev, seed=T + B)
                want = getattr(m, f"{name}_reference")(*args)
                limit = tol * max(1.0, max(w.float().abs().max().item() for w in want))
                deep = wrapper.stream_layouts["deep"]
                got = _launch_once(wrapper, *args, route=route)
                if wrapper.stream_layouts["deep"] != deep + 1:
                    raise AssertionError(f"{name} at T,B,H={(T, B, H)} did not launch the deep "
                                         "layout")
                err[key] = max(err[key], _compare(f"[{name} {route}, deep] T={T} B={B} H={H} bf16",
                                                  got, want, limit, relative=False))
        # the autograd pair: the forward kernel ("wide") and the deep BPTT against the twins
        T, B, H = DEEP_AUTOGRAD_SHAPE
        core, ref = (m.bigru_core, m.bigru_core_reference) if gru else \
            (m.bilstm_core, m.bilstm_core_reference)
        base = (_gru_gates if gru else _gates)(T, B, H, bf16, dev, seed=7)
        dy = _dy(T, B, H, bf16, dev, seed=1)
        fwd_w = getattr(m, f"{name[:-4]}_fwd")
        froute, broute = fwd_route(bf16, H, cell), bwd_route(bf16, H, cell)
        grads = []
        for c in (core, ref):
            leaves = [t.clone().requires_grad_(True) for t in base]
            f0, b0, d0 = fwd_w.routes[froute], wrapper.routes[broute], wrapper.stream_layouts["deep"]
            torch.autograd.backward(c(*leaves), dy)
            torch.cuda.synchronize()
            grads.append([t.grad for t in leaves])
            moved = (fwd_w.routes[froute] - f0, wrapper.routes[broute] - b0,
                     wrapper.stream_layouts["deep"] - d0)
            if c is core and moved != (1, 1, 1):
                raise RuntimeError(f"the {cell} autograd pair did not launch one forward on "
                                   f"{froute} and one BPTT on {broute}'s deep layout: {moved}")
        names = ("dgx_f", "dgx_b", "dW_h_f", "dW_h_b") + (("db_hn_f", "db_hn_b") if gru else ())
        for n, gk, gt in zip(names, *grads):
            _compare(f"[autograd {'BiGRU' if gru else 'BiLSTM'}, forward {froute}, BPTT {broute} "
                     f"deep] {n} T,B,H={DEEP_AUTOGRAD_SHAPE} bf16", [gk], [gt],
                     tol * gt.float().abs().max().item(), relative=False)
    return err


STREAM_NAMES = (("lstm", "bilstm_bwd"), ("lstm", "bilstm_fwd"), ("gru", "bigru_bwd"),
                ("gru", "bigru_fwd"))


def _time_stream_kernels(dev, shapes=None, names=STREAM_NAMES, earlier_b=STREAM_EARLIER_B,
                         once=(), earlier_h=None) -> dict:
    """Phase 17d: each streamed BPTT and forward (``names``) at
    ``STREAM_TIMED`` in turns with its twin and, at the rows of
    ``earlier_b`` (and widths of ``earlier_h``, all if ``None``), the
    CUDA-core cluster kernel it replaced (``"wide"``;
    earlier, routed, twin, routed, earlier; ``_in_turns``, ``once``: timed
    by one call a turn), the kernel also by device time (``_device_ms``, 3
    calls; ``"wide"`` at the first row, unless timed once), beside the plan
    (the BPTT's layout), the bound and the port's
    layer backward / forward and cuDNN's bidirectional ``nn.LSTM`` /
    ``nn.GRU`` bf16 backward / forward by CUDA events and device time
    (``_layer_times``: medians of 2 × 3 calls)."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda, wide_mma_layout
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    dt = torch.bfloat16
    out = {}
    for cell, name in names:
        gru, fwd = cell == "gru", name.endswith("fwd")
        m = gru_cuda if gru else lstm_cuda
        cls = "nn.GRU" if gru else "nn.LSTM"
        what = "forward" if fwd else "backward"
        rows = []
        for T, B, H in shapes or STREAM_TIMED:
            route = (fwd_route if fwd else bwd_route)(dt, H, cell, B)
            Hp = wide_mma_layout.padded(H)
            plan = (lstm_cuda.stream_fwd_plan(name[:-4], B, Hp, 0, dev.index or 0) if fwd else
                    lstm_cuda.stream_plan(name[:-4], B, Hp, dev.index or 0))
            deep = not fwd and plan.chunk == wide_mma_layout.DEEP_CHUNK
            if fwd:
                args = (_gru_gates if gru else _gates)(T, B, H, dt, dev, seed=1)
            else:
                args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, dt, dev, seed=1)
            kern, twin = getattr(m, name), getattr(m, f"{name}_reference")
            earlier = m.fwd_launch if fwd else m.bwd_launch
            calls = {"kernel": lambda: kern(*args), "twin": lambda: twin(*args)}
            order = ("kernel", "twin", "kernel")
            if B in earlier_b and (earlier_h is None or H in earlier_h):
                calls["earlier"] = lambda: earlier("wide", *args)
                order = ("earlier",) + order + ("earlier",)
            with torch.no_grad():
                times = {"earlier": None, **_in_turns(calls, order, once=once)}
                kernel_device_ms = _device_ms(
                    lambda: kern(*args), calls=3,
                    match=f"{name}_{route}_{'deep_' if deep else ''}kernel")
                # the earlier kernel's device time at the first row alone (the
                # kernel line reports it; the others are in PERF.md)
                earlier_device_ms = None if times["earlier"] is None or once or rows else \
                    _device_ms(lambda: earlier("wide", *args), calls=3,
                               match=f"{name}_wide_kernel")
            ws = _layer_weights(cell, H, dt, dev, seed=2)
            x = torch.from_numpy(np.random.default_rng(3).normal(size=(B, T, LAYER_IN))
                                 .astype(np.float32)).to(device=dev, dtype=dt)
            with _compact_weights():
                lt = _layer_times(m.bigru if gru else m.bilstm, _library_layer(cell, ws, dt, dev),
                                  x, [t for d in ws for t in d], fwd, runs=2, inner=3)
            ms = times["kernel"]
            if lt["layer_device_ms"] is not None and lt["layer_device_ms"] < 0.5 * ms:
                print(f"[time] {name} {route} T,B,H={(T, B, H)}: the layer's trace lost the "
                      f"kernel's events ({lt['layer_device_ms']:.4f} device ms): not a measurement")
                lt["layer_device_ms"] = None
            bound_ms, bound_by = _kernel_bound(name, T, B, H, dt)
            row = {"shape": [T, B, H], "route": route, "layout": "deep" if deep else "64k",
                   "ms": ms, "us_per_step": ms / T * 1e3, "plain_ms": times["twin"],
                   "earlier_ms": times["earlier"], "kernel_device_ms": kernel_device_ms,
                   "earlier_device_ms": earlier_device_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "plan": plan._asdict(), **lt}
            rows.append(row)
            vs = ("the earlier kernel (wide) not timed at this B and H (PERF.md holds it)"
                  if times["earlier"] is None else
                  f"the earlier kernel (wide) on the same inputs {times['earlier']:.4f} ms, device "
                  f"{earlier_device_ms} ms, {times['earlier'] / ms:.2f}x (means of 2 "
                  f"{'calls' if once else 'medians'}, in turns)")
            layout = (f"deep: {plan.ppw} pairs a compute warp, {plan.nstr} chunks of "
                      f"{plan.chunk} k streamed through {plan.ring} slots" if deep else
                      f"{plan.nres} of {plan.nres + plan.nstr} chunks resident")
            print(f"[time] {name} {route} T,B,H={(T, B, H)} bf16 (R {plan.R}, {layout}, "
                  f"{plan.waves} waves, {plan.U} blocks): kernel {ms:.4f} ms "
                  f"({ms / T * 1e3:.3f} us a step), device {kernel_device_ms} ms; {vs}; plain twin "
                  f"{times['twin']:.1f} ms (one call); bound {bound_ms:.5f} ms ({bound_by}, "
                  f"{bound_ms / ms:.2%} of it); layer {what}: port {lt['layer_ms']:.4f} ms, "
                  f"cuDNN {cls}(hidden_size={H}, bidirectional=True) bf16 {lt['library_ms']:.4f} "
                  f"ms (medians, CUDA events); device time port {lt['layer_device_ms']} ms, cuDNN "
                  f"{lt['library_device_ms']} ms, cuDNN/port "
                  f"{_ratio(lt['library_device_ms'], lt['layer_device_ms'])}", flush=True)
        out[name] = rows
    return out


def _time_deep_kernels(dev) -> dict:
    """Phase 18d: ``_time_stream_kernels`` for the two BPTTs at
    ``DEEP_TIMED``, ``"wide"`` in turns at the rows of ``DEEP_EARLIER_B`` and
    ``DEEP_EARLIER_H`` by one call a turn (0.3–1 s a call there); every row
    on the deep layout."""
    out = _time_stream_kernels(dev, DEEP_TIMED, STREAM_NAMES[::2], DEEP_EARLIER_B,
                               once=("earlier",), earlier_h=DEEP_EARLIER_H)
    for name, rows in out.items():
        for row in rows:
            if row["route"] != "wide_mma_stream" or row["layout"] != "deep":
                raise AssertionError(f"{name} at T,B,H={tuple(row['shape'])} did not take the "
                                     f"deep layout: {row['route']}, {row['plan']}")
    return out


def _bf16_wide_times(dev) -> int:
    """``python3 chip_smoke.py --bf16-wide-times``: after the build, the bf16
    layers past the tensor-core widths: ``bwd_launch("wide", …)`` against
    ``bwd_launch("wide_mma_stream", …)`` on the same inputs in turns (wide,
    stream, stream, wide; medians of 5 calls, ``_in_turns``; from
    ``BF16_WIDE_SLOW_H`` on, "wide" by one call a turn) at T = 512, each H
    of ``BF16_WIDE_WIDTHS`` and B of ``BF16_WIDE_BATCHES``, beside the
    streamed plan (rows, the layout's chunks, waves) and the route
    ``bwd_route`` takes there (``mma_layout.BF16_WIDE_BWD`` keeps ``"wide"``
    where it measured faster); the forwards likewise (``fwd_launch``,
    ``fwd_route``, ``mma_layout.BF16_WIDE_FWD``) at each B of
    ``BF16_WIDE_FWD_BATCHES`` and each width up to
    ``wide_mma_layout.stream_fwd_max_h``; then phase 17d's and 18d's rows
    (``_time_stream_kernels``, ``_time_deep_kernels``)."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda, wide_mma_layout
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

    dt = torch.bfloat16
    for cell, name in (("lstm", "bilstm"), ("gru", "bigru")):
        gru = cell == "gru"
        m = gru_cuda if gru else lstm_cuda
        for what, batches in (("bwd", BF16_WIDE_BATCHES), ("fwd", BF16_WIDE_FWD_BATCHES)):
            fwd = what == "fwd"
            launch = m.fwd_launch if fwd else m.bwd_launch
            for H in BF16_WIDE_WIDTHS[cell]:
                if fwd and H > wide_mma_layout.stream_fwd_max_h(3 if gru else 4):
                    continue  # the forward stays on "wide" there
                for B in batches:
                    T = 512
                    if fwd:
                        args = (_gru_gates if gru else _gates)(T, B, H, dt, dev, seed=1)
                    else:
                        args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, dt, dev, seed=1)
                    Hp = wide_mma_layout.padded(H)
                    plan = (lstm_cuda.stream_fwd_plan(name, B, Hp, 0, dev.index or 0) if fwd else
                            lstm_cuda.stream_plan(name, B, Hp, dev.index or 0))
                    slow = H >= BF16_WIDE_SLOW_H
                    with torch.no_grad():
                        t = _in_turns({r: (lambda r=r: launch(r, *args))
                                       for r in ("wide", "wide_mma_stream")},
                                      ("wide", "wide_mma_stream", "wide_mma_stream", "wide"),
                                      once=("wide",) if slow else ())
                    route = (fwd_route if fwd else bwd_route)(dt, H, cell, B)
                    layout = (f"{plan.ppw} pairs a compute warp, {plan.nstr} chunks of "
                              f"{plan.chunk} k through {plan.ring} slots"
                              if not fwd and plan.chunk != 64 else
                              f"{plan.nres} of {plan.nres + plan.nstr} chunks resident")
                    print(f"[bf16 route] {cell} {what} T,B,H={(T, B, H)}: wide {t['wide']:.4f} ms, "
                          f"wide_mma_stream {t['wide_mma_stream']:.4f} ms "
                          f"({t['wide_mma_stream'] / T * 1e3:.3f} us a step; R {plan.R}, "
                          f"{layout}, {plan.waves} waves), "
                          f"{t['wide'] / t['wide_mma_stream']:.2f}x (means of 2 "
                          f"{'calls of wide' if slow else 'medians'}, in turns); {what}_route "
                          f"takes {route!r}"
                          + ("" if t[route] <= min(t.values()) else " (the slower one)"),
                          flush=True)
    _time_stream_kernels(dev)
    _time_deep_kernels(dev)
    return 0


def _model_route(kind: str, what: str) -> str:
    """The route a phase 13–15 model's recurrences take, for the forward
    (``what="fwd"``) or the BPTT (``"bwd"``): at blstm_size=1024 the
    tensor-core cluster kernels (``"wide_mma"``) in bf16, and in f32 the f32
    cluster kernels (``"wide_f32"``) for both; at the default width in f32
    (``NARROW_MODELS``) the f32 narrow kernels (``"narrow_f32"``) for both;
    at blstm_size=2048 in bf16 (``STREAM_MODELS``) the streamed tensor-core
    cluster kernels (``"wide_mma_stream"``) for both; at blstm_size=4096
    (``DEEP_MODELS``) the BPTT on the streamed kernels' deep layout and the
    forward on ``"wide"``."""
    if kind in STREAM_MODELS:
        return "wide_mma_stream"
    if kind in DEEP_MODELS:
        return "wide" if what == "fwd" else "wide_mma_stream"
    if not _is_f32(kind):
        return "wide_mma"
    return "narrow_f32" if kind in NARROW_MODELS else "wide_f32"


def _cluster_models_path(dev, card: str, kinds=WIDE_MODELS, depth=None) -> dict:
    """Phase 13b/13c (``WIDE_MODELS``), 14b/14c (``WIDE_GRU_MODELS``), 15b
    (``NARROW_MODELS``), 16c (``FEW_MODELS``), 17c (``STREAM_MODELS``) and
    18c (``DEEP_MODELS``, every BPTT launch also on the deep layout): each
    model served and trained as phases 4–6 serve and train config 3 and the
    BGRU, every forward and BPTT launch on its route (``_model_route``); at
    ``depth`` (serves timed, steps held against the twins, steps timed; the
    f32 models at ``F32_DEPTH`` when none is given)."""
    runs = {}
    for kind in kinds:
        route = {what: _model_route(kind, what) for what in ("fwd", "bwd")}
        if depth or _is_f32(kind):
            serves, checked, steps = depth or F32_DEPTH
            served = _serve_path(dev, kind, n_timed=serves)
            trained = _train_path(dev, kind, n_checked=checked, n_timed=steps)
        else:
            served, trained = _serve_path(dev, kind), _train_path(dev, kind)
        cell = "bigru" if _is_gru(kind) else "bilstm"
        for what, run in (("serve", served), ("train", trained)):
            counts, routes = run["counts"], run["routes"]
            for p in ("fwd", "bwd"):
                name = f"{cell}_{p}"
                if routes[name][route[p]] != counts[name]:
                    raise AssertionError(f"{what} {kind}: {name} launched off the {route[p]} "
                                         f"route: {routes[name]} of {counts[name]}")
        if not trained["counts"][f"{cell}_bwd"]:
            raise AssertionError(f"train {kind}: no BPTT launched")
        deep = trained["plans"][f"{cell}_bwd"]["deep"]
        if kind in DEEP_MODELS and deep != trained["counts"][f"{cell}_bwd"]:
            raise AssertionError(f"train {kind}: {deep} of {trained['counts'][f'{cell}_bwd']} "
                                 "BPTT launches on the deep layout")
        print(f"[time] ({card}) {kind}: serve median {served['serve_ms']:.3f} ms, WGAN-GP step "
              f"median {trained['step_ms']:.3f} ms, busy share {trained['busy_share']}; launches "
              f"a serve {served['counts'][f'{cell}_fwd']}, a step "
              f"{STEP_LAUNCHES[kind]}, forwards on {route['fwd']}, BPTTs on {route['bwd']}")
        runs[kind] = {"serve": served, "train": trained}
    return runs


def _ptxas_usage(log: str) -> list:
    """One line per compiled kernel from ``ptxas -v``'s log: registers,
    spill stores / loads (bytes), and the (mangled) kernel name."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = f"{m.group(1)}/{m.group(2)}"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out.append(f"{m.group(1):>3} registers, spill {spill or '?'} B  {name}")
            name, spill = None, ""
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    flags = ("--f32-times", "--bf16-wide-times", "--first-port-times")
    if len(args) > 1 or any(a not in flags for a in args):
        print(f"usage: python3 chip_smoke.py [{' | '.join(flags)}]", file=sys.stderr)
        return 2
    timing = args[0] if args else None
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this test needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from percivaltts_tpu_torch import _build

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    built = _build.build(force=True)
    global BUILD_LOG
    BUILD_LOG = built.log
    print(f"[build] {built.path.name} from {len(_build.sources())} source(s) in "
          f"{built.seconds:.1f} s")
    for line in _ptxas_usage(built.log):
        print(f"[build] {line}")
    if timing == "--f32-times":
        return _f32_times(dev)
    if timing == "--bf16-wide-times":
        return _bf16_wide_times(dev)
    if timing == "--first-port-times":
        _first_port_times(dev)
        return 0

    # 3. every kernel against its plain twin
    max_err = _check_kernels(dev)
    max_err.update(_check_dsp_kernels(dev))

    # 4–5. the paths: serve and train each generator, vocode config 3's features
    paths = {}
    serve = {kind: _serve_path(dev, kind) for kind in ("cnn_blstm", "bgru")}
    vocode = _vocode_path(dev, serve["cnn_blstm"]["feats"])
    train = {kind: _train_path(dev, kind) for kind in ("cnn_blstm", "bgru")}
    routes = _no_routes()
    for kind in ("cnn_blstm", "bgru"):
        paths[f"serve_{kind}"] = serve[kind]["counts"]
        paths[f"train_{kind}"] = train[kind]["counts"]
        for run in (serve[kind], train[kind]):
            for name, by_route in run["routes"].items():
                for route, n in by_route.items():
                    routes[name][route] += n
    paths["vocode_pml"] = vocode["counts"]

    # 6. kernel timings
    timed = _time_kernels(dev)
    timed.update(_time_dsp_kernels(dev))

    # 7. the training loop: epochs, validation, checkpoints, resume, serving the best
    loop = _train_loop_path(dev, smi)
    paths["train_loop"] = loop["counts"]
    for name, by_route in loop["routes"].items():
        for route, n in by_route.items():
            routes[name][route] += n

    # 8. the quick start through the CLI: config 1, then config 3 on its corpus
    qs = _quickstart_path(dev, smi)
    paths.update(qs["counts"])
    qs3 = _quickstart_wgan_path(dev, smi, qs)
    cli_export = _start_cli_export(qs)  # 11d's export, in the background through phases 9–10
    paths["quickstart_wgan"] = qs3["counts"]
    for name, by_route in qs3["routes"].items():
        for route, n in by_route.items():
            routes[name][route] += n

    # 9. the remaining vocoders: config 4's mel-spectrogram target, WORLD, and
    # both through the CLI on phase 8's corpus
    mel, world = _mel_path(dev, qs), _world_path(dev, qs)
    for kind, run in (("melspec", mel), ("world", world)):
        paths[f"vocode_{kind}"] = run["counts"]
        paths[f"analyze_{kind}"] = run["analysis"]["counts"]
    cli9 = {kind: _cli_vocoder_path(dev, smi, qs, kind) for kind in ("melspec", "world")}
    for kind, run in cli9.items():
        paths.update({f"cli_{kind}_{cmd}": c for cmd, c in run["counts"].items()})

    t_phase10 = time.perf_counter()
    # 10. the remaining variants: the reference-faithful config 3 (2d convs,
    # LayerNorms) and the BGRU with its LayerNorm, served and trained; PML's
    # "te"; the analysis readers; the 2d model over "te" through the CLI
    for kind in ("cnn_blstm_2d", "bgru_ln"):
        serve[kind], train[kind] = _serve_path(dev, kind), _train_path(dev, kind)
        paths[f"serve_{kind}"] = serve[kind]["counts"]
        paths[f"train_{kind}"] = train[kind]["counts"]
        for run in (serve[kind], train[kind]):
            for name, by_route in run["routes"].items():
                for route, n in by_route.items():
                    routes[name][route] += n
    te = _te_path(dev, qs)
    paths["vocode_pml_te"] = te["counts"]
    paths["analyze_pml_te"] = te["analysis"]["counts"]
    variants = _analysis_variants_path(dev, qs)
    paths.update({f"analyze_{label.replace(' ', '_')}": run["counts"]
                  for label, run in variants.items()})
    cli10 = _cli_vocoder_path(dev, smi, qs, "te")
    paths.update({f"cli_te_{cmd}": c for cmd, c in cli10["counts"].items()})
    for name, by_route in cli10["train_routes"].items():
        for route, n in by_route.items():
            routes[name][route] += n
    t_phase11 = time.perf_counter()
    # 11. the serving export: config 3 and the BGRU as generator artifacts,
    # the PML and Griffin-Lim synthesis artifacts, cli export on phase 8's
    # workdir, and what the registered operators cost the host
    exported = {"cnn_blstm": _export_generator_path(dev, "cnn_blstm", EXPORT_BOUNDS),
                "bgru": _export_generator_path(dev, "bgru", (BGRU_EXPORT_BOUND,))}
    cli11 = _cli_export_path(dev, smi, qs, cli_export)
    mel_feats = _mel_requests(dev)
    syn11 = _export_synthesis_path(dev, smi, {"pml": serve["cnn_blstm"]["feats"],
                                              "melspec": mel_feats}, cli11.pop("syn"))
    dispatch = _dispatch_cost(dev, smi, mel_feats)
    for kind, run in exported.items():
        paths[f"export_{kind}"] = run["counts"]
        for name, by_route in run["routes"].items():
            for route, n in by_route.items():
                routes[name][route] += n
    paths.update({f"export_{kind}_synthesis": run["counts"] for kind, run in syn11.items()})
    paths["cli_export"] = cli11["counts"]
    t_phase12 = time.perf_counter()
    # 12. data parallelism: config 3 through Trainer(mesh=...) over an NCCL
    # group of one against no mesh; one step over 2 gloo ranks sharing the
    # card against world size 1; cli train --mesh under torch.distributed.run
    mesh1 = _mesh_world1_path(dev, smi)
    mesh2 = _mesh_world2_path(dev, smi)
    mesh_cli = _mesh_cli_path(dev, smi, qs)
    paths["mesh_world1"] = mesh1["counts"]
    paths.update(mesh2["counts"])
    for run in (mesh1, mesh2):
        for name, by_route in run["routes"].items():
            for route, n in by_route.items():
                routes[name][route] += n
    shutil.rmtree(qs["root"], ignore_errors=True)
    t_phase13 = time.perf_counter()
    # 13. kernels #1/#2 at the widths one block cannot hold: the cluster
    # kernels' plans, each against its twin, H = 256's route, their times;
    # the blstm_size=1024 models served and trained through them
    _wide_plans(dev)
    wide = _check_wide_kernels(dev)
    wide_timed = _time_wide_kernels(dev)
    wide_runs = _cluster_models_path(dev, smi)
    wide_f32_timed = _time_wide_f32(dev)
    t_phase14 = time.perf_counter()
    # 14. kernels #3/#4 at the widths one block cannot hold: the same for the
    # GRU's cluster kernels; the BGRU at blstm_size=1024 served and trained
    _wide_plans(dev, "gru")
    wide_gru = _check_wide_gru_kernels(dev)
    wide_gru_timed = _time_wide_kernels(dev, "gru")
    wide_gru_runs = _cluster_models_path(dev, smi, WIDE_GRU_MODELS)
    wide_f32_timed.update(_time_wide_f32(dev, "gru"))
    t_phase15 = time.perf_counter()
    # 15. f32 at the default width: the narrow kernels' plans; config 3 and
    # the BGRU in f32 served and trained through them (forwards and BPTTs);
    # those kernels timed beside the ones they replaced
    _narrow_plans(dev)
    narrow_runs = _cluster_models_path(dev, smi, NARROW_MODELS)
    narrow_timed = {}
    for cell in ("lstm", "gru"):
        narrow_timed.update(_time_wide_f32(dev, cell, F32_SIMT_TIMED, route="narrow_f32"))
    t_phase16 = time.perf_counter()
    # 16. the f32 BPTT's few-row plan ("wide_f32" at B <= 8): its plans, the
    # kernels against their twins at the rows "wide" kept before, config 3
    # and the BGRU at blstm_size=768 trained at 8 rows through them, their times
    _few_plans(dev)
    few_err = _check_few_kernels(dev)
    few_runs = _few_models_path(dev, smi)
    few_timed = {}
    for cell in ("lstm", "gru"):
        few_timed.update(_time_wide_f32(dev, cell, F32_WIDE_KEPT[cell], what=("bwd",)))
    t_phase17 = time.perf_counter()
    # 17. the bf16 layers past the tensor-core widths ("wide_mma_stream"): the
    # plans, the four kernels against their twins and the autograd pairs,
    # config 3 and the BGRU at blstm_size=2048 served and trained through them,
    # their times in turns with the "wide" kernels they replaced there
    _stream_plans(dev)
    stream_err = _check_stream_kernels(dev)
    stream_runs = _cluster_models_path(dev, smi, STREAM_MODELS, depth=STREAM_DEPTH)
    stream_timed = _time_stream_kernels(dev)
    t_phase18 = time.perf_counter()
    # 18. the bf16 BPTTs past the 64-k layout's widths (the deep layout of
    # "wide_mma_stream"): their plans (in 17a's), both kernels against their
    # twins and the autograd pairs, config 3 and the BGRU at blstm_size=4096
    # served and trained through them, their times in turns with "wide"
    deep_err = _check_deep_kernels(dev)
    deep_runs = _cluster_models_path(dev, smi, DEEP_MODELS, depth=DEEP_DEPTH)
    deep_timed = _time_deep_kernels(dev)
    plans = {name: {"chunked": 0, "few": 0, "64k": 0, "deep": 0} for name in PLANNED}
    for kind, run in {**wide_runs, **wide_gru_runs, **narrow_runs, **few_runs,
                      **stream_runs, **deep_runs}.items():
        for what in ("serve", "train"):
            paths[f"{what}_{kind}"] = run[what]["counts"]
            for name, by_route in run[what]["routes"].items():
                for route, n in by_route.items():
                    routes[name][route] += n
            for name, by_plan in run[what]["plans"].items():
                for plan, n in by_plan.items():
                    plans[name][plan] += n
    print(f"[time] ({smi}) phases 1–9 {t_phase10 - t_start:.1f} s, phase 10 "
          f"{t_phase11 - t_phase10:.1f} s, phase 11 {t_phase12 - t_phase11:.1f} s, phase 12 "
          f"{t_phase13 - t_phase12:.1f} s, phase 13 {t_phase14 - t_phase13:.1f} s, phase 14 "
          f"{t_phase15 - t_phase14:.1f} s, phase 15 {t_phase16 - t_phase15:.1f} s, phase 16 "
          f"{t_phase17 - t_phase16:.1f} s, phase 17 {t_phase18 - t_phase17:.1f} s, phase 18 "
          f"{time.perf_counter() - t_phase18:.1f} s, total {time.perf_counter() - t_start:.1f} s")

    sources = {
        "bilstm_fwd": ("bilstm_fwd_mma.cu", "percivaltts_tpu/ops/lstm_pallas.py:202"),
        "bilstm_bwd": ("bilstm_bwd_mma.cu", "percivaltts_tpu/ops/lstm_pallas.py:321"),
        "bigru_fwd": ("bigru_fwd_mma.cu", "percivaltts_tpu/ops/lstm_pallas.py:521"),
        "bigru_bwd": ("bigru_bwd_mma.cu", "percivaltts_tpu/ops/lstm_pallas.py:616"),
        "frame_window": ("frame_window.cu", "percivaltts_tpu/ops/pallas_kernels.py:115"),
        "overlap_add": ("overlap_add.cu", "percivaltts_tpu/ops/pallas_kernels.py:184"),
    }
    library_calls = {
        "frame_window": "F.unfold of the zero-padded signal times the window",
        "overlap_add": "F.fold cut to the centred span",
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        by_path = {p: c[name] for p, c in paths.items()}
        first = timed[name][0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"percivaltts_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_err[name],
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library_device_ms": first.get("library_device_ms"),
            "library_call": library_calls.get(name) or (
                ("torch.nn.GRU" if "gru" in name else "torch.nn.LSTM")
                + (" forward, beside the port's layer (layer_ms)" if name.endswith("fwd")
                   else " backward, beside the port layer's backward (layer_ms)")),
            "layer_ms": first.get("layer_ms"),
            "layer_device_ms": first.get("layer_device_ms"),
            "timed": timed[name],
        })
        if name in ("frame_window", "overlap_add"):
            kernels[-1]["share_of_bound"] = first["share_of_bound"]
            kernels[-1]["floor_ms"] = first["floor_ms"]
        if name in ROUTED:  # the tensor-core route: mma.sync, bf16, H % 16 == 0, H <= 128
            kernels[-1]["fwd_route" if name.endswith("fwd") else "bwd_route"] = first["route"]
            kernels[-1]["launches_by_route"] = routes[name]
        if not any(by_path.values()):
            raise AssertionError(f"{name} was launched no time on the paths")
    # the tensor-core cluster kernels (the "wide_mma" route): kernels #1/#2 on
    # phase 13's paths, #3/#4 on phase 14's; the CUDA-core cluster kernels
    # they replaced there ("wide") timed beside them
    for name, route, src, replaces in (
        ("bilstm_fwd", "wide_mma", "bilstm_fwd_wide_mma.cu",
         "percivaltts_tpu/ops/lstm_pallas.py:202"),
        ("bilstm_bwd", "wide_mma", "bilstm_bwd_wide_mma.cu",
         "percivaltts_tpu/ops/lstm_pallas.py:321"),
        ("bigru_fwd", "wide_mma", "bigru_fwd_wide_mma.cu",
         "percivaltts_tpu/ops/lstm_pallas.py:521"),
        ("bigru_bwd", "wide_mma", "bigru_bwd_wide_mma.cu",
         "percivaltts_tpu/ops/lstm_pallas.py:616"),
    ):
        gru = name.startswith("bigru")
        checked, timed_w, runs_w = (wide_gru, wide_gru_timed, wide_gru_runs) if gru else \
            (wide, wide_timed, wide_runs)
        first = timed_w[name][0]
        by_path = {f"{what}_{kind}": run[what]["routes"][name][route]
                   for kind, run in runs_w.items() for what in ("serve", "train")}
        kernels.append({
            "name": f"{name}_{route}",
            "route": "cuda",
            "source": f"percivaltts_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": routes[name][route],
            "launches_by_path": by_path,
            "max_abs_err": checked["err"][f"{name}_{route}"],
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library_device_ms": first["library_device_ms"],
            "library_call": f"torch.nn.{'GRU' if gru else 'LSTM'}(hidden_size=512, "
                            "bidirectional=True) "
                            + ("forward" if name.endswith("fwd") else "backward")
                            + ", beside the port layer's (layer_ms, layer_device_ms)",
            "layer_ms": first["layer_ms"],
            "layer_device_ms": first["layer_device_ms"],
            "kernel_device_ms": first["kernel_device_ms"],
            "timed": timed_w[name],
            "route_shape_ms": checked["route_ms"],
        })
        if "earlier_ms" in first:  # the CUDA-core cluster kernel it replaced on these paths
            kernels[-1].update({
                "earlier_source": f"percivaltts_tpu_torch/csrc/{name}_wide.cu",
                "earlier_ms": first["earlier_ms"],
                "earlier_max_abs_err": checked["err"][name],
            })
        if not routes[name][route] or sum(by_path.values()) != routes[name][route]:
            raise AssertionError(f"{name}'s {route} kernel was launched no time on phase "
                                 f"{14 if gru else 13}'s paths, or also elsewhere")
    # the f32 forms of phases 13/14's paths: the f32 cluster forwards and
    # BPTTs ("wide_f32"); the CUDA-core cluster kernels they replaced there
    # ("wide", timed beside them) stay listed, with their launches on the
    # paths (none)
    for name, route, replaces in (
        ("bilstm_fwd", "wide_f32", "percivaltts_tpu/ops/lstm_pallas.py:202"),
        ("bilstm_fwd", "wide", "percivaltts_tpu/ops/lstm_pallas.py:202"),
        ("bilstm_bwd", "wide_f32", "percivaltts_tpu/ops/lstm_pallas.py:321"),
        ("bilstm_bwd", "wide", "percivaltts_tpu/ops/lstm_pallas.py:321"),
        ("bigru_fwd", "wide_f32", "percivaltts_tpu/ops/lstm_pallas.py:521"),
        ("bigru_fwd", "wide", "percivaltts_tpu/ops/lstm_pallas.py:521"),
        ("bigru_bwd", "wide_f32", "percivaltts_tpu/ops/lstm_pallas.py:616"),
        ("bigru_bwd", "wide", "percivaltts_tpu/ops/lstm_pallas.py:616"),
    ):
        gru = name.startswith("bigru")
        checked, runs_w = (wide_gru, wide_gru_runs) if gru else (wide, wide_runs)
        # phase 16's forwards run "wide_f32" too; phase 17's bf16 forwards ran
        # "wide" until the streamed forwards replaced them (0 launches there);
        # phase 18's bf16 forwards run "wide"
        runs_w = {**runs_w, **few_runs, **stream_runs, **deep_runs}
        # a BPTT's row of its chunked kernel (R > 4; at B = 8 the GRU's H = 512
        # takes the few-row kernels, listed below)
        first = next(r for r in wide_f32_timed[name] if r.get("rows", 8) > 4)
        replaced = route == "wide"  # timed as the earlier kernel
        chunked = name.endswith("bwd") and route == "wide_f32"  # counted by its plan
        by_path = {f"{what}_{kind}": (run[what]["plans"][name]["chunked"] if chunked else
                                      run[what]["routes"][name][route])
                   for kind, run in runs_w.items() for what in ("serve", "train")}
        total = plans[name]["chunked"] if chunked else routes[name][route]
        err_key = f"{name}_wide_f32" + ("_earlier" if replaced else "")
        kernels.append({
            "name": f"{name}_{route}",
            "route": "cuda",
            "source": f"percivaltts_tpu_torch/csrc/{name}_{route}.cu",
            "replaces": replaces,
            "launches": total,
            "launches_by_path": by_path,
            "max_abs_err": checked["err"][err_key],
            "dtype": "float32",
            "ms": first["earlier_ms"] if replaced else first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library_device_ms": first["library_device_ms"],
            "library_call": f"torch.nn.{'GRU' if gru else 'LSTM'}(hidden_size=512, "
                            "bidirectional=True) in f32 (TF32 off) "
                            + ("forward" if name.endswith("fwd") else "backward")
                            + ", beside the port layer's (layer_ms, layer_device_ms)",
            "layer_ms": first["layer_ms"],
            "layer_device_ms": first["layer_device_ms"],
            "timed": wide_f32_timed[name],
        })
        if replaced:  # the port's layer runs the kernel that replaced it
            kernels[-1].update({"replaced_on_the_paths_by": f"{name}_wide_f32",
                                "layer_ms": None, "layer_device_ms": None})
            continue
        if route == "wide_f32":
            kernels[-1].update({"kernel_device_ms": first["kernel_device_ms"],
                                "earlier_source": f"percivaltts_tpu_torch/csrc/{name}_wide.cu",
                                "earlier_ms": first["earlier_ms"],
                                "earlier_max_abs_err": checked["err"][f"{name}_wide_f32_earlier"],
                                "ptxas": [line for line in _ptxas_usage(BUILD_LOG)
                                          if f"{name}_wide_f32_kernel" in line]})
        if chunked:
            kernels[-1]["timed_shape"] = first["shape"]
        if not total or sum(by_path.values()) != total:
            raise AssertionError(f"{name}'s {route} kernel was launched no time on phase "
                                 f"{14 if gru else 13}'s or 16's f32 paths, or also elsewhere")
    # phase 16: the few-row kernels of the f32 BPTT ("wide_f32" at B <= 8,
    # csrc/wide_f32_few.cuh), timed in turns with the "wide" kernel they
    # replaced at those rows
    for name, replaces in (("bilstm_bwd", "percivaltts_tpu/ops/lstm_pallas.py:321"),
                           ("bigru_bwd", "percivaltts_tpu/ops/lstm_pallas.py:616")):
        gru = name.startswith("bigru")
        first = few_timed[name][0]
        by_path = {f"{what}_{kind}": run[what]["plans"][name]["few"]
                   for kind, run in few_runs.items() for what in ("serve", "train")}
        kernels.append({
            "name": f"{name}_wide_f32_few",
            "route": "cuda",
            "source": f"percivaltts_tpu_torch/csrc/{name}_wide_f32.cu",
            "body": "percivaltts_tpu_torch/csrc/wide_f32_few.cuh",
            "replaces": replaces,
            "launches": plans[name]["few"],
            "launches_by_path": by_path,
            "max_abs_err": few_err[f"{name}_wide_f32_few"],
            "dtype": "float32",
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library_device_ms": first["library_device_ms"],
            "library_call": f"torch.nn.{'GRU' if gru else 'LSTM'}(hidden_size={first['shape'][2]}, "
                            "bidirectional=True) in f32 (TF32 off) backward, beside the port "
                            "layer's (layer_ms, layer_device_ms)",
            "layer_ms": first["layer_ms"],
            "layer_device_ms": first["layer_device_ms"],
            "kernel_device_ms": first["kernel_device_ms"],
            "timed_shape": first["shape"],
            "rows": first["rows"],
            "earlier_source": f"percivaltts_tpu_torch/csrc/{name}_wide.cu",
            "earlier_ms": first["earlier_ms"],
            "earlier_max_abs_err": few_err[f"{name}_wide_f32_few_earlier"],
            "timed": few_timed[name],
            "ptxas": [line for line in _ptxas_usage(BUILD_LOG) if f"{name}_wide_f32_few" in line],
        })
        if not plans[name]["few"] or sum(by_path.values()) != plans[name]["few"]:
            raise AssertionError(f"{name}'s few-row kernels were launched no time on phase 16's "
                                 "paths, or also elsewhere")
    # phase 17: the streamed tensor-core BPTTs and forwards ("wide_mma_stream",
    # csrc/wide_mma_stream.cuh), timed in turns with the "wide" kernels they
    # replaced at those widths
    for name, replaces in (("bilstm_bwd", "percivaltts_tpu/ops/lstm_pallas.py:321"),
                           ("bilstm_fwd", "percivaltts_tpu/ops/lstm_pallas.py:202"),
                           ("bigru_bwd", "percivaltts_tpu/ops/lstm_pallas.py:616"),
                           ("bigru_fwd", "percivaltts_tpu/ops/lstm_pallas.py:521")):
        gru = name.startswith("bigru")
        what = "forward" if name.endswith("fwd") else "backward"
        first = stream_timed[name][0]
        route = "wide_mma_stream"
        # the BPTTs counted by layout: phase 18's paths run the deep one (below)
        bwd = name.endswith("bwd")
        by_path = {f"{what}_{kind}": (run[what]["plans"][name]["64k"] if bwd else
                                      run[what]["routes"][name][route])
                   for kind, run in stream_runs.items() for what in ("serve", "train")}
        total = plans[name]["64k"] if bwd else routes[name][route]
        kernels.append({
            "name": f"{name}_{route}",
            "route": "cuda",
            "source": f"percivaltts_tpu_torch/csrc/{name}_{route}.cu",
            "body": "percivaltts_tpu_torch/csrc/wide_mma_stream.cuh",
            "replaces": replaces,
            "launches": total,
            "launches_by_path": by_path,
            "max_abs_err": stream_err[f"{name}_{route}"],
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library_device_ms": first["library_device_ms"],
            "library_call": f"torch.nn.{'GRU' if gru else 'LSTM'}(hidden_size={first['shape'][2]}, "
                            f"bidirectional=True) bf16 {what}, beside the port layer's "
                            "(layer_ms, layer_device_ms)",
            "layer_ms": first["layer_ms"],
            "layer_device_ms": first["layer_device_ms"],
            "kernel_device_ms": first["kernel_device_ms"],
            "timed_shape": first["shape"],
            "earlier_source": f"percivaltts_tpu_torch/csrc/{name}_wide.cu",
            "earlier_ms": first["earlier_ms"],
            "earlier_device_ms": first["earlier_device_ms"],
            "earlier_max_abs_err": stream_err[f"{name}_{route}_earlier"],
            "timed": stream_timed[name],
            "ptxas": [line for line in _ptxas_usage(BUILD_LOG)
                      if f"{name}_{route}_kernel" in line],
        })
        if not total or sum(by_path.values()) != total:
            raise AssertionError(f"{name}'s {route} kernel was launched no time on phase 17's "
                                 "paths, or also elsewhere")
    # phase 18: the streamed BPTTs' deep layout past the 64-k layout's widths
    # (csrc/wide_mma_stream.cuh), timed in turns with the "wide" kernels it
    # replaced there
    for name, replaces in (("bilstm_bwd", "percivaltts_tpu/ops/lstm_pallas.py:321"),
                           ("bigru_bwd", "percivaltts_tpu/ops/lstm_pallas.py:616")):
        gru = name.startswith("bigru")
        first = deep_timed[name][0]
        by_path = {f"{what}_{kind}": run[what]["plans"][name]["deep"]
                   for kind, run in deep_runs.items() for what in ("serve", "train")}
        kernels.append({
            "name": f"{name}_wide_mma_stream_deep",
            "route": "cuda",
            "source": f"percivaltts_tpu_torch/csrc/{name}_wide_mma_stream.cu",
            "body": "percivaltts_tpu_torch/csrc/wide_mma_stream.cuh",
            "replaces": replaces,
            "launches": plans[name]["deep"],
            "launches_by_path": by_path,
            "max_abs_err": deep_err[f"{name}_wide_mma_stream_deep"],
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library_device_ms": first["library_device_ms"],
            "library_call": f"torch.nn.{'GRU' if gru else 'LSTM'}(hidden_size={first['shape'][2]}, "
                            "bidirectional=True) bf16 backward, beside the port layer's "
                            "(layer_ms, layer_device_ms)",
            "layer_ms": first["layer_ms"],
            "layer_device_ms": first["layer_device_ms"],
            "kernel_device_ms": first["kernel_device_ms"],
            "timed_shape": first["shape"],
            "earlier_source": f"percivaltts_tpu_torch/csrc/{name}_wide.cu",
            "earlier_ms": first["earlier_ms"],
            "timed": deep_timed[name],
            "ptxas": [line for line in _ptxas_usage(BUILD_LOG)
                      if f"{name}_wide_mma_stream_deep_kernel" in line],
        })
        if not plans[name]["deep"] or sum(by_path.values()) != plans[name]["deep"]:
            raise AssertionError(f"{name}'s deep streamed kernels were launched no time on phase "
                                 "18's paths, or also elsewhere")
    # phase 15's f32 paths at the default width: the narrow forwards and
    # BPTTs ("narrow_f32"); the one-block kernels they replaced there (timed
    # beside them) stay listed, with their launches on the paths (none)
    for name, route, src, replaces in (
        ("bilstm_fwd", "narrow_f32", "bilstm_fwd_narrow_f32.cu",
         "percivaltts_tpu/ops/lstm_pallas.py:202"),
        ("bilstm_fwd", "simt", "bilstm_fwd.cu", "percivaltts_tpu/ops/lstm_pallas.py:202"),
        ("bilstm_bwd", "narrow_f32", "bilstm_bwd_narrow_f32.cu",
         "percivaltts_tpu/ops/lstm_pallas.py:321"),
        ("bilstm_bwd", "simt", "bilstm_bwd.cu", "percivaltts_tpu/ops/lstm_pallas.py:321"),
        ("bigru_fwd", "narrow_f32", "bigru_fwd_narrow_f32.cu",
         "percivaltts_tpu/ops/lstm_pallas.py:521"),
        ("bigru_fwd", "simt", "bigru_fwd.cu", "percivaltts_tpu/ops/lstm_pallas.py:521"),
        ("bigru_bwd", "narrow_f32", "bigru_bwd_narrow_f32.cu",
         "percivaltts_tpu/ops/lstm_pallas.py:616"),
        ("bigru_bwd", "simt", "bigru_bwd.cu", "percivaltts_tpu/ops/lstm_pallas.py:616"),
    ):
        gru = name.startswith("bigru")
        first = narrow_timed[name][0]
        replaced = route == "simt"  # timed as the earlier kernel
        by_path = {f"{what}_{kind}": run[what]["routes"][name][route]
                   for kind, run in narrow_runs.items() for what in ("serve", "train")}
        err_key = f"{name}_{route}" + ("_f32" if route == "simt" else "")
        kernels.append({
            "name": f"{name}_{route}_f32" if route == "simt" else f"{name}_{route}",
            "route": "cuda",
            "source": f"percivaltts_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": routes[name][route],
            "launches_by_path": by_path,
            "max_abs_err": max_err[err_key],
            "dtype": "float32",
            "ms": first["earlier_ms"] if replaced else first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library_device_ms": first["library_device_ms"],
            "library_call": f"torch.nn.{'GRU' if gru else 'LSTM'}(hidden_size=128, "
                            "bidirectional=True) in f32 (TF32 off) "
                            + ("forward" if name.endswith("fwd") else "backward")
                            + ", beside the port layer's (layer_ms, layer_device_ms)",
            "layer_ms": first["layer_ms"],
            "layer_device_ms": first["layer_device_ms"],
            "timed": narrow_timed[name],
        })
        if replaced:  # the port's layer runs the kernel that replaced it
            kernels[-1].update({"replaced_on_the_paths_by": f"{name}_narrow_f32",
                                "layer_ms": None, "layer_device_ms": None})
            continue
        if route == "narrow_f32":
            kernels[-1].update({"kernel_device_ms": first["kernel_device_ms"],
                                "earlier_source": f"percivaltts_tpu_torch/csrc/{name}.cu",
                                "earlier_ms": first["earlier_ms"],
                                "earlier_max_abs_err": max_err[f"{name}_simt_f32"]})
        if not routes[name][route] or sum(by_path.values()) != routes[name][route]:
            raise AssertionError(f"{name}'s {route} kernel was launched no time on phase 15's "
                                 "f32 paths, or also elsewhere")
    for kind in ("cnn_blstm", "bgru"):
        print(f"[summary] {kind}: serve median {serve[kind]['serve_ms']:.3f} ms, step median "
              f"{train[kind]['step_ms']:.3f} ms, device busy share "
              f"{train[kind]['busy_share']}")
    print(f"[summary] vocode_pml: {vocode['audio_s']:.2f} s of audio in a median "
          f"{vocode['vocode_ms']:.3f} ms, device busy share {vocode['busy_share']}, framing and "
          f"overlap-add device time {vocode['dsp_device_ms']} ms a vocode")
    print(f"[summary] train loop ({smi}): epochs "
          + ", ".join(f"{r['sec']:.3f} s ({r['frames_per_sec']:.1f} frames/s)"
                      for r in loop["records"])
          + f"; profiled epochs' device busy share {[b and round(b[2], 4) for b in loop['busy']]}")
    print(f"[summary] quick start ({smi}): demo {qs['demo_s']:.2f} s, compose {qs['compose_s']:.2f} "
          f"s ({qs['audio_s'] / qs['compose_s']:.1f} s of audio per s), config-1 epochs "
          + ", ".join(f"{r['sec']:.3f} s ({qs['real_frames'] / r['sec']:.1f} real frames/s)"
                      for r in qs["records"])
          + f", measure validations {', '.join(f'{x:.3f}' for x in qs['measure_s'])} s, generate "
          f"{qs['generate_s']:.3f} s (real-time factor {qs['generate_s'] / qs['gen_audio_s']:.4f}), "
          f"test mcd {qs['measures']['mcd_db']:.4f} dB; profiled device-corpus epochs' busy share "
          f"config 1 {qs['busy']}, config 3 {qs3['busy']}; config 3 epoch "
          f"{qs3['record']['sec']:.3f} s")
    for kind, run in (("melspec", mel), ("world", world)):
        print(f"[summary] vocode_{kind} ({smi}): {run['audio_s']:.2f} s of audio in a median "
              f"{run['vocode_ms']:.3f} ms (real-time factor {run['vocode_ms'] / 1e3 / run['audio_s']:.4f}), "
              f"device busy share {run['busy_share']}, framing and overlap-add device time "
              f"{run['dsp_device_ms']} ms a vocode, launches {run['counts']}; analysis of the demo "
              f"wavs {run['analysis']['wall_s']:.3f} s")
    for kind, run in {**cli9, "te": cli10}.items():
        print(f"[summary] cli {kind} ({smi}): compose {run['compose_s']:.2f} s, train "
              f"{run['train_s']:.2f} s (epochs " + ", ".join(f"{r['sec']:.3f} s" for r in run["records"])
              + f"), generate {run['generate_s']:.3f} s (real-time factor "
              f"{run['generate_s'] / run['gen_audio_s']:.4f}), test measures {run['measures']}")
    for kind, base in (("cnn_blstm_2d", "cnn_blstm"), ("bgru_ln", "bgru")):
        print(f"[summary] {kind} ({smi}): serve median {serve[kind]['serve_ms']:.3f} ms "
              f"({serve[kind]['serve_ms'] / serve[base]['serve_ms']:.3f}x {base}'s "
              f"{serve[base]['serve_ms']:.3f}), step median {train[kind]['step_ms']:.3f} ms "
              f"({train[kind]['step_ms'] / train[base]['step_ms']:.3f}x {base}'s "
              f"{train[base]['step_ms']:.3f}), device busy share {train[kind]['busy_share']} "
              f"({base}: {train[base]['busy_share']})")
    print(f"[summary] vocode_pml_te ({smi}): {te['audio_s']:.2f} s of audio in a median "
          f"{te['vocode_ms']:.3f} ms (real-time factor {te['vocode_ms'] / 1e3 / te['audio_s']:.4f}), "
          f"device busy share {te['busy_share']}, framing and overlap-add device time "
          f"{te['dsp_device_ms']} ms a vocode, launches {te['counts']}; analysis of the demo wavs "
          f"{te['analysis']['wall_s']:.3f} s; analysis variants "
          + ", ".join(f"{label} {run['wall_s']:.3f} s" for label, run in variants.items()))
    for kind, run in exported.items():
        print(f"[summary] export {kind} ({smi}): batch-{EXPORT_BATCH} artifacts "
              f"{run['serve_ms']['artifact']:.3f} ms against eager serve "
              f"{run['serve_ms']['eager serve']:.3f} ms (median); export s {run['export_s']}, "
              f"save {run['save_s']:.3f} s, load {run['load_s']:.3f} s, bytes {run['bytes']}")
    for kind, run in syn11.items():
        print(f"[summary] export {kind} synthesis ({smi}): artifact {run['ms']['artifact']:.3f} "
              f"ms against synthesize_batch {run['ms']['synthesize_batch']:.3f} ms (median)"
              + ("; cli export's artifact" if kind == "pml" else
                 f"; {run['nodes']} nodes, export {run['export_s']:.2f} s, save "
                 f"{run['save_s']:.2f} s, load {run['load_s']:.2f} s, {run['bytes']} bytes"))
    print(f"[summary] cli export ({smi}): {cli11['export_s']:.2f} s (load of its artifacts "
          f"{cli11['load_s']:.2f} s), bytes {cli11['bytes']}; "
          f"{cli11['audio_s']:.2f} s of audio served through the artifacts in "
          f"{cli11['serve_s']:.3f} s; dispatch: the operator {dispatch['us']['op']:.2f} µs a "
          f"call against {dispatch['us']['eager']:.2f} eager, Griffin-Lim "
          f"{dispatch['vocode_ms']['op']:.3f} against {dispatch['vocode_ms']['eager']:.3f} ms")
    print(f"[summary] data parallelism ({smi}): config 3's Trainer over an NCCL group of one, "
          "epochs " + ", ".join(f"{r['sec']:.3f} s" for r in mesh1["records"]) + " against "
          + ", ".join(f"{r['sec']:.3f} s" for r in mesh1["records_no_mesh"]) + " without a mesh; "
          f"WGAN-GP step {mesh1['step_ms']['mesh']:.3f} ms against "
          f"{mesh1['step_ms']['no mesh']:.3f} ms ({mesh1['all_reduces']} all-reduces a step); "
          f"2 gloo ranks on one card {mesh2['step_ms']} ms a step (not a scaling number), "
          f"per-process corpus blocks {mesh2['per_process_bytes']} bytes against "
          f"{mesh2['layout_bytes']}; "
          f"torchrun cli train --mesh {mesh_cli['wall_s']:.2f} s, its epoch "
          f"{mesh_cli['record']['sec']:.3f} s")
    for kind, run in {**wide_runs, **wide_gru_runs, **narrow_runs, **few_runs,
                      **stream_runs, **deep_runs}.items():
        print(f"[summary] {kind} ({smi}): serve median {run['serve']['serve_ms']:.3f} ms (busy "
              f"share {run['serve']['busy_share']}), step median {run['train']['step_ms']:.3f} ms "
              f"(busy share {run['train']['busy_share']}); launches {run['serve']['counts']} a "
              f"serve, {run['train']['counts']} in {run['train']['checked']} steps")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
