"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no ``ok`` line:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of ``video_features_tpu_torch/csrc`` (timed);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time the kernel, the plain version, one
   PyTorch library call computing the same function (a yardstick only,
   never called by the port) and the least time the card could take,
   with that bound's share of the kernel's time (K1 also at L=65, one
   row past a KV tile, and at d=128); then K1 and K2 at the fused shapes
   of phase 13 (K1 at N=64, K2 at N=16 and N=128), each with a profiler
   window of its own while the profiler still keeps every launch, and the
   banded resample of ``--preprocess device`` (plain torch ops) at the
   main paths' shapes: its time, device time, launches and bytes bound;
4. the CLIP path through the port's CLI: CLIP-ViT-B/32 at full width
   (768 wide, 12 layers, 12 heads, 224 px, patch 32, 512-d), ``uni_12``,
   ``--attn flash``, seeded random weights, on 4 synthetic clips; checks
   the .npy files, K1's launch count (4 videos x 12 layers), the
   features against ``--attn fused`` on the card and against the port's
   CPU run, and prints videos/s;
5. the I3D path through the port's CLI: ``--feature_type i3d --flow_type
   pwc`` at full width (I3D rgb and flow, PWC-Net), default 64/64
   stacks, seeded random weights, on 2 synthetic 320x240 clips of 129
   frames (2 stacks each); checks the ``_rgb``/``_flow`` .npy files, K2's
   launch count (2 videos x 2 stacks x 5 pyramid levels), PWC's flow and
   the flow features with K2 against the plain cost volume on the card,
   and the features on the card against the port's CPU run; prints the
   warm videos/s split into host and forward, and one stack's top device
   kernels with K2's share;
6. the PWC path through the port's CLI: ``--feature_type pwc
   --batch_size 8`` on a 60-frame clip; checks the (59, 2, 240, 320) flow
   and K2's launch count (8 windows x 5 levels);
7. the I3D + RAFT path through the port's CLI: ``--feature_type i3d
   --flow_type raft`` at full width (RAFT with 20 iterations), default
   64/64 stacks, on the clips of phase 5: 64 pairs a stack at 256x341
   padded to 256x344; checks the ``_rgb``/``_flow`` .npy files, that K1
   and K2 launch 0 times, and an 11-frame stack's RAFT flow, uint8 flow
   levels and features on the card against the port on the CPU; prints
   the warm videos/s split into host and forward, one stack's top device
   kernels, RAFT's stages on that stack (encoders, volume, lookup,
   update convolutions, upsampling) with their shares, and each update
   convolution alone with its top kernel;
8. the RAFT path: ``--feature_type raft --batch_size 8`` on a 330x250
   clip of 30 frames (padded to 336x256 and unpadded); checks the
   (29, 2, 250, 330) flow and prints warm videos/s;
9. the ResNet-50 path: ``--feature_type resnet50 --batch_size 16`` on a
   60-frame clip; checks the (60, 2048) features, card vs CPU on a
   16-frame clip, and prints warm videos/s and one forward's kernels;
10. the R(2+1)D-18 path: ``--feature_type r21d_rgb`` on a 64-frame clip;
    checks the (4, 512) features, card vs CPU on a 16-frame clip, and
    prints warm videos/s and one forward's kernels;
11. the VGGish path: ``--feature_type vggish`` on four 60 s stereo
    44.1 kHz wavs and one of 600 s (``utils/synth.py::synth_wav``);
    checks the (62, 128) and (624, 128) embeddings, card vs CPU on one
    60 s wav, and prints warm videos/s split into host (read, resample,
    log-mel) and forward, and the 600 s forward's kernels and idle share;
12. the run contract on the CLIP path (full width, ``uni_12``, ``--attn
    flash``, 8 clips): ``--decode_workers 0`` against 2 (features within
    1e-6, 96 K1 launches each; cold and warm videos/s), ``--fault_inject
    prepare:error:3`` recovered to 8/8 done with the clean features, and
    ``--strict`` exiting nonzero on a corrupt clip recorded failed and
    permanent while the good clips' files are written;
13. async ingest (the JAX package's ``_run_pipelined`` loop): CLIP (full
    width, ``uni_12``, ``--attn flash``) on phase 12's 8 clips at
    ``--video_batch 1, 4, 8`` x ``--inflight_groups 1, 2`` through the CLI
    (features within 1e-4 of ``--video_batch 1 --inflight_groups 1``, K1
    launches = 12 x fused dispatches), the warm videos/s of each setting
    over two passes, the pinning time of a fused group and the idle share
    of a fused forward, and ``--fault_inject dispatch:error:2`` at
    ``--video_batch 4`` recovered to 8/8 done through a ``group_fallback``;
    ResNet-50, R(2+1)D-18 and VGGish at ``--video_batch 4`` on 4 short
    inputs against ``--video_batch 1`` with warm videos/s; ``pwc
    --batch_size 8 --video_batch 2`` on two 30-frame clips and I3D + PWC
    ``--batch_size 2 --video_batch 2`` on two 65-frame clips against their
    solo runs, with K2 launches = 5 x fused forwards;
14. device preprocess: ``--preprocess device`` against ``host`` through
    the CLI on CLIP (phase 12's 8 clips, ``--attn flash``; features within
    5e-3), ResNet-50 (``--batch_size 16``, 60 frames; relative L2 within
    5e-3), RAFT and PWC (``--batch_size 8``, no ``--side_size``: the model
    input equal bit for bit, the flows within 1e-4 of the largest beside a
    second host run's spread) and I3D + PWC (64/64 stacks, phase 5's clips; relative L2
    within 5e-3), K1 and K2 launching as often as on the host path; CLIP's
    ``--video_batch 4`` device groups against its device solo run (1e-4);
    each family's warm serial videos/s in both modes with the host ms
    split into decode and preprocess; CLIP's warm pipelined videos/s in
    both modes; the bytes and pinning time of a ``--video_batch 4`` group
    and a fused forward's idle share in both modes;
15. telemetry and preflight, at the CLI's defaults (``--telemetry on``,
    ``--preflight on``): CLIP (full width, ``uni_12``, ``--attn flash
    --decode_workers 2 --preprocess device --profile_dir``) on phase 12's
    8 clips plus a 4 KiB file of random bytes and an empty file, both
    failed at stage ``preflight``, permanent, one attempt, no retry; every
    span row valid against ``telemetry/spans_schema.json``, every done
    video with ``decode``/``prepare``/``dispatch``/``fetch``/``sink``
    spans, ``summary.json``'s telemetry block with its throughput and
    overlap report (printed), and K1's kernel 96 times in the
    ``--profile_dir`` trace; I3D + PWC on one 129-frame clip under
    ``--profile_dir`` with K2's kernel 10 times in its trace (both runs in
    turn in one fresh process: ``cli_in_fresh_process``);
    ``--telemetry off`` on 4 of the clips (no ``_telemetry/``, the same
    features); and the telemetry's bookkeeping a video (on minus off over
    2000 videos on this host) under 1% of CLIP's ms/video, cold and warm;
16. ``--dtype bfloat16``: CLIP (``uni_12 --attn flash``, phase 4's 4
    clips), ResNet-50, R(2+1)D-18, RAFT and PWC (the clips of phases 9,
    10, 8 and 6) and I3D + PWC and I3D + RAFT (one 129-frame clip of
    phases 5 and 7) through the CLI at ``--dtype float32`` and
    ``bfloat16``: the bf16 files fp32 at the fp32 shapes and within the
    family's relative L2 ceiling of them (``config.PARITY_CEILINGS``:
    "e2e", I3D's flow "e2e_flow", else "model"); K1 48 and K2 40 (PWC)
    and 10 (I3D + PWC) launches at both dtypes, equal in a
    ``--profile_dir`` trace of the bf16 run made again in one fresh
    process for the three traced families (``cli_in_fresh_process``),
    with K1 fed bf16 q/k/v and K2 fp32 inputs; warm videos/s at both
    dtypes and one bf16 forward's top kernels, beside the card's name and
    power limit; and K1 in bf16 at the CLIP path's shape against its
    plain version;
17. the serve daemon (``video_features_tpu_torch/serve/``): the batch
    CLI twice on phase 12's 8 clips with ``--cache_dir`` (the repeat is 8
    ``cache_hit`` records, no K1 launch, byte-equal files); ``--feature_types
    CLIP-ViT-B/32 resnet50`` on phase 9's clip (one decode in the frame
    cache, both models' files within their gates of the single-model
    runs); then the daemon in this process on the card (``--feature_types
    CLIP-ViT-B/32 i3d --flow_type pwc --attn flash --max_group_size 4
    --port 0 --cache_dir``, CLIP warmed at 320x240): over HTTP on
    127.0.0.1 a burst of the 8 CLIP requests, the 2 I3D requests of
    phase 5's clips and one fan-out request naming both models on its
    65-frame clip, each polled to a terminal state; CLIP within 1e-4 of
    the batch run (the fan-out's CLIP file too, against a batch run on its
    clip), I3D + PWC within phase 5's gates (the fan-out's against phase
    5's card features of its clip), K1 = 12 x CLIP
    forwards and K2 = 5 x I3D + PWC forwards (the CLIP groups printed,
    and 2 when the burst lands inside ``--max_batch_wait_ms``); the burst
    again, all cache hits at admission with no launch and byte-equal
    files; ``/healthz``, ``/metrics`` (valid Prometheus text with the
    stage and SLO families) and ``/v1/requests/<id>``; then the device
    cost ledger (``telemetry/ledger.py``) against the card, for CLIP and
    for I3D + PWC: every entry a memory block with ``temp_bytes``, a
    projection for both models, CLIP's flops per image within 10% of
    2 x 4.41 G (ViT-B/32 at 224 px), the sampler's four gauges of the card
    and its headroom, ``vft_hbm_bytes`` and ``vft_device_mem_bytes`` in
    valid ``/metrics`` text, a ledger capture's cost on CLIP's 64-image
    forward against its first served group; each model's largest group
    again (4 fresh CLIP clips coalesced, one fresh I3D stack) with
    nothing to capture, for its peak P; CLIP evicted (the fall E in
    ``memory_allocated``), rebuilt by one more request (12 K1 launches,
    its ledger entry re-recorded: ``n_compiles`` 2, footprint within 5%),
    then I3D + PWC evicted; per model W (its weights and buffers) <= E <=
    its projected ``resident`` and ``resident`` within [0.9, 1.25] x P;
    shutdown with drain leaving no request non-terminal; a second daemon
    on the same output path with ``--hbm_budget_bytes`` one byte below
    the two models' projected sum failing its warmup with the JAX
    package's message, and one at the sum passing; the warmup seconds,
    the burst's p50/p95 latency on a miss and on a hit, and the phase's
    wall, beside the card's name and power limit;
18. flow read from disk and the output flags, on phase 5's 65-frame clip
    (64-frame stacks at 256x341): PWC ``--side_size 256 --on_extraction
    save_jpg`` (64 ``flow_x``/``flow_y`` pairs, read back against
    ``flow_quantize_uint8_np`` of the same run's ``.npy``: mean level
    difference within 1.5, K2 = 5 x forwards); I3D ``--flow_type flow
    --flow_paths`` on those JPEGs ((1, 1024) rgb and flow files, K1 and K2
    0 launches, card vs CPU within 1e-3 relative L2, the flow stream within
    0.05 of phase 5's on-the-fly I3D + PWC flow features); I3D + PWC
    ``--show_pred`` (the printed top-5 per stream, the features within
    phase 5's gates of the run without it, 5 K2 launches); PWC
    ``--show_pred`` in this process with ``flow_viz.show_flow_on_frame``
    replaced by a recorder (one finite image per pair); ``--conv3d_impl
    decomposed`` against ``direct`` for I3D's two streams and R(2+1)D-18
    (within 1e-3 relative L2, TF32 off, both forward ms); R(2+1)D-18
    ``--uint8_transfer off`` against ``on`` (equal features, the pinned
    bytes of each); and ``--fps_retarget reencode`` on phase 6's clip at
    ``--extraction_fps 10`` where ``shutil.which("ffmpeg")`` finds a
    binary (else one printed line says it was not run);
19. HBM-aware preemption against a real memory wall: a daemon with
    ``--preempt on --preempt_cooldown_s 0 --preempt_min_residency_s 0``
    on phase 17's output path (its ledger prices I3D + PWC) serves CLIP;
    a ballast tensor leaves the sampler's headroom at I3D + PWC's
    projected ``resident`` less half the smaller of the two models'; an
    I3D + PWC request on phase 5's clip then evicts CLIP at admission
    (CLIP's breaker open, a ``preempted`` event,
    ``vft_preemptions_total{feature_type="CLIP-ViT-B/32"} 1``) and is
    served behind the wall with no retry, its features within phase 5's
    gates and 5 K2 launches a forward; the ballast dropped, a CLIP request
    after the breaker's cooldown rebuilds CLIP through the half-open probe
    (a ``rewarmed`` event; features within 1e-4 of the batch CLI's, 12 K1
    launches a forward); then, the wall up again, an I3D + PWC request
    whose build fails hands the preempted CLIP back
    (``preemption_rollback``, its breaker closed, a CLIP request served);
20. the native host path (``video_features_tpu_torch/native``): first
    ``g++ --version``, both native builds and their times, the libav
    versions the decoder links (or the first lines of its build error)
    and ``cpu_budget()``. Where the decoder builds: phase 4's 4 clips and
    synthetic clips 240 high at widths 320 to 432, each frame through a
    raw ``vfdec_retrieve`` into a buffer with a 256-byte sentinel tail
    (untouched), byte-equal to the host's cv2 with its frame count and
    fps, and ms per clip by backend (whole decode, ``uni_12``). Where it
    does not: ``--decoder native --strict`` exits nonzero with the build
    error in its failed record, and ``--decoder auto`` opens every reader
    with cv2. Then both C++ chains against PIL on those clips' frames
    within the JAX package's bounds (ImageNet mean < 0.01, max < 0.08;
    CLIP mean < 0.02, max < 0.15) with host ms per video of each; CLIP
    (full width, ``uni_12 --attn flash --host_preprocess native --decoder
    native`` (``auto`` without the decoder) ``--decode_workers 2``) on
    phase 12's 8 clips: 96 K1 launches, readers by backend, within 1e-3
    of the port's ``--cpu`` run of the same flags and within relative L2
    0.05 of a ``--host_preprocess pil --decoder cv2`` run, and the warm
    host ms/video at ``pil`` and ``native``; ResNet-50 ``--host_preprocess
    native --decoder auto`` on phase 9's clip: K1 and K2 0 launches,
    readers by backend, the same two gates (1e-3 relative L2 to the
    CPU), and its warm host ms/video at both;
21. more than one device (``parallel/``): CLIP (full width, ``uni_12``)
    on phase 12's 8 clips through the CLI, on this card listed more than
    once (the machine has one): (a) queue mode, ``--attn flash
    --device_ids 0 0`` against ``--device_ids 0`` (features within 1e-6,
    96 K1 launches each, two workers named in the spans' threads and in
    ``summary.json``'s device lanes; warm videos/s of both, median and
    range of 2 passes each over a window of 40 names of the 8 clips); (b) ``--sharding mesh --device_ids 0 0 --mesh_model 1`` (within
    1e-5 of (a)'s one-worker run, the difference printed; 12 x 2 K1
    launches a forward at (8, 12, 50, 64)); (c) ``--mesh_model 2`` on the
    same two (within 2e-4; 12 x 2 K1 launches a forward at (16, 6, 50,
    64)); (d) ``--device_ids 0 0 0 0 --mesh_model 2 --mesh_context``
    (fused core, within 2e-4, K1 0 launches); (f) (a)-(c) on distinct
    cards where there are two (and a 2 x 2 mesh, tensor and context
    parallel, where there are four), else a line saying so. Phase 3
    holds and times K1 at those mesh shapes. One card shows the
    partitioning, the collectives' order and every shard's launch, but
    no copy between cards and no speed-up from them;
22. ``--sharding mesh`` for every family but CLIP, through the CLI with
    ``--strict``, the card listed twice (``--device_ids 0 0``) or four
    times, each case against its family's one-device run of phases 5-11
    (the same clips and flags; made here if absent), the difference
    printed: (a) ``resnet50`` (``--batch_size 16``), ``r21d_rgb``
    (``--batch_size 4``: the stack batch splits) and ``vggish`` (phase
    11's five wavs), data parallel on two rows, within relative L2 1e-5,
    K1 and K2 0 launches; (b) ``pwc`` and ``raft`` at ``--batch_size 8``
    at ``data`` 2 and 4 (each window's frames split with their halo
    frame): flows within 1e-4 of the largest, K2 = 5 levels x the rows
    that ran x the windows, at N=4 and N=2 pairs, K1 0; RAFT K1 and K2 0;
    (c) ``i3d --flow_type pwc`` (phase 5's two 129-frame clips, 64/64
    stacks) at ``data`` 2 and 4, both streams within 2e-4 max abs, K2 =
    5 x rows x stacks at N=32 and N=16, the rows that sat out printed;
    (d) ``--preprocess device`` on the mesh for ``pwc`` and ``i3d`` at
    ``data`` 2 against (b)'s and (c)'s host-preprocess mesh runs, within
    relative L2 5e-3; (e) ``--mesh_model 2`` on ``resnet50`` refused with
    the JAX package's "tensor-parallel" message; (f) (a)-(c) on distinct
    cards where there are two or four, else a line saying so. Phase 3
    holds and times K2 at those four per-shard shapes;
23. ``--weights_path`` from files, without ``--allow_random_init``, for
    CLIP-ViT-B/32 (``--attn flash``), ``resnet50``, ``r21d_rgb``,
    ``vggish``, ``raft``, ``pwc`` and ``i3d --flow_type pwc``, each on one
    short input (phase 4's first clip, 16 frames, a 10 s wav, 17 frames,
    one 64-frame stack) under deterministic cuDNN: a random-init run, whose
    seeded weights, read back from the card, are saved as a ``.pt`` in the
    reference layout and, through one ``params_to_jax`` tree, as the JAX
    package's ``.msgpack`` (``save_msgpack``) and orbax directory
    (``save_orbax``, the port's own OCDBT and zarr writer); I3D's are
    directories of its reference names, the only form either package
    looks up for it. Each file through the CLI: the weights on the card
    equal to the seeded ones bit for bit, the features within 1e-6 of the
    largest magnitude of the random-init run (0 expected), K1 12 a CLIP
    run, K2 10 a PWC run and 5 an I3D run, and the ms from
    ``--weights_path`` to a model on the card, per family and format,
    beside the host's read of the converted file alone. CLIP ``--sharding
    mesh`` with the card listed twice from the ``.msgpack`` and the orbax
    directory against the random-init mesh run;
24. ``--sharding mesh`` across launched processes
    (``parallel/distributed.py``): ``python -m torch.distributed.run
    --standalone --nproc_per_node 2`` of a small rank program (``RANK_CLI``:
    deterministic cuDNN, the CLI, then its process's K1/K2 launches and
    input shapes in a file a rank), in a session of its own killed whole
    past ``MULTIPROCESS_TIMEOUT_S``: ``--feature_types CLIP-ViT-B/32 i3d``
    (``uni_12 --attn flash``, ``--flow_type pwc``, a 64/64 stack) on
    phase 5's 65-frame clip, one data row a rank, one shared
    ``--output_path``. On this card both ranks share it over gloo (the
    layout rule; NCCL runs no two ranks of one communicator on one card),
    the backend each rank printed checked against the rule. Each file
    0.000e+00 from the one-process mesh ``--device_ids 0 0`` of the same
    grid (deterministic cuDNN on both sides; made in this process first,
    alone on the card), each rank with at least
    ``MULTIPROCESS_HEADROOM_GIB`` of the card beside what the other held
    at most (a fuller card makes cuDNN pass over a plan whose workspace
    does not fit; the phase
    runs before phase 4 for that, while this process holds almost none
    of the card); one
    writer (the ``sink``
    spans of one process id only, one a video a model); ``summary.json``
    counting each video once, as the one-process run's does; K1 12 a
    forward and K2 5 a stack in each rank, at shapes phase 3 holds. Where
    there are two cards, the same over NCCL, a card a rank; where there
    are four, CLIP at data 2 x ``--mesh_model 2`` over NCCL, two cards a
    rank, against the one-process 2 x 2 mesh; else a line saying so;
25. graftcheck on the card host, and a witness for its host-sync lint
    (``run_lint_path``, last): ``python -m video_features_tpu_torch.analysis``
    over the tree as shipped must exit 0 (its time printed); then one warm
    CLIP group (``--video_batch 4``, phase 4's clips, ``--attn flash``)
    and one warm I3D + PWC stack (phase 5's 65-frame clip) run again
    under ``torch.cuda.set_sync_debug_mode("warn")``, and each reported
    synchronization's innermost frame in the port is judged by the lint
    (``analysis/hostsync.py::sync_site_verdict``): the phase fails on a
    sync in a hot module's function that GC10x neither allowlists
    (fetch/drain/sink) nor waives. A deliberate sync (the waived, cached
    upload of ``ops/preprocess.py::_channel_stats``, called uncached)
    shows the witness sees one;
26. a ``kernels`` JSON line (each kernel's launches on its main path, in
    the fused runs, in the device preprocess runs, in the telemetry runs,
    in the bf16 phase, in the served requests, in phases 18-24, its
    records at the fused shapes and at the mesh shapes, and K1's bf16
    record at the CLIP path's shape), then the ``ok`` JSON line last.

Every CLI run of phases 4-14, 16-18 and 20-24 passes ``--strict``, so a video that fails
in isolation fails its phase (phase 15's first run leaves it out: two of
its files must fail). Phases 7-11 launch no hand-written kernel:
RAFT, ResNet, R(2+1)D and VGGish reach no ``pallas_call`` in the JAX
package, nor does the device preprocess's resample (the JAX package
leaves it to XLA). Every launch count is read from a run that starts with
all counts at 0 (phase 24's ranks each start at 0), and each of phases
4-25 prints its wall time.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import ctypes
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by
# type. fp32 work has a faster route than the CUDA cores' 67 TFLOP/s: three
# TF32 tensor-core products (big*big + big*small + small*big) at 495 TFLOP/s
# give fp32 accuracy at 165 TFLOP/s, so that is the fp32 operations term
# of every bound, whichever unit a kernel uses
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}

# kernel vs plain version on the same inputs: fp32 differs only in the
# order of its sums; bf16 outputs are rounded to bf16 (one ulp near 1 is
# 2^-7), so the bound is about one ulp
KERNEL_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# features of the 12-layer tower, flash vs fused core (both exact fp32
# attention) and card vs CPU (other sum orders in every matmul), for
# features of unit scale
FEATURE_ATOL = 1e-3

N_VIDEOS = 4
FRAMES = 12
LAYERS = 12

# PWC's five cost volumes on the I3D main path: a 65-frame stack of
# 320x240 video, resized to 256x341 and stretched to 256x384, 64 pairs;
# (level, C, H, W)
PAIRS = 64
CORR_LEVELS = [(2, 32, 64, 96), (3, 64, 32, 48), (4, 96, 16, 24), (5, 128, 8, 12),
               (6, 196, 4, 6)]
# K1 at the CLIP path's shape in bf16: its --dtype bfloat16 graph
BF16_ATTENTION_CASE = ((16, 12, 50, 64), torch.bfloat16, None)
# K1's cases in phase 3: (shape, dtype, kv_len); the first is the main path
ATTENTION_CASES = [
    ((16, 12, 50, 64), torch.float32, None),  # the main path: B/32, uni_12
    ((16, 12, 197, 64), torch.float32, None),  # B/16
    ((16, 12, 50, 64), torch.float32, 37),  # ragged KV
    BF16_ATTENTION_CASE,
    ((16, 12, 65, 64), torch.float32, None),  # one row past a KV tile: two stages
    ((16, 12, 197, 128), torch.float32, None),  # d=128, the most shared memory
]
# K1's shapes on phases 21's and 24's mesh runs, held and timed in phase
# 3: a --mesh_model 2 shard's 6 heads of uni_12's 16 frames, one of two
# data shards' 8 frames (a rank's in phase 24), and a cell of a 2 x 2
# mesh (phases 21 and 24 on four cards)
MESH_ATTENTION_SHAPES = {"N=16, H=6 (--mesh_model 2)": (16, 6, 50, 64),
                         "N=8, H=12 (two data shards)": (8, 12, 50, 64),
                         "N=8, H=6 (2 x 2 mesh)": (8, 6, 50, 64)}
# phase 21: against queue mode's one-worker features; a data-parallel
# mesh does each frame's arithmetic as one device does, at another batch
# size (the JAX package asks byte-equality there), tensor and context
# parallelism sum in another order (the JAX package's 2e-4)
MESH_ATOL = {"data": 1e-5, "tensor": 2e-4, "context": 2e-4}
# phase 22: the families' meshes against their one-device runs. A data
# parallel row does the one-device math at a smaller batch (cuDNN may pick
# another algorithm): relative L2 1e-5; the flows, relative to their
# largest magnitude, as the device preprocess phase holds them; I3D at the
# JAX package's own mesh tolerance (max abs); --preprocess device against
# the host preprocess mesh at DEVICE_DRIFT
FAMILY_MESH_RTOL = 1e-5
I3D_MESH_ATOL = 2e-4
# phase 23: features from the seeded weights read back from files against
# the random-init run of the same weights under deterministic cuDNN: the
# same tensors and algorithms, so 0 expected. One short input a family
WEIGHTS_RTOL = 1e-6
WEIGHTS_FLOW_FRAMES = 17  # PWC and RAFT: 16 pairs, two windows of 8
WEIGHTS_WAV_SECONDS = 10.0
# phase 24: one torchrun launch of two processes over one global mesh, a
# data row each, running CLIP uni_12 --attn flash and I3D + PWC (a 64/64
# stack) in one --feature_types run on phase 5's 65-frame clip; the launch
# waits at most MULTIPROCESS_TIMEOUT_S
MULTIPROCESS_RANKS = 2
MULTIPROCESS_CLIP = "i3d65.mp4"
MULTIPROCESS_TIMEOUT_S = 600
# the least of card 0 a rank may have had beside what the other ranks on
# it held at most: with less, a cuDNN plan whose workspace does not fit is
# passed over for the next, and the flow stream's rounding moves
# (scripts/mesh_exactness_probe.py: a run with 12 GiB free moved 1.6e-8,
# one with 16 did not), so the 0 gate would hold the card's fullness
MULTIPROCESS_HEADROOM_GIB = 16.0
# K2's shapes on phase 22's mesh runs, held and timed in phase 3: one
# row's pairs of an I3D stack of 64 (256x384 grid) at data 2 and 4, and of
# a standalone PWC window of 8 (256x320) at data 2 and 4
MESH_CORRELATION_CASES = {"N=32 (i3d, data 2)": (32, 256, 384),
                          "N=16 (i3d, data 4)": (16, 256, 384),
                          "N=4 (pwc, data 2)": (4, 256, 320),
                          "N=2 (pwc, data 4)": (2, 256, 320)}
# K2's cases in phase 3: (label, shape, dtype); the levels are the main path
CORRELATION_CASES = [(f"level {lvl}", (PAIRS, c, h, w), torch.float32)
                     for lvl, c, h, w in CORR_LEVELS]
CORRELATION_CASES += [("ragged", (PAIRS, 32, 67, 121), torch.float32),
                      ("level 2 bf16", (PAIRS, 32, 64, 96), torch.bfloat16)]
I3D_VIDEOS = 2
I3D_CLIP_FRAMES = 129  # 2 stacks of 64 + 1 frames at step 64
I3D_STACKS = 2
STACK = 64
PWC_CLIP_FRAMES = 60
PWC_BATCH = 8
# RAFT card vs CPU: the shortest stack I3D takes (10 flows), at the main
# path's 256x341 (padded to 256x344)
RAFT_COMPARE_FRAMES = 11
RAFT_CLIP = (30, 330, 250)  # frames, width, height: neither side a multiple of 8
RAFT_BATCH = 8
RESNET_CLIP_FRAMES = 60
RESNET_BATCH = 16
R21D_CLIP_FRAMES = 64  # 4 stacks of 16
SHORT_CLIP_FRAMES = 16
# VGGish: four 60 s stereo 44.1 kHz wavs and one of 600 s; a clip gives
# ((16 kHz samples - 400) // 160 + 1) // 96 examples of 0.96 s
VGGISH_SECONDS = (60.0, 60.0, 60.0, 60.0, 600.0)
VGGISH_RATE = 44100
VGGISH_EXAMPLES = {60.0: 62, 600.0: 624}
# VGGish embeddings card vs CPU, relative L2 of fp32 sums in other orders
# through 6 convolutions and 3 Linears (TF32 off)
VGGISH_RTOL = 1e-3
# the run contract on the CLIP path: 8 clips; the same clip through the
# same kernels in another loop gives the same features up to launch-order
# effects, none of which exist in a fixed-shape fp32 forward
CONTRACT_VIDEOS = 8
# phase 21's warm queue passes: each of the 8 clips under this many names,
# a window of 40 videos a pass, so one pass takes ~2 s, not ~0.4 s (160
# names and 3 passes until phase 22, 80 until phase 24 needed the time)
WARM_QUEUE_COPIES = 5
WARM_QUEUE_PASSES = 2  # for each worker count, in turns
# phase 17's ledger gates: CLIP-ViT-B/32 at 224 px is 4.41 GMACs (timm's
# published figure) at 2 flops a multiply-add; a model's projected resident
# set against the peak of its largest served group P; a rebuilt CLIP's
# re-recorded entry against the first
CLIP_FLOPS_PER_IMAGE = 2 * 4.41e9
CLIP_FLOPS_RTOL = 0.10
RESIDENT_P_RANGE = (0.9, 1.25)
REBUILD_RTOL = 0.05
# phase 19: the preempted CLIP's breaker cooldown before its half-open
# probe, and how far the ballast may leave the headroom from its target
# (the caching allocator rounds a block to 512 bytes)
PREEMPT_BREAKER_COOLDOWN_S = 2.0
BALLAST_SLACK = 4 * 2**20
CONTRACT_ATOL = 1e-6
# the async ingest phase: CLIP on the contract clips at each --video_batch
# x --inflight_groups; a fused batch changes the GEMMs' shapes, so cuBLAS
# may sum in another order (TF32 stays off): fp32 rounding of unit-scale
# features through 12 layers
INGEST_VIDEO_BATCHES = (1, 4, 8)
INGEST_INFLIGHT = (1, 2)
INGEST_ATOL = 1e-4
# K1 at the fused CLIP shape: 4 videos of 16 images (uni_12 bucketed)
FUSED_ATTENTION_SHAPE = (4 * 16, 12, 50, 64)
INGEST_PWC_FRAMES = 30
INGEST_WAV_SECONDS = 10.0  # 10 examples, bucketed to 16
# the device preprocess phase: --preprocess device against host, each
# family on its earlier phase's clips. The device resize is PIL's in fp32
# taps, PIL's own in 8-bit fixed point: about one uint8 level in a few
# pixels, so the JAX package's drift budget (absolute for CLIP's
# unit-scale features; relative L2 for the CNNs', the flows' and I3D's);
# with no resize (RAFT, PWC) the model's input is the host's, bit for bit
DEVICE_DRIFT = 5e-3
DEVICE_VIDEO_BATCH = 4
# the telemetry and preflight phase: the stages every done video's spans
# cover, the clips of the --telemetry off run, and the bookkeeping cost's
# sample and ceiling (the JAX package's 1% of a video)
TELEMETRY_STAGES = ("decode", "prepare", "dispatch", "fetch", "sink")
TELEMETRY_OFF_VIDEOS = 4
TELEMETRY_COST_VIDEOS = 2000
TELEMETRY_COST_CEILING = 0.01
# the resample's shapes on the main paths: (label, leading axes, source
# (h, w), taps, per-video taps of a group, normalize), with taps ('fused',
# resize_to, crop, method) or ('contract', side, grid (h, w), (top, left))
RESAMPLE_CASES = [
    ("CLIP uni_12 video", (16,), (240, 320), ("fused", 224, 224, "bicubic"), False, True),
    ("CLIP --video_batch 4 group", (4, 16), (240, 320), ("fused", 224, 224, "bicubic"), True,
     True),
    ("ResNet-50 batch", (16,), (240, 320), ("fused", 256, 224, "bilinear"), False, True),
    ("RAFT window (identity onto 256x336)", (9,), (250, 330),
     ("contract", 0, (256, 336), (3, 3)), False, False),
    ("I3D rgb stack", (1, 64), (240, 320), ("fused", 256, 224, "bilinear"), False, False),
    ("I3D + PWC flow stack", (1, 65), (240, 320), ("contract", 256, (256, 341), (0, 0)), False,
     False),
]
# ResNet-50 and R(2+1)D-18 features card vs CPU, relative L2 of fp32 sums
# in other orders through ~50 and ~37 convolutions
CNN_FEATURE_RTOL = 1e-3
# I3D features, relative L2 error of fp32 sums in other orders through
# ~60 convolutions (and, card vs CPU, PWC's ~50): features are a mean of
# small activations under random weights, so the check is relative
I3D_FEATURE_RTOL = 1e-3
# PWC flow with K2 vs with the plain cost volume, relative to the flow's
# largest magnitude: the volumes differ by fp32 sum order (~1e-7)
FLOW_RTOL = 1e-4
UINT8_LEVEL = 2.0 / 255.0  # one flow level after scale_to_1_1
# phase 18 (flow read from disk, the output flags): the save_jpg files
# read back against the sink's own quantization of the .npy flow; a JPEG
# at quality 95 of PWC's smooth (bilinearly upsampled) flow moves a pixel
# by under a level on average, so the mean is held to 1.5 levels
JPEG_MEAN_LEVELS = 1.5
# I3D's flow stream on PWC's JPEGs against the on-the-fly flow features:
# the JAX package's round-trip budget (tests/test_i3d.py), for the uint8
# quantization plus the JPEG
ROUND_TRIP_RTOL = 0.05
# --conv3d_impl decomposed against direct: the same fp32 products summed in
# another order (kt 2D convolutions), TF32 off
CONV3D_RTOL = 1e-3
FPS_RETARGET_FPS = 10.0
# phase 20: the decoder's width sweep (clips 240 high; the JAX package's
# decoder overruns at 330 and 424-428 and drifts in the tail columns at
# 340-342 and 418-420), the sentinel tail behind each retrieved frame,
# the JAX package's bounds of its C++ chains against PIL (mean, max;
# tests/test_native.py) and of native against PIL features
NATIVE_SWEEP_WIDTHS = (320, 330, 340, 342, 418, 420, 424, 426, 428, 432)
NATIVE_SENTINEL = 256
NATIVE_PIL_BOUNDS = {"imagenet": (0.01, 0.08), "clip": (0.02, 0.15)}
NATIVE_REL_L2 = 0.05


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown"


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """ms per call from CUDA events around ``iters`` back-to-back calls:
    the device's time, or the host's launch cost where that is slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, iters: int = 1):
    """{kernel name: (device ms per iteration, launches per iteration)}
    from a torch.profiler trace of ``iters`` calls; empty when the trace
    holds no device time. Late in a long process a trace has been seen to
    lose launches (``traced_ms`` and ``print_top_kernels`` check counts),
    so the device settles for a moment inside the profiler first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key] = (us / 1e3 / iters, e.count / iters)
    return out


def traced_ms(traced, name: str, launches: int = 1):
    """Device ms per iteration of the kernels named ``name`` in a trace,
    or None (not measured) unless the trace holds exactly ``launches`` of
    them per iteration."""
    hits = [(ms, n) for key, (ms, n) in traced.items() if name in key]
    if not hits or sum(n for _, n in hits) != launches:
        return None
    return sum(ms for ms, _ in hits)


def attention_bound(shape, dtype, kv_len):
    """(ms, 'bytes'|'operations'): q and o whole, the kv_len rows of k and
    v each moved once; 2 * 2 * Lq * kv_len * d operations per (n, h)."""
    n, h, lq, d = shape
    kv = shape[2] if kv_len is None else kv_len
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * n * h * lq * d + 2 * n * h * kv * d) * size
    ops = 4 * n * h * lq * kv * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def reset_counts():
    """Every kernel's launch count to 0, before a path is driven."""
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    local_correlation_kernel.launches = 0


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flow_feature_rtol(flip_share: float, levels) -> float:
    """Tolerance on I3D-flow features whose uint8 flow levels differ in
    ``flip_share`` of their values by one. A network that keeps the scale
    of its input (LeCun-initialised convs) moves its output by about the
    input's relative change, sqrt(share) * level / rms(input), where the
    input is the levels scaled to [-1, 1]; the factor 4 is margin,
    I3D_FEATURE_RTOL the sum-order part."""
    x = 2.0 * np.asarray(levels, np.float64) / 255.0 - 1.0
    rms = float(np.sqrt(np.mean(np.square(x))))
    return I3D_FEATURE_RTOL + 4.0 * np.sqrt(flip_share) * UINT8_LEVEL / max(rms, 1e-30)


def hold_flash_attention(device, shape, dtype, kv_len, seed: int):
    """K1 against its plain version on one case: checks the error, prints
    and returns the case's record (times, bound, SDPA's times)."""
    import torch.nn.functional as F

    from video_features_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
        for _ in range(3)
    )
    out = flash_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    ref = flash_attention_reference(q, k, v, kv_len=kv_len)
    err = (out.float() - ref.float()).abs().max().item()
    tol = KERNEL_ATOL[dtype]
    mask = None
    if kv_len is not None:
        mask = torch.arange(shape[2], device=device) < kv_len
    ms = time_ms(lambda: flash_attention(q, k, v, kv_len=kv_len))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, kv_len=kv_len))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    bound_ms, bound_by = attention_bound(shape, dtype, kv_len)
    traced = device_kernels(lambda: flash_attention(q, k, v, kv_len=kv_len), iters=20)
    device_ms = traced_ms(traced, "flash_attention")
    # every kernel SDPA launches, on the device
    library_device_ms = sum(ms for ms, _ in device_kernels(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), iters=20).values())
    print(
        f"flash_attention {shape} {str(dtype)[6:]} kv_len={kv_len}: "
        f"max_abs_err {err:.3e} (tol {tol:g}); kernel {ms * 1e3:.2f} us, "
        f"kernel on the device {us_or_not(device_ms)} (profiler), "
        f"plain {plain_ms * 1e3:.2f} us, sdpa {library_ms * 1e3:.2f} us, "
        f"sdpa on the device {us_or_not(library_device_ms)} (profiler), "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by}), "
        f"{bound_share(bound_ms, device_ms or ms)} of the bound"
    )
    if not err <= tol:
        raise AssertionError(f"flash_attention disagrees with its plain version: {err}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, device_ms=device_ms,
                library_device_ms=library_device_ms or None)


def check_flash_attention(device):
    """Phase 3 for K1; returns the main path case's record and that of
    the main path's shape in bf16 (CLIP's --dtype bfloat16 graph), taken
    here, early, where the profiler keeps every launch."""
    records = [hold_flash_attention(device, shape, dtype, kv_len, seed=i)
               for i, (shape, dtype, kv_len) in enumerate(ATTENTION_CASES)]
    return records[0], records[ATTENTION_CASES.index(BF16_ATTENTION_CASE)]


def us_or_not(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def bound_share(bound_ms: float, ms: float) -> str:
    """The bound as a share of the kernel's time (1 = at the bound)."""
    return f"{bound_ms / ms:.3f}" if ms > 0 else "not measured"


def correlation_bound(shape, dtype):
    """(ms, 'bytes'|'operations'): f1 and f2 read once, the 81 planes
    written once; one multiply and one add per (plane, channel, pixel)."""
    n, c, h, w = shape
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * n * c * h * w + n * 81 * h * w) * size
    ops = 2 * 81 * n * c * h * w
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def hold_local_correlation(device, label: str, shape, dtype, seed: int):
    """K2 against its plain version on one case: checks the error, prints
    and returns the case's record (times, bound)."""
    from video_features_tpu_torch.ops.correlation import local_correlation_reference
    from video_features_tpu_torch.ops.correlation_kernel import (
        launch_shape,
        local_correlation_kernel,
    )

    rng = np.random.default_rng(seed)
    f1, f2 = (
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
        for _ in range(2)
    )
    out = local_correlation_kernel(f1, f2)
    torch.cuda.synchronize()
    ref = local_correlation_reference(f1, f2)
    err = (out.float() - ref.float()).abs().max().item()
    tol = KERNEL_ATOL[dtype]
    ms = time_ms(lambda: local_correlation_kernel(f1, f2))
    plain_ms = time_ms(lambda: local_correlation_reference(f1, f2), iters=20, warmup=2)
    bound_ms, bound_by = correlation_bound(shape, dtype)
    traced = device_kernels(lambda: local_correlation_kernel(f1, f2), iters=20)
    device_ms = traced_ms(traced, "local_correlation")
    tile = launch_shape(*shape, f1.element_size())
    print(
        f"local_correlation {label} {shape} {str(dtype)[6:]}: max_abs_err {err:.3e} "
        f"(tol {tol:g}); kernel {ms * 1e3:.2f} us, kernel on the device "
        f"{us_or_not(device_ms)} (profiler), plain {plain_ms * 1e3:.2f} us, "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by}), "
        f"{bound_share(bound_ms, device_ms or ms)} of the bound; {tile.staging} staging, tile "
        f"{tile.tile_h}x{tile.tile_w}, {tile.splits} channel groups, chunk {tile.chunk}, "
        f"tiles {tile.tiles}, {tile.threads} threads, {tile.smem_bytes} B shared"
    )
    if not err <= tol:
        raise AssertionError(f"local_correlation disagrees with its plain version: {err}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, device_ms=device_ms)


def hold_correlation_levels(device, pairs: int, levels, label: str, seed: int):
    """K2 on one PWC forward's five cost volumes (N = ``pairs``): the
    record summed over the levels (the largest error; a level without
    device time in its trace leaves the device sum unmeasured). Five
    launches one after another: their least time is the sum of theirs,
    set by what sets the largest."""
    recs = [hold_local_correlation(device, f"{label} level {lvl}", (pairs, c, h, w),
                                   torch.float32, seed + i)
            for i, (lvl, c, h, w) in enumerate(levels)]
    device_ms = (sum(r["device_ms"] for r in recs)
                 if all(r["device_ms"] for r in recs) else None)
    rec = dict(max_abs_err=max(r["max_abs_err"] for r in recs),
               ms=sum(r["ms"] for r in recs), plain_ms=sum(r["plain_ms"] for r in recs),
               bound_ms=sum(r["bound_ms"] for r in recs),
               bound_by=max((r["bound_ms"], r["bound_by"]) for r in recs)[1],
               library_ms=None, device_ms=device_ms)
    on_device = (f"{device_ms * 1e3:.2f} us" if device_ms is not None
                 else "not measured (a level has no device time in its trace)")
    print(f"local_correlation, {label}'s five levels (fp32, N={pairs}): kernel "
          f"{rec['ms'] * 1e3:.2f} us, on the device {on_device}, plain "
          f"{rec['plain_ms'] * 1e3:.2f} us, bound {rec['bound_ms'] * 1e3:.2f} us, "
          f"{bound_share(rec['bound_ms'], device_ms or rec['ms'])} of the bound")
    return rec


def pwc_levels(hp: int, wp: int):
    """PWC's five cost volumes (level, C, H, W) on an (hp, wp) internal
    grid (a multiple of 64)."""
    return [(lvl, c, hp >> lvl, wp >> lvl)
            for lvl, c in ((2, 32), (3, 64), (4, 96), (5, 128), (6, 196))]


def check_local_correlation(device):
    """Phase 3 for K2; returns the record of one stack's five cost
    volumes on the I3D main path."""
    for i, (label, shape, dtype) in enumerate(CORRELATION_CASES):
        if not (label.startswith("level") and dtype == torch.float32):
            hold_local_correlation(device, label, shape, dtype, seed=100 + i)
    return hold_correlation_levels(device, PAIRS, CORR_LEVELS, "one I3D stack", seed=100)


def synth_clips(root: str):
    from video_features_tpu_torch.utils.synth import synth_video

    return [synth_video(os.path.join(root, f"clip{i}.mp4"), seed=i) for i in range(N_VIDEOS)]


def read_features(out_dir: str):
    files = sorted(glob.glob(os.path.join(out_dir, "**", "*.npy"), recursive=True))
    return {os.path.basename(f): np.load(f) for f in files}


FRESH_CLI = """
import json, sys, time
import torch
from video_features_tpu_torch import cli
from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
from video_features_tpu_torch.ops.flash_attention import flash_attention
for argv in json.loads(sys.argv[1]):
    flash_attention.launches = local_correlation_kernel.launches = 0
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    print("FRESH_CLI " + json.dumps({"wall": time.perf_counter() - t0,
                                     "flash_attention": flash_attention.launches,
                                     "local_correlation": local_correlation_kernel.launches}),
          flush=True)
"""


def cli_in_fresh_process(argvs):
    """[(wall s of ``cli.main(argv)``, {kernel: launches})] of each of
    ``argvs``, run in turn in one new Python process of this interpreter,
    environment and repo, which loads the kernels this one built. Phases
    15 and 16 take their ``--profile_dir`` traces this way: a
    ``torch.profiler`` trace loses kernel records as a process ages, one
    more every ~15 s of work on the card
    (``scripts/profiler_trace_loss.py``), and a fresh process's hold every
    launch (phase 16's three short runs together are seconds of card work
    in one process)."""
    done = subprocess.run([sys.executable, "-c", FRESH_CLI, json.dumps(argvs)],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=900)
    marked = [line for line in done.stdout.splitlines() if line.startswith("FRESH_CLI ")]
    if done.returncode or len(marked) != len(argvs):
        raise AssertionError(f"the CLI in a fresh process exited {done.returncode}: "
                             f"{done.stdout[-2000:]}{done.stderr[-4000:]}")
    runs = []
    for line in marked:
        counts = json.loads(line[len("FRESH_CLI "):])
        runs.append((counts.pop("wall"), counts))
    return runs


# phase 24's rank program (torchrun runs one a process): deterministic
# cuDNN, as in the one-process run it is held to, the CLI, then this
# process's wrapper counts and the K1/K2 input shapes (recorders around the
# real wrappers, whose counts stay the only counts) into a file a rank
RANK_CLI = """
import json, os, sys
import torch
torch.backends.cudnn.deterministic = True
from video_features_tpu_torch import cli
from video_features_tpu_torch.models.clip import extract_clip
from video_features_tpu_torch.models.pwc import model as pwc_model
from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
from video_features_tpu_torch.ops.flash_attention import flash_attention
seen = {"K1": set(), "K2": set()}
flash, corr = extract_clip.CORES["flash"], pwc_model.local_correlation

def k1(q, k, v, **kw):
    seen["K1"].add(tuple(q.shape))
    return flash(q, k, v, **kw)

def k2(f1, f2, *a, **kw):
    seen["K2"].add(tuple(f1.shape))
    return corr(f1, f2, *a, **kw)

extract_clip.CORES["flash"], pwc_model.local_correlation = k1, k2
cli.main(json.loads(sys.argv[1]))
torch.cuda.synchronize()
rank = int(os.environ["RANK"])
with open(f"{sys.argv[2]}.rank{rank}.json", "w") as f:
    json.dump({"rank": rank, "flash_attention": flash_attention.launches,
               "local_correlation": local_correlation_kernel.launches,
               "K1": sorted(seen["K1"]), "K2": sorted(seen["K2"]),
               "peak_reserved": torch.cuda.max_memory_reserved()}, f)
"""


def launch_ranks(root: str, label: str, argv, visible=None):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    MULTIPROCESS_RANKS`` of ``RANK_CLI`` with ``argv``, in a session of its
    own that is killed whole if it outlives ``MULTIPROCESS_TIMEOUT_S``;
    ``visible`` sets ``CUDA_VISIBLE_DEVICES``. Returns (wall s, each rank's
    record, the log), and fails unless every rank exited 0."""
    import signal

    script = os.path.join(root, "rank_cli.py")
    with open(script, "w") as f:
        f.write(RANK_CLI)
    prefix = os.path.join(root, f"{label}_counts")
    log_path = os.path.join(root, f"{label}.log")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    # the host's cores split between the ranks (torchrun would give each one)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // MULTIPROCESS_RANKS)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(MULTIPROCESS_RANKS), script, json.dumps(argv), prefix]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        proc.wait(timeout=MULTIPROCESS_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    if proc.returncode:
        raise AssertionError(f"multi-process {label}: torchrun exited {proc.returncode}:\n"
                             f"{text[-6000:]}")
    for line in text.splitlines():
        if line.startswith(("distributed:", "run manifest:")):
            print(f"multi-process {label}, a rank: {line}")
    ranks = []
    for r in range(MULTIPROCESS_RANKS):
        with open(f"{prefix}.rank{r}.json") as f:
            ranks.append(json.load(f))
    return wall, ranks, text


def warm_split(ex, clips, device):
    """(host s, forward s) of a built extractor over ``clips``, after one
    warm-up pass: ``prepare`` (decode and host preprocessing) and
    ``forward`` (H2D, models, D2H)."""
    model = ex.warmup(device)
    ex(device=device)  # cuDNN, cuBLAS and allocator set-up
    prep = fwd = 0.0
    for clip in clips:
        t0 = time.perf_counter()
        payload = ex.prepare(clip)
        t1 = time.perf_counter()
        ex.forward(model, payload)  # ends in a copy to the host
        prep, fwd = prep + t1 - t0, fwd + time.perf_counter() - t1
    return prep, fwd


def run_main_path(root: str):
    """Phase 4; returns K1's launches on the CLIP path's run."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.ops.flash_attention import flash_attention

    clips = synth_clips(root)

    def argv(attn, out, *extra):
        return ["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                "--attn", attn, "--allow_random_init", "--on_extraction", "save_numpy", "--strict",
                "--output_path", os.path.join(root, out), "--tmp_path",
                os.path.join(root, "tmp"), "--video_paths", *extra]

    reset_counts()
    t0 = time.perf_counter()
    cli.main(argv("flash", "flash", *clips))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches

    flash = read_features(os.path.join(root, "flash"))
    if len(flash) != N_VIDEOS:
        raise AssertionError(f"expected {N_VIDEOS} .npy files, got {sorted(flash)}")
    for name, feats in flash.items():
        if feats.shape != (FRAMES, 512) or not np.isfinite(feats).all():
            raise AssertionError(f"{name}: shape {feats.shape}, finite {np.isfinite(feats).all()}")
    if launches != N_VIDEOS * LAYERS:
        raise AssertionError(f"flash_attention launched {launches} times, expected "
                             f"{N_VIDEOS * LAYERS}")
    print(f"main path (--attn flash, cold CLI run, model build included): {N_VIDEOS} videos "
          f"in {wall:.3f} s, {N_VIDEOS / wall:.3f} videos/s, {wall / N_VIDEOS * 1e3:.1f} ms/video; "
          f"flash_attention launches {launches}")

    cli.main(argv("fused", "fused", *clips))
    fused = read_features(os.path.join(root, "fused"))
    err = max(np.abs(flash[k] - fused[k]).max() for k in flash)
    print(f"features --attn flash vs --attn fused on the card: max_abs_err {err:.3e} "
          f"(tol {FEATURE_ATOL:g})")
    if not err <= FEATURE_ATOL:
        raise AssertionError(f"flash and fused features disagree: {err}")

    cli.main(argv("fused", "cpu", clips[0]) + ["--cpu"])
    (cpu_name, cpu_feats), = read_features(os.path.join(root, "cpu")).items()
    err = np.abs(flash[cpu_name] - cpu_feats).max()
    print(f"features card (--attn flash) vs the port on the CPU (--attn fused), {cpu_name}: "
          f"max_abs_err {err:.3e} (tol {FEATURE_ATOL:g})")
    if not err <= FEATURE_ATOL:
        raise AssertionError(f"card and CPU features disagree: {err}")

    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor

    ex = build_extractor(ExtractionConfig(
        feature_type="CLIP-ViT-B/32", video_paths=clips, extract_method=f"uni_{FRAMES}",
        attn="flash", allow_random_init=True), external_call=True)
    device = torch.device("cuda", torch.cuda.current_device())
    prep, fwd = warm_split(ex, clips, device)
    warm = prep + fwd
    print(f"main path (--attn flash, warm extractor): {N_VIDEOS / warm:.3f} videos/s, "
          f"{warm / N_VIDEOS * 1e3:.2f} ms/video = host decode + preprocess "
          f"{prep / N_VIDEOS * 1e3:.2f} ms + forward (H2D, model, D2H) "
          f"{fwd / N_VIDEOS * 1e3:.2f} ms")
    model, payload = ex.warmup(device), ex.prepare(clips[-1])
    print_top_kernels(device_kernels(lambda: ex.forward(model, payload)), fwd / N_VIDEOS * 1e3,
                      "one forward on the device", mark="flash_attention", expect=LAYERS)
    return launches


def print_top_kernels(traced, wall_ms: float, label: str, top: int = 8, mark: str = "",
                      expect: int = 0):
    """One forward's device time by kernel from a profiler trace, against
    the wall time of the same forward run without the profiler. Where the
    traced busy time exceeds that wall, the profiler's own cost per kernel
    shows, and the idle share is not measured; so too where the trace
    holds another number of ``mark`` launches than ``expect``."""
    busy = sum(ms for ms, _ in traced.values())
    if not busy:
        print(f"{label}: the profiler recorded no device time (not measured)")
        return
    marked = sum(ms for name, (ms, _) in traced.items() if mark and mark in name)
    seen = sum(n for name, (_, n) in traced.items() if mark and mark in name)
    if expect and seen != expect:
        idle = f"idle share not measured: the trace holds {seen:g} of {expect} {mark} launches"
    elif busy <= wall_ms:
        idle = f"idle share {1 - busy / wall_ms:.3f}"
    else:
        idle = "idle share not measured: the trace's busy time exceeds the wall"
    launches = sum(n for _, n in traced.values())
    print(f"{label}: {busy:.3f} ms busy of {wall_ms:.3f} ms wall ({idle}), "
          f"{launches:g} launches" + (f"; {mark} {marked:.4f} ms ({marked / busy:.1%})"
                                      if mark else "") + "; by kernel:")
    for name, (ms, n) in sorted(traced.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:.4f} ms ({ms / busy:.1%}) x{n:g} {name[:90]}")


def stack_streams(ex, models, stack, corr_method="auto"):
    """One stack (S+1, H, W, 3), or a group of them (B, S+1, H, W, 3),
    through both streams, step by step as ``ExtractI3D.forward`` runs it,
    with ``ex``'s flow net (PWC with the cost volume ``corr_method``
    picks; RAFT on the padded stack): (flow, its cropped uint8 levels,
    rgb features, flow features), as numpy, each with the batch axis."""
    from video_features_tpu_torch.models.i3d.extract_i3d import center_crop, rgb_chain
    from video_features_tpu_torch.ops.preprocess import flow_to_uint8, scale_to_1_1

    pwc = models.get("pwc")
    if pwc is not None:
        pwc.corr_method = corr_method
    batch = stack if stack.dim() == 5 else stack[None]
    try:
        with torch.inference_mode():
            flow = ex.flow(models, batch)
            levels = flow_to_uint8(center_crop(flow))
            f_rgb, _ = models["rgb"](rgb_chain(batch[:, :-1]))
            f_flow, _ = models["flow"](scale_to_1_1(levels))
    finally:
        if pwc is not None:
            pwc.corr_method = "auto"
    return tuple(t.cpu().numpy() for t in (flow, levels, f_rgb, f_flow))


def compare_stack(a, b, label: str) -> None:
    """Flow tight; the share of uint8 levels that flip; rgb features by
    I3D_FEATURE_RTOL; flow features by the tolerance that share allows."""
    flow_err = float(np.abs(a[0] - b[0]).max())
    flow_tol = FLOW_RTOL * max(float(np.abs(b[0]).max()), 1.0)
    share = float(np.mean(a[1] != b[1]))
    rgb_err, flow_feat_err = rel_l2(a[2], b[2]), rel_l2(a[3], b[3])
    feat_tol = flow_feature_rtol(share, b[1])
    print(f"{label}: flow max_abs_err {flow_err:.3e} px (tol {flow_tol:.3e}, |flow| max "
          f"{np.abs(b[0]).max():.3f}); uint8 levels flipped {share:.3e} of {a[1].size}; "
          f"rgb features rel_l2 {rgb_err:.3e} (tol {I3D_FEATURE_RTOL:g}); flow features "
          f"rel_l2 {flow_feat_err:.3e} (tol {feat_tol:.3e})")
    if not flow_err <= flow_tol:
        raise AssertionError(f"{label}: flows disagree: {flow_err}")
    if not rgb_err <= I3D_FEATURE_RTOL:
        raise AssertionError(f"{label}: rgb features disagree: {rgb_err}")
    if not flow_feat_err <= feat_tol:
        raise AssertionError(f"{label}: flow features disagree: {flow_feat_err}")


def run_i3d_path(root: str, device):
    """Phase 5; returns K2's launches on the I3D path's run."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.utils.synth import synth_video

    clips = [synth_video(os.path.join(root, f"i3d{i}.mp4"), n_frames=I3D_CLIP_FRAMES, seed=i)
             for i in range(I3D_VIDEOS)]
    out = os.path.join(root, "i3d_out")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--feature_type", "i3d", "--flow_type", "pwc", "--allow_random_init",
              "--on_extraction", "save_numpy", "--strict", "--output_path", out,
              "--tmp_path", os.path.join(root, "tmp"), "--video_paths", *clips])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = local_correlation_kernel.launches

    feats = read_features(out)
    want = sorted(f"i3d{i}_{s}.npy" for i in range(I3D_VIDEOS) for s in ("rgb", "flow"))
    if sorted(feats) != want:
        raise AssertionError(f"expected {want}, got {sorted(feats)}")
    for name, f in feats.items():
        if f.shape != (I3D_STACKS, 1024) or not np.isfinite(f).all():
            raise AssertionError(f"{name}: shape {f.shape}, finite {np.isfinite(f).all()}")
    expected = I3D_VIDEOS * I3D_STACKS * len(CORR_LEVELS)
    if launches != expected:
        raise AssertionError(f"local_correlation launched {launches} times, expected {expected}")
    print(f"I3D path (--feature_type i3d --flow_type pwc, cold CLI run, model build included): "
          f"{I3D_VIDEOS} videos in {wall:.3f} s, {I3D_VIDEOS / wall:.3f} videos/s; "
          f"local_correlation launches {launches}")

    ex = build_extractor(ExtractionConfig(feature_type="i3d", video_paths=clips,
                                          allow_random_init=True), external_call=True)
    models = ex.warmup(device)
    frames, fps, stamps, _, path = ex.prepare(clips[0])
    stack = torch.from_numpy(np.stack(frames[: STACK + 1])).to(device)
    compare_stack(stack_streams(ex, models, stack),
                  stack_streams(ex, models, stack, corr_method="plain"),
                  "one stack on the card, K2 vs the plain cost volume")

    clip65 = synth_video(os.path.join(root, "i3d65.mp4"), n_frames=STACK + 1, seed=9)
    ex65 = build_extractor(ExtractionConfig(feature_type="i3d", video_paths=[clip65],
                                            allow_random_init=True), external_call=True)
    (card,) = ex65(device=device)
    for stream in ("rgb", "flow"):  # phase 17 holds its served fan-out against these
        np.save(os.path.join(root, f"i3d65_card_{stream}.npy"), card[stream])
    (cpu,) = ex65(device=torch.device("cpu"))
    stack65 = torch.from_numpy(np.stack(ex65.prepare(clip65)[0]))
    card_steps = stack_streams(ex65, ex65.warmup(device), stack65.to(device))
    cpu_steps = stack_streams(ex65, ex65.warmup(torch.device("cpu")), stack65)
    compare_stack(card_steps, cpu_steps,
                  "one 65-frame clip, step by step, the card vs the port on the CPU")
    rgb_err, flow_err = rel_l2(card["rgb"], cpu["rgb"]), rel_l2(card["flow"], cpu["flow"])
    flow_tol = flow_feature_rtol(float(np.mean(card_steps[1] != cpu_steps[1])), cpu_steps[1])
    print(f"features of that clip through ExtractI3D, card vs CPU: rgb rel_l2 {rgb_err:.3e} "
          f"(tol {I3D_FEATURE_RTOL:g}), flow rel_l2 {flow_err:.3e} (tol {flow_tol:.3e})")
    if not (rgb_err <= I3D_FEATURE_RTOL and flow_err <= flow_tol):
        raise AssertionError(f"card and CPU features disagree: rgb {rgb_err}, flow {flow_err}")

    prep, fwd = warm_split(ex, clips, device)
    warm = prep + fwd
    print(f"I3D path (warm extractor): {I3D_VIDEOS / warm:.3f} videos/s, "
          f"{warm / I3D_VIDEOS * 1e3:.2f} ms/video = host decode + resize "
          f"{prep / I3D_VIDEOS * 1e3:.2f} ms + forward (H2D, PWC, 2x I3D, D2H) "
          f"{fwd / I3D_VIDEOS * 1e3:.2f} ms, {I3D_STACKS} stacks each")
    one = (frames[: STACK + 1], fps, stamps[: STACK + 1], None, path)
    t0 = time.perf_counter()
    ex.forward(models, one)
    one_ms = (time.perf_counter() - t0) * 1e3
    print_top_kernels(device_kernels(lambda: ex.forward(models, one)), one_ms,
                      "one stack's forward on the device", top=10, mark="local_correlation",
                      expect=len(CORR_LEVELS))
    return launches


def run_pwc_path(root: str):
    """Phase 6; returns K2's launches on the PWC path's run."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.utils.synth import synth_video

    clip = synth_video(os.path.join(root, "pwc.mp4"), n_frames=PWC_CLIP_FRAMES, seed=5)
    out = os.path.join(root, "pwc_out")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--feature_type", "pwc", "--batch_size", str(PWC_BATCH), "--allow_random_init",
              "--on_extraction", "save_numpy", "--strict", "--output_path", out,
              "--tmp_path", os.path.join(root, "tmp"), "--video_paths", clip])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = local_correlation_kernel.launches
    (flow,) = read_features(out).values()
    shape = (PWC_CLIP_FRAMES - 1, 2, 240, 320)
    if flow.shape != shape or not np.isfinite(flow).all():
        raise AssertionError(f"pwc flow: shape {flow.shape} (expected {shape}), "
                             f"finite {np.isfinite(flow).all()}")
    windows = -(-(PWC_CLIP_FRAMES - 1) // PWC_BATCH)
    if launches != windows * len(CORR_LEVELS):
        raise AssertionError(f"local_correlation launched {launches} times, expected "
                             f"{windows * len(CORR_LEVELS)}")
    print(f"PWC path (--feature_type pwc --batch_size {PWC_BATCH}, cold CLI run): flow "
          f"{flow.shape}, |flow| max {np.abs(flow).max():.3f}, {wall:.3f} s; "
          f"local_correlation launches {launches}")
    return launches


def no_kernel_launches(label: str) -> None:
    """The paths without a hand-written kernel launch none."""
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention

    k1, k2 = flash_attention.launches, local_correlation_kernel.launches
    print(f"{label}: flash_attention launches {k1}, local_correlation launches {k2}")
    if k1 or k2:
        raise AssertionError(f"{label} launched a kernel it does not use: K1 {k1}, K2 {k2}")


def raft_stages(raft, stack, device):
    """Device ms of RAFT's stages on one padded stack (1, S+1, H, W, 3),
    each from CUDA events around back-to-back calls of that stage alone:
    the encoders, the volume and its pyramid, one iteration's lookup and
    update convolutions (x ``raft.iters``), and the final mask and
    upsampling; and of each convolution of the update block alone, at its
    input on this stack (x ``raft.iters``). The lookup and update run at
    the zero-flow coordinates. Returns ({stage: ms}, {conv: ms}, {conv: (module, its
    input)}); no profiler runs here, so nothing perturbs the times."""
    from video_features_tpu_torch.models.raft import model as rm

    with torch.inference_mode():
        _, T, H, W, _ = stack.shape
        x = (2.0 * (stack[0] / 255.0) - 1.0).permute(0, 3, 1, 2).contiguous()
        fmap = raft.fnet(x)
        pyramid = rm.build_corr_pyramid(fmap[:-1], fmap[1:])
        cnet = raft.cnet(x[:-1])
        net, inp = torch.split(cnet, [rm.HIDDEN_DIM, rm.CONTEXT_DIM], dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)
        coords = rm.coords_grid(T - 1, H // 8, W // 8, device=device)
        corr = rm.lookup_corr(pyramid, coords)
        flow = torch.zeros_like(coords)
        stages = {
            "fnet": time_ms(lambda: raft.fnet(x), iters=3, warmup=1),
            "cnet": time_ms(lambda: raft.cnet(x[:-1]), iters=3, warmup=1),
            "volume": time_ms(lambda: rm.build_corr_pyramid(fmap[:-1], fmap[1:]),
                              iters=5, warmup=1),
            "lookup": raft.iters * time_ms(lambda: rm.lookup_corr(pyramid, coords),
                                           iters=10, warmup=2),
            "update": raft.iters * time_ms(lambda: raft.update_block(net, inp, corr, flow),
                                           iters=5, warmup=1),
            "upsample": time_ms(lambda: rm.upsample_flow(
                flow, 0.25 * raft.update_block.mask(net)), iters=5, warmup=1),
        }
        inputs = {}

        def keep_input(name):
            def hook(mod, args, out):
                inputs[name] = (mod, args[0])  # returns None: the output stays
            return hook

        hooks = [m.register_forward_hook(keep_input(name))
                 for name, m in raft.update_block.named_modules()
                 if isinstance(m, torch.nn.Conv2d)]
        try:
            raft.update_block(net, inp, corr, flow)
        finally:
            for h in hooks:
                h.remove()
        convs = {name: raft.iters * time_ms(lambda mod=mod, arg=arg: mod(arg), iters=5, warmup=1)
                 for name, (mod, arg) in inputs.items()}
    return stages, convs, inputs


def run_i3d_raft_path(root: str, device):
    """Phase 7: I3D + RAFT, the slice's main path."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.models.raft.extract_raft import InputPadder
    from video_features_tpu_torch.utils.synth import synth_video

    clips = [synth_video(os.path.join(root, f"i3d_raft{i}.mp4"), n_frames=I3D_CLIP_FRAMES,
                         seed=i) for i in range(I3D_VIDEOS)]
    out = os.path.join(root, "i3d_raft_out")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--feature_type", "i3d", "--flow_type", "raft", "--allow_random_init",
              "--on_extraction", "save_numpy", "--strict", "--output_path", out,
              "--tmp_path", os.path.join(root, "tmp"), "--video_paths", *clips])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_kernel_launches("I3D + RAFT path")
    feats = read_features(out)
    want = sorted(f"i3d_raft{i}_{s}.npy" for i in range(I3D_VIDEOS) for s in ("rgb", "flow"))
    if sorted(feats) != want:
        raise AssertionError(f"expected {want}, got {sorted(feats)}")
    for name, f in feats.items():
        if f.shape != (I3D_STACKS, 1024) or not np.isfinite(f).all():
            raise AssertionError(f"{name}: shape {f.shape}, finite {np.isfinite(f).all()}")
    print(f"I3D + RAFT path (--feature_type i3d --flow_type raft, cold CLI run, model build "
          f"included): {I3D_VIDEOS} videos in {wall:.3f} s, {I3D_VIDEOS / wall:.3f} videos/s")

    # the warm extractor on the first clip only: its two stacks take ~2 s
    # of RAFT a pass, so the second clip would add ~4 s and no shape
    ex = build_extractor(ExtractionConfig(feature_type="i3d", flow_type="raft",
                                          video_paths=clips[:1], allow_random_init=True),
                         external_call=True)
    models = ex.warmup(device)
    frames, fps, stamps, _, path = ex.prepare(clips[0])
    short = torch.from_numpy(np.stack(frames[:RAFT_COMPARE_FRAMES]))
    t0 = time.perf_counter()
    cpu_steps = stack_streams(ex, ex.warmup(torch.device("cpu")), short)
    cpu_s = time.perf_counter() - t0
    compare_stack(stack_streams(ex, models, short.to(device)), cpu_steps,
                  f"one {RAFT_COMPARE_FRAMES}-frame stack (RAFT {RAFT_COMPARE_FRAMES - 1} pairs "
                  f"at {tuple(cpu_steps[0].shape[2:4])}), the card vs the port on the CPU "
                  f"({cpu_s:.1f} s there)")

    prep, fwd = warm_split(ex, clips[:1], device)
    warm = prep + fwd
    print(f"I3D + RAFT path (warm extractor, one clip): {1 / warm:.3f} videos/s, "
          f"{warm * 1e3:.2f} ms/video = host decode + resize {prep * 1e3:.2f} ms + forward "
          f"(H2D, RAFT, 2x I3D, D2H) {fwd * 1e3:.2f} ms, {I3D_STACKS} stacks")
    one = (frames[: STACK + 1], fps, stamps[: STACK + 1], None, path)
    t0 = time.perf_counter()
    for _ in range(3):
        ex.forward(models, one)  # ends in a copy to the host
    one_ms = (time.perf_counter() - t0) * 1e3 / 3

    stack = torch.from_numpy(np.stack(frames[: STACK + 1])).to(device)[None]
    stack = InputPadder(stack.shape[-3:-1]).pad_tensor(stack)
    stages, convs, conv_inputs = raft_stages(models["raft"], stack, device)
    traced = device_kernels(lambda: ex.forward(models, one))
    print_top_kernels(traced, one_ms, "one I3D + RAFT stack's forward on the device (wall: "
                      "the mean of 3 calls)", top=12)
    total = sum(stages.values())
    print(f"RAFT's stages on one stack ({STACK} pairs at {tuple(stack.shape[2:4])}, "
          f"{models['raft'].iters} iterations; CUDA events, each stage alone): "
          f"{total:.3f} ms in all, {one_ms:.3f} ms wall for the whole stack's forward:")
    for name, ms in stages.items():
        print(f"  {name} {ms:.3f} ms ({ms / total:.1%} of RAFT, {ms / one_ms:.1%} of the "
              f"stack's wall)")
    groups = {}
    for name, ms in convs.items():
        group = name.split(".")[0]  # encoder, gru, flow_head
        groups[group] = groups.get(group, 0.0) + ms
    print(f"the update block's convolutions alone, x{models['raft'].iters}: " + ", ".join(
        f"{g} {ms:.3f} ms ({ms / one_ms:.1%} of the stack's wall)" for g, ms in groups.items()))
    with torch.inference_mode():
        for name, ms in sorted(convs.items(), key=lambda kv: -kv[1]):
            mod, arg = conv_inputs[name]
            k = device_kernels(lambda mod=mod, arg=arg: mod(arg))
            top = max(k.items(), key=lambda kv: kv[1][0])[0] if k else "not measured"
            print(f"  {name} {tuple(mod.weight.shape)} {ms:.3f} ms; its top kernel {top[:70]}")
    return stages


def run_raft_path(root: str, device):
    """Phase 8: standalone RAFT on a clip whose sides are not multiples of 8."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.utils.synth import synth_video

    n, w, h = RAFT_CLIP
    clip = synth_video(os.path.join(root, "raft.mp4"), n_frames=n, width=w, height=h, seed=6)
    out = os.path.join(root, "raft_out")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--feature_type", "raft", "--batch_size", str(RAFT_BATCH), "--allow_random_init",
              "--on_extraction", "save_numpy", "--strict", "--output_path", out,
              "--tmp_path", os.path.join(root, "tmp"), "--video_paths", clip])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_kernel_launches("RAFT path")
    (flow,) = read_features(out).values()
    shape = (n - 1, 2, h, w)
    if flow.shape != shape or not np.isfinite(flow).all():
        raise AssertionError(f"raft flow: shape {flow.shape} (expected {shape}), "
                             f"finite {np.isfinite(flow).all()}")
    ex = build_extractor(ExtractionConfig(feature_type="raft", video_paths=[clip],
                                          batch_size=RAFT_BATCH, allow_random_init=True),
                         external_call=True)
    prep, fwd = warm_split(ex, [clip], device)
    print(f"RAFT path (--feature_type raft --batch_size {RAFT_BATCH}, {w}x{h} padded to "
          f"{-(-h // 8) * 8}x{-(-w // 8) * 8}): flow {flow.shape}, |flow| max "
          f"{np.abs(flow).max():.3f}; cold CLI run {wall:.3f} s; warm {1 / (prep + fwd):.3f} "
          f"videos/s, {(prep + fwd) * 1e3:.2f} ms/video = host decode + resize + pad "
          f"{prep * 1e3:.2f} ms + forward (H2D, RAFT, D2H) {fwd * 1e3:.2f} ms")


def run_cnn_path(root: str, device, feature_type: str, n_frames: int, want, batch_size=1):
    """Phases 9-10: a frame or clip CNN through the CLI, card vs CPU on a
    short clip, and warm videos/s."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.utils.synth import synth_video

    clip = synth_video(os.path.join(root, f"{feature_type}.mp4"), n_frames=n_frames, seed=7)
    out = os.path.join(root, f"{feature_type}_out")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--feature_type", feature_type, "--batch_size", str(batch_size),
              "--allow_random_init", "--on_extraction", "save_numpy", "--strict",
              "--output_path", out, "--tmp_path", os.path.join(root, "tmp"),
              "--video_paths", clip])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_kernel_launches(f"{feature_type} path")
    (feats,) = read_features(out).values()
    if feats.shape != want or not np.isfinite(feats).all():
        raise AssertionError(f"{feature_type}: shape {feats.shape} (expected {want}), "
                             f"finite {np.isfinite(feats).all()}")

    def extractor(clips):
        return build_extractor(ExtractionConfig(feature_type=feature_type, video_paths=clips,
                                                batch_size=batch_size, allow_random_init=True),
                               external_call=True)

    short = synth_video(os.path.join(root, f"{feature_type}_short.mp4"),
                        n_frames=SHORT_CLIP_FRAMES, seed=8)
    ex = extractor([short])
    (card,) = ex(device=device)
    (cpu,) = ex(device=torch.device("cpu"))
    err = rel_l2(card[feature_type], cpu[feature_type])
    print(f"{feature_type}: {SHORT_CLIP_FRAMES}-frame clip {card[feature_type].shape}, card vs "
          f"the port on the CPU rel_l2 {err:.3e} (tol {CNN_FEATURE_RTOL:g})")
    if not err <= CNN_FEATURE_RTOL:
        raise AssertionError(f"{feature_type}: card and CPU features disagree: {err}")

    ex = extractor([clip])
    prep, fwd = warm_split(ex, [clip], device)
    print(f"{feature_type} path (--batch_size {batch_size}, {n_frames}-frame 320x240 "
          f"clip): features {feats.shape}; cold CLI run {wall:.3f} s; warm "
          f"{1 / (prep + fwd):.3f} videos/s, {(prep + fwd) * 1e3:.2f} ms/video = host decode + "
          f"preprocess {prep * 1e3:.2f} ms + forward (H2D, model, D2H) {fwd * 1e3:.2f} ms")
    model = ex.warmup(device)
    payload = ex.prepare(clip)
    print_top_kernels(device_kernels(lambda: ex.forward(model, payload)), fwd * 1e3,
                      f"one {feature_type} video's forward on the device")


def vggish_host_split(path: str):
    """(read, resample, log-mel) seconds of the host frontend on one wav."""
    from video_features_tpu_torch.io.audio import read_wav, resample, to_mono
    from video_features_tpu_torch.models.vggish.mel import SAMPLE_RATE, waveform_to_examples

    t0 = time.perf_counter()
    data, rate = read_wav(path)
    t1 = time.perf_counter()
    mono = resample(to_mono(data), rate, SAMPLE_RATE)
    t2 = time.perf_counter()
    waveform_to_examples(mono, SAMPLE_RATE)
    return t1 - t0, t2 - t1, time.perf_counter() - t2


def run_vggish_path(root: str, device):
    """Phase 11: VGGish through the CLI on four 60 s wavs and one of 600 s."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.utils.synth import synth_wav

    wavs = [synth_wav(os.path.join(root, f"audio{i}.wav"), seconds=sec, sample_rate=VGGISH_RATE,
                      channels=2, seed=i) for i, sec in enumerate(VGGISH_SECONDS)]
    out = os.path.join(root, "vggish_out")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--feature_type", "vggish", "--allow_random_init", "--on_extraction", "save_numpy",
              "--strict", "--output_path", out, "--tmp_path", os.path.join(root, "tmp"),
              "--video_paths", *wavs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_kernel_launches("VGGish path")
    feats = read_features(out)
    for i, sec in enumerate(VGGISH_SECONDS):
        f, want = feats[f"audio{i}_vggish.npy"], (VGGISH_EXAMPLES[sec], 128)
        if f.shape != want or not np.isfinite(f).all():
            raise AssertionError(f"audio{i} ({sec:g} s): shape {f.shape} (expected {want}), "
                                 f"finite {np.isfinite(f).all()}")
    minutes = sum(VGGISH_SECONDS) / 60
    print(f"VGGish path (cold CLI run, model build included, --decode_workers 2): {len(wavs)} "
          f"wavs, {minutes:g} min of 44.1 kHz stereo audio, in {wall:.3f} s, "
          f"{len(wavs) / wall:.3f} videos/s; features {[f.shape for f in feats.values()]}")

    ex = build_extractor(ExtractionConfig(feature_type="vggish", video_paths=wavs[:4],
                                          allow_random_init=True), external_call=True)
    (card,) = ex([0], device=device)
    (cpu,) = ex([0], device=torch.device("cpu"))
    err = rel_l2(card["vggish"], cpu["vggish"])
    print(f"VGGish, one 60 s wav {card['vggish'].shape}: card vs the port on the CPU rel_l2 "
          f"{err:.3e} (tol {VGGISH_RTOL:g})")
    if not err <= VGGISH_RTOL:
        raise AssertionError(f"VGGish: card and CPU embeddings disagree: {err}")

    read_s, resample_s, mel_s = vggish_host_split(wavs[0])
    prep, fwd = warm_split(ex, wavs[:4], device)
    warm = prep + fwd
    print(f"VGGish path (warm extractor, 60 s wavs): {4 / warm:.3f} videos/s, "
          f"{warm / 4 * 1e3:.2f} ms/video = host read + resample + log-mel "
          f"{prep / 4 * 1e3:.2f} ms ({prep / warm:.1%}) + forward (H2D, VGGish, D2H) "
          f"{fwd / 4 * 1e3:.2f} ms; one wav's host: read {read_s * 1e3:.2f} ms, resample "
          f"44.1 -> 16 kHz {resample_s * 1e3:.2f} ms, log-mel {mel_s * 1e3:.2f} ms")
    model = ex.warmup(device)
    t0 = time.perf_counter()
    payload = ex.prepare(wavs[4])
    host_ms = (time.perf_counter() - t0) * 1e3
    ex.forward(model, payload)  # cuDNN's choice for this batch
    t0 = time.perf_counter()
    ex.forward(model, payload)  # ends in a copy to the host
    one_ms = (time.perf_counter() - t0) * 1e3
    print(f"VGGish, the 600 s wav: host {host_ms:.2f} ms, forward {one_ms:.3f} ms "
          f"({payload[0].shape[0]} examples)")
    print_top_kernels(device_kernels(lambda: ex.forward(model, payload)), one_ms,
                      "one forward of the 600 s wav on the device", top=10)


def run_contract_path(root: str, device):
    """Phase 12: the run contract on the CLIP path (full width, uni_12,
    --attn flash) over 8 clips: --decode_workers 0 against 2, injected
    prepare faults retried to 8/8, and --strict on a corrupt clip."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.utils.synth import synth_video

    clips = [synth_video(os.path.join(root, f"contract{i}.mp4"), seed=20 + i)
             for i in range(CONTRACT_VIDEOS)]

    def run(out, *extra, videos=clips):
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                  "--attn", "flash", "--allow_random_init", "--on_extraction", "save_numpy",
                  "--output_path", os.path.join(root, out), "--tmp_path",
                  os.path.join(root, "tmp"), *extra, "--video_paths", *videos])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, flash_attention.launches, read_features(
            os.path.join(root, out))

    def summary_of(out):
        with open(os.path.join(root, out, "_manifest", "summary.json")) as f:
            return json.load(f)

    def max_err(a, b):
        if sorted(a) != sorted(b):
            raise AssertionError(f"different files: {sorted(a)} vs {sorted(b)}")
        return max(float(np.abs(a[k] - b[k]).max()) for k in a)

    print(f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} usable by this "
          f"process, torch intra-op threads {torch.get_num_threads()}")
    feats = {}
    for workers in ("0", "2"):
        wall, launches, feats[workers] = run(f"contract_w{workers}", "--strict",
                                             "--decode_workers", workers)
        if len(feats[workers]) != CONTRACT_VIDEOS or launches != CONTRACT_VIDEOS * LAYERS:
            raise AssertionError(f"--decode_workers {workers}: {len(feats[workers])} files, "
                                 f"flash_attention launches {launches}")
        print(f"run contract, --decode_workers {workers} (cold CLI run, model build included): "
              f"{CONTRACT_VIDEOS} videos in {wall:.3f} s, {CONTRACT_VIDEOS / wall:.3f} videos/s; "
              f"flash_attention launches {launches}")
    err = max_err(feats["2"], feats["0"])
    print(f"features --decode_workers 2 vs 0: max_abs_err {err:.3e} (tol {CONTRACT_ATOL:g})")
    if not err <= CONTRACT_ATOL:
        raise AssertionError(f"--decode_workers 0 and 2 disagree: {err}")

    exs = {w: build_extractor(ExtractionConfig(
        feature_type="CLIP-ViT-B/32", video_paths=clips, extract_method=f"uni_{FRAMES}",
        attn="flash", allow_random_init=True, decode_workers=w), external_call=True)
        for w in (0, 2)}
    for ex in exs.values():
        ex(device=device)  # model build, cuBLAS and allocator set-up
    walls = {0: [], 2: []}
    for w in (0, 2, 2, 0):
        t0 = time.perf_counter()
        exs[w](device=device)  # ends in copies to the host
        walls[w].append(time.perf_counter() - t0)
    vps = {w: [CONTRACT_VIDEOS / t for t in ts] for w, ts in walls.items()}
    print(f"run contract, warm extractor, {CONTRACT_VIDEOS} videos a pass in turns 0, 2, 2, 0: "
          f"--decode_workers 0 {vps[0][0]:.3f} and {vps[0][1]:.3f} videos/s, --decode_workers 2 "
          f"{vps[2][0]:.3f} and {vps[2][1]:.3f} videos/s "
          f"({sum(vps[2]) / sum(vps[0]):.2f}x)")

    wall, launches, faulted = run("contract_fault", "--strict", "--decode_workers", "2",
                                  "--fault_inject", "prepare:error:3", "--retries", "2",
                                  "--retry_backoff", "0")
    summary = summary_of("contract_fault")
    err = max_err(faulted, feats["2"])
    print(f"run contract, --fault_inject prepare:error:3: {summary['done']}/{summary['total']} "
          f"done, {summary['failed']} failed, {summary['retries']} retries; features vs the "
          f"clean run max_abs_err {err:.3e}; flash_attention launches {launches}")
    if not (summary["done"] == summary["total"] == CONTRACT_VIDEOS and summary["failed"] == 0
            and summary["retries"] >= 1 and err <= CONTRACT_ATOL):
        raise AssertionError(f"injected prepare faults were not recovered: {summary}")

    bad = os.path.join(root, "corrupt.mp4")
    with open(bad, "wb") as f:
        f.write(b"not a video")
    good = clips[:3]
    try:
        run("contract_strict", "--strict", videos=good + [bad])
    except SystemExit as exc:
        code = exc.code
    else:
        raise AssertionError("--strict with a corrupt clip exited 0")
    rec = summary_of("contract_strict")["videos"][bad]
    written = read_features(os.path.join(root, "contract_strict"))
    print(f"run contract, --strict with a corrupt clip among {len(good)} good ones: exit "
          f"{str(code).splitlines()[0]!r}; its record {rec['status']}, {rec['error_class']}, "
          f"{rec['error_type']}; {len(written)} good files written")
    if code in (0, None) or (rec["status"], rec["error_class"]) != ("failed", "permanent") \
            or len(written) != len(good):
        raise AssertionError(f"--strict run: exit {code!r}, record {rec}, files {sorted(written)}")


def ingest_cli(root: str, out: str, feature_args, videos, *extra):
    """One --strict CLI run with every launch count at 0 first: (wall s,
    K1 launches, K2 launches, the .npy files by name)."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention

    reset_counts()
    t0 = time.perf_counter()
    cli.main([*feature_args, "--allow_random_init", "--on_extraction", "save_numpy", "--strict",
              "--output_path", os.path.join(root, out), "--tmp_path", os.path.join(root, "tmp"),
              *extra, "--video_paths", *videos])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (wall, flash_attention.launches, local_correlation_kernel.launches,
            read_features(os.path.join(root, out)))


def max_abs_diff(a, b) -> float:
    if sorted(a) != sorted(b):
        raise AssertionError(f"different files: {sorted(a)} vs {sorted(b)}")
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def run_ingest_clip(root: str, device) -> int:
    """The async ingest phase on CLIP (full width, uni_12, --attn flash, 8
    clips): --video_batch x --inflight_groups through the CLI, the warm
    videos/s of each, the fused forward's idle share, the group's pinning
    time, and a dispatch fault injected into a fused group. Returns K1's
    launches in its CLI runs."""
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract import ingest
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.utils.synth import synth_video

    clips = [synth_video(os.path.join(root, f"contract{i}.mp4"), seed=20 + i)
             for i in range(CONTRACT_VIDEOS)]
    clip_args = ["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                 "--attn", "flash"]
    settings = [(vb, ig) for vb in INGEST_VIDEO_BATCHES for ig in INGEST_INFLIGHT]
    feats, launches = {}, 0
    for vb, ig in settings:
        wall, k1, k2, feats[vb, ig] = ingest_cli(
            root, f"ingest_clip_{vb}_{ig}", clip_args, clips,
            "--video_batch", str(vb), "--inflight_groups", str(ig))
        dispatches = -(-CONTRACT_VIDEOS // vb)
        err = max_abs_diff(feats[vb, ig], feats[INGEST_VIDEO_BATCHES[0], INGEST_INFLIGHT[0]])
        print(f"async ingest, CLIP --video_batch {vb} --inflight_groups {ig} (cold CLI run): "
              f"{CONTRACT_VIDEOS} videos in {wall:.3f} s; {dispatches} dispatches, "
              f"flash_attention launches {k1}; features vs --video_batch 1 --inflight_groups 1 "
              f"max_abs_err {err:.3e} (tol {INGEST_ATOL:g})")
        if len(feats[vb, ig]) != CONTRACT_VIDEOS or k1 != LAYERS * dispatches or k2:
            raise AssertionError(f"--video_batch {vb} --inflight_groups {ig}: "
                                 f"{len(feats[vb, ig])} files, K1 {k1}, K2 {k2}")
        if not err <= INGEST_ATOL:
            raise AssertionError(f"--video_batch {vb} --inflight_groups {ig} disagrees: {err}")
        launches += k1

    exs = {(vb, ig): build_extractor(ExtractionConfig(
        feature_type="CLIP-ViT-B/32", video_paths=clips, extract_method=f"uni_{FRAMES}",
        attn="flash", allow_random_init=True, video_batch=vb, inflight_groups=ig),
        external_call=True) for vb, ig in settings}
    for ex in exs.values():
        ex(device=device)  # model build, cuBLAS and allocator set-up at this batch
    vps = {k: [] for k in settings}
    for order in (settings, settings[::-1]):  # two passes, the second in reverse
        for k in order:
            t0 = time.perf_counter()
            exs[k](device=device)  # ends in copies to the host
            vps[k].append(CONTRACT_VIDEOS / (time.perf_counter() - t0))
    print(f"async ingest, CLIP warm extractor (--decode_workers 2, {CONTRACT_VIDEOS} videos a "
          "pass, two passes, the second in reverse order), videos/s:")
    for (vb, ig), v in vps.items():
        print(f"  --video_batch {vb} --inflight_groups {ig}: {v[0]:.3f} and {v[1]:.3f}")

    ex = exs[4, 2]
    model = ex.warmup(device)
    payloads = [ex.prepare(c) for c in clips[:4]]
    x = np.concatenate([p[0] for p in payloads])
    pins = []
    for _ in range(3):
        t0 = time.perf_counter()
        ingest.pinned_copy(x)
        pins.append((time.perf_counter() - t0) * 1e3)
    print(f"async ingest, pinning one --video_batch 4 group ({x.nbytes / 2 ** 20:.1f} MiB): "
          f"{', '.join(f'{ms:.3f}' for ms in pins)} ms (first and then cached blocks)")
    for vb, group in ((1, payloads[:1]), (4, payloads)):
        t0 = time.perf_counter()
        ex.fetch_group(ex.dispatch_group(model, group))
        wall_ms = (time.perf_counter() - t0) * 1e3
        print_top_kernels(device_kernels(lambda: ex.fetch_group(ex.dispatch_group(model, group))),
                          wall_ms, f"async ingest, one fused CLIP forward of {vb} video(s) "
                          "(H2D, model, D2H) on the device", mark="flash_attention",
                          expect=LAYERS)

    wall, k1, _, faulted = ingest_cli(root, "ingest_clip_fault", clip_args, clips,
                                      "--video_batch", "4", "--fault_inject", "dispatch:error:2")
    with open(os.path.join(root, "ingest_clip_fault", "_manifest", "summary.json")) as f:
        summary = json.load(f)
    fallbacks = [e for e in summary["events"] if e.get("event") == "group_fallback"]
    err = max_abs_diff(faulted, feats[1, 1])
    print(f"async ingest, CLIP --video_batch 4 --fault_inject dispatch:error:2: "
          f"{summary['done']}/{summary['total']} done, {summary['failed']} failed, "
          f"group_fallback events {[(e['phase'], e['size']) for e in fallbacks]}; "
          f"flash_attention launches {k1}; features vs --video_batch 1 max_abs_err {err:.3e}")
    if not (summary["done"] == summary["total"] == CONTRACT_VIDEOS and summary["failed"] == 0
            and len(fallbacks) == 1 and k1 == LAYERS * (1 + 4) and err <= INGEST_ATOL):
        raise AssertionError(f"the fused-group fault was not recovered: {summary}")
    return launches + k1


def run_ingest_cnns(root: str, device):
    """ResNet-50, R(2+1)D-18 and VGGish at --video_batch 4 on 4 short
    inputs against --video_batch 1, and the warm videos/s of both."""
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.utils.synth import synth_video, synth_wav

    short = [synth_video(os.path.join(root, f"ingest_short{i}.mp4"), n_frames=SHORT_CLIP_FRAMES,
                         seed=30 + i) for i in range(4)]
    wavs = [synth_wav(os.path.join(root, f"ingest_audio{i}.wav"), seconds=INGEST_WAV_SECONDS,
                      sample_rate=VGGISH_RATE, channels=2, seed=30 + i) for i in range(4)]
    families = [("resnet50", short, dict(batch_size=RESNET_BATCH), CNN_FEATURE_RTOL),
                ("r21d_rgb", short, {}, CNN_FEATURE_RTOL),
                ("vggish", wavs, {}, VGGISH_RTOL)]
    for feature_type, inputs, kw, tol in families:
        exs = {vb: build_extractor(ExtractionConfig(
            feature_type=feature_type, video_paths=inputs, allow_random_init=True,
            video_batch=vb, **kw), external_call=True) for vb in (1, 4)}
        reset_counts()
        got = {vb: ex(device=device) for vb, ex in exs.items()}  # the warm-up passes
        no_kernel_launches(f"async ingest, {feature_type}")
        err = max(rel_l2(f[feature_type], s[feature_type]) for f, s in zip(got[4], got[1]))
        vps = {1: [], 4: []}
        for vb in (1, 4, 4, 1):
            t0 = time.perf_counter()
            exs[vb](device=device)
            vps[vb].append(len(inputs) / (time.perf_counter() - t0))
        print(f"async ingest, {feature_type} --video_batch 4 on {len(inputs)} inputs "
              f"{[f[feature_type].shape for f in got[4]]}: rel_l2 vs --video_batch 1 "
              f"{err:.3e} (tol {tol:g}); warm videos/s in turns 1, 4, 4, 1: --video_batch 1 "
              f"{vps[1][0]:.3f} and {vps[1][1]:.3f}, --video_batch 4 {vps[4][0]:.3f} and "
              f"{vps[4][1]:.3f}")
        if not err <= tol:
            raise AssertionError(f"{feature_type}: fused and solo features disagree: {err}")


def run_ingest_flow(root: str, device):
    """PWC (--batch_size 8 --video_batch 2, two 30-frame clips) and I3D +
    PWC (--batch_size 2 --video_batch 2, two 65-frame clips) against their
    solo runs (K2 is held to its plain version at these two fused shapes
    in phase 3). Returns K2's launches in the fused runs."""
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.utils.synth import synth_video

    pwc_clips = [synth_video(os.path.join(root, f"ingest_pwc{i}.mp4"),
                             n_frames=INGEST_PWC_FRAMES, seed=40 + i) for i in range(2)]
    pwc_args = ["--feature_type", "pwc", "--batch_size", str(PWC_BATCH)]
    _, _, solo_k2, solo = ingest_cli(root, "ingest_pwc_1", pwc_args, pwc_clips)
    wall, _, k2, fused = ingest_cli(root, "ingest_pwc_2", pwc_args, pwc_clips,
                                    "--video_batch", "2")
    windows = 2 * -(-(INGEST_PWC_FRAMES - 1) // PWC_BATCH)
    dispatches = -(-windows // 2)
    err = max_abs_diff(fused, solo)
    tol = FLOW_RTOL * max(max(float(np.abs(f).max()) for f in solo.values()), 1.0)
    print(f"async ingest, PWC --batch_size {PWC_BATCH} --video_batch 2 on 2 clips of "
          f"{INGEST_PWC_FRAMES} frames: flow {[f.shape for f in fused.values()]}, {windows} "
          f"windows in {dispatches} fused forwards of {2 * PWC_BATCH} pairs, cold CLI run "
          f"{wall:.3f} s; local_correlation launches {k2} (solo run {solo_k2}); flow vs solo "
          f"max_abs_err {err:.3e} (tol {tol:.3e})")
    if k2 != len(CORR_LEVELS) * dispatches or not err <= tol:
        raise AssertionError(f"PWC --video_batch 2: K2 launches {k2}, flow error {err}")
    launches = k2

    i3d_clips = [synth_video(os.path.join(root, f"ingest_i3d{i}.mp4"), n_frames=STACK + 1,
                             seed=50 + i) for i in range(2)]
    i3d_args = ["--feature_type", "i3d", "--flow_type", "pwc", "--batch_size", "2"]
    _, _, solo_k2, solo = ingest_cli(root, "ingest_i3d_1", i3d_args, i3d_clips)
    wall, _, k2, fused = ingest_cli(root, "ingest_i3d_2", i3d_args, i3d_clips,
                                    "--video_batch", "2")
    # the levels the flow features see, solo (each stack beside the zero
    # stack that pads its group) and fused (the two stacks together)
    ex = build_extractor(ExtractionConfig(feature_type="i3d", video_paths=i3d_clips,
                                          allow_random_init=True), external_call=True)
    models = ex.warmup(device)
    stacks = [torch.from_numpy(np.stack(ex.prepare(c)[0])).to(device) for c in i3d_clips]
    both = stack_streams(ex, models, torch.stack(stacks))
    flips, levels = [], []
    for i, st in enumerate(stacks):
        alone = stack_streams(ex, models, torch.stack([st, torch.zeros_like(st)]))
        flips.append(float(np.mean(alone[1][0] != both[1][i])))
        levels.append(alone[1][0])
    flow_tol = flow_feature_rtol(max(flips), np.stack(levels))
    print(f"async ingest, I3D + PWC --batch_size 2 --video_batch 2 on 2 clips of {STACK + 1} "
          f"frames: cold CLI run {wall:.3f} s; local_correlation launches {k2} (solo run "
          f"{solo_k2}); uint8 flow levels flipped fused vs solo {max(flips):.3e}")
    for name in sorted(fused):
        tol = flow_tol if name.endswith("_flow.npy") else I3D_FEATURE_RTOL
        err = rel_l2(fused[name], solo[name])
        print(f"  {name} {fused[name].shape}: rel_l2 vs solo {err:.3e} (tol {tol:.3e})")
        if fused[name].shape != (1, 1024) or not err <= tol:
            raise AssertionError(f"I3D --video_batch 2: {name} {fused[name].shape}, {err}")
    if sorted(fused) != sorted(solo) or len(fused) != 4 or k2 != len(CORR_LEVELS):
        raise AssertionError(f"I3D --video_batch 2: files {sorted(fused)}, K2 launches {k2}")
    return launches + k2


def run_ingest_path(root: str, device):
    """Phase 13, async ingest. Returns each kernel's launches in its CLI
    runs."""
    k1 = run_ingest_clip(root, device)
    run_ingest_cnns(root, device)
    return {"flash_attention": k1, "local_correlation": run_ingest_flow(root, device)}


def decode_s(ex, clip) -> float:
    """Seconds to decode ``clip`` as ``ex.prepare`` does, without its
    preprocessing: the host ms of a video split into decode and the rest."""
    from video_features_tpu_torch.io.video import extract_frames, stream_frames

    t0 = time.perf_counter()
    if hasattr(ex, "_sample_frames"):  # I3D's sampling grid
        ex._sample_frames(clip)
    elif ex.config.extract_method:  # CLIP's uni_N / fix_N
        extract_frames(clip, ex.config.extract_method, ex.config.decoder)
    else:
        for _ in stream_frames(clip, ex.config.extraction_fps, ex.config.decoder):
            pass
    return time.perf_counter() - t0


def device_family(root: str, device, label: str, feature_args, clips, check, k1_want=None,
                  k2_want=None):
    """One family at --preprocess host and device through the CLI (counts
    at 0 before each run), the outputs held by ``check``, the kernels'
    launches equal in both runs; then both modes' warm serial split (host
    decode and preprocess, forward) and videos/s. ``check`` is 'abs' or
    'rel' (within DEVICE_DRIFT), or 'identity' for RAFT and PWC without a
    resize: the first window's model input on the card equal bit for bit
    on both paths, and the flows within FLOW_RTOL of the largest, beside
    a second host run's own spread. Returns (the device run's K1 and K2
    launches, its features, the extractors by mode)."""
    from video_features_tpu_torch.config import parse_args
    from video_features_tpu_torch.extract.ingest import place_taps
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.ops.preprocess import device_resize_frames

    slug = label.replace(" ", "_").replace("+", "").lower()
    modes = ("host", "device", "host again") if check == "identity" else ("host", "device")
    runs = {mode: ingest_cli(root, f"devpre_{slug}_{mode.replace(' ', '_')}", feature_args,
                             clips, "--preprocess", mode.split()[0]) for mode in modes}
    (h_wall, h_k1, h_k2, host), (d_wall, d_k1, d_k2, dev) = runs["host"], runs["device"]
    if sorted(dev) != sorted(host) or not host:
        raise AssertionError(f"{label}: files {sorted(dev)} vs {sorted(host)}")
    for name in sorted(host):
        if dev[name].shape != host[name].shape or not np.isfinite(dev[name]).all():
            raise AssertionError(f"{label} {name}: {dev[name].shape} vs {host[name].shape}, "
                                 f"finite {np.isfinite(dev[name]).all()}")
    exs = {mode: build_extractor(parse_args([*feature_args, "--allow_random_init",
                                             "--preprocess", mode, "--video_paths", *clips]),
                                 external_call=True) for mode in ("host", "device")}
    if check == "rel":
        err, tol = max(rel_l2(dev[k], host[k]) for k in host), DEVICE_DRIFT
        what = f"rel_l2 {err:.3e} (tol {tol:g})"
    else:
        err = max_abs_diff(dev, host)
        tol = DEVICE_DRIFT
        what = f"max_abs_err {err:.3e} (tol {tol:g})"
    if check == "identity":
        host_in = torch.from_numpy(exs["host"].prepare(clips[0])[0][0]).to(device)
        windows, _, _, taps = exs["device"].prepare(clips[0])[:4]
        dev_in = device_resize_frames(torch.from_numpy(windows[0]).to(device),
                                      *place_taps(taps, device))
        same_input = dev_in.shape == host_in.shape and torch.equal(dev_in, host_in)
        tol = FLOW_RTOL * max(max(float(np.abs(f).max()) for f in host.values()), 1.0)
        what = (f"first window's model input equal {same_input}; flow max_abs_err {err:.3e} "
                f"(tol {tol:.3e}; a second host run against the first "
                f"{max_abs_diff(runs['host again'][3], host):.3e})")
        if not same_input:
            raise AssertionError(f"{label}: the device input differs from the host's")
    print(f"device preprocess, {label}: {len(host)} files {[dev[k].shape for k in sorted(dev)]}"
          f"; device vs host {what}; cold CLI runs host {h_wall:.3f} s, device {d_wall:.3f} s; "
          f"launches host K1 {h_k1} K2 {h_k2}, device K1 {d_k1} K2 {d_k2}")
    if not err <= tol:
        raise AssertionError(f"{label}: device and host outputs disagree: {err}")
    if (d_k1, d_k2) != (h_k1, h_k2) or (k1_want is not None and d_k1 != k1_want) or (
            k2_want is not None and d_k2 != k2_want):
        raise AssertionError(f"{label}: launches host {(h_k1, h_k2)}, device {(d_k1, d_k2)}, "
                             f"expected {(k1_want, k2_want)}")

    line = []
    for mode, ex in exs.items():
        prep, fwd = warm_split(ex, clips, device)
        dec = sum(decode_s(ex, c) for c in clips)
        n = len(clips)
        line.append(f"{mode} {n / (prep + fwd):.3f} videos/s = decode {dec / n * 1e3:.2f} ms + "
                    f"preprocess {(prep - dec) / n * 1e3:.2f} ms + forward (H2D, "
                    f"{'resample, ' if mode == 'device' else ''}model, D2H) "
                    f"{fwd / n * 1e3:.2f} ms a video")
    print(f"device preprocess, {label}, warm serial: " + "; ".join(line))
    return d_k1, d_k2, dev, exs


def run_device_path(root: str, device):
    """Phase 14, --preprocess device (uint8 ingest, the PIL-semantics
    banded resize on the card) against --preprocess host for CLIP (phase
    12's clips, --attn flash), ResNet-50, RAFT, PWC and I3D + PWC on their
    earlier phases' clips; CLIP's --video_batch 4 device groups against
    solo, the warm pipelined videos/s of both modes, the pinned bytes and
    time of a group, and a fused device forward's idle share. Returns each
    kernel's launches in the device runs."""
    from video_features_tpu_torch.extract import ingest
    from video_features_tpu_torch.utils.synth import synth_video

    contract = [synth_video(os.path.join(root, f"contract{i}.mp4"), seed=20 + i)
                for i in range(CONTRACT_VIDEOS)]
    clip_args = ["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                 "--attn", "flash"]
    k1, _, clip_dev, clip_exs = device_family(root, device, "CLIP", clip_args, contract, "abs",
                                              k1_want=CONTRACT_VIDEOS * LAYERS, k2_want=0)
    groups = -(-CONTRACT_VIDEOS // DEVICE_VIDEO_BATCH)
    wall, k1_fused, k2_fused, fused = ingest_cli(
        root, "devpre_clip_fused", clip_args, contract, "--preprocess", "device",
        "--video_batch", str(DEVICE_VIDEO_BATCH))
    err = max_abs_diff(fused, clip_dev)
    print(f"device preprocess, CLIP --video_batch {DEVICE_VIDEO_BATCH}: {groups} fused "
          f"dispatches in {wall:.3f} s (cold CLI run), flash_attention launches {k1_fused}; "
          f"features vs the device solo run max_abs_err {err:.3e} (tol {INGEST_ATOL:g})")
    if not err <= INGEST_ATOL or (k1_fused, k2_fused) != (LAYERS * groups, 0):
        raise AssertionError(f"CLIP device groups: err {err}, launches {k1_fused}, {k2_fused}")
    k1 += k1_fused

    vps = {"host": [], "device": []}
    exs = {mode: clip_exs[mode] for mode in vps}
    for mode in ("host", "device", "device", "host"):
        t0 = time.perf_counter()
        exs[mode](device=device)  # the pipelined loop, --decode_workers 2
        vps[mode].append(CONTRACT_VIDEOS / (time.perf_counter() - t0))
    print(f"device preprocess, CLIP warm pipelined (--decode_workers 2, {CONTRACT_VIDEOS} "
          f"videos, turns host, device, device, host): host {vps['host'][0]:.3f} and "
          f"{vps['host'][1]:.3f} videos/s, device {vps['device'][0]:.3f} and "
          f"{vps['device'][1]:.3f} videos/s")

    from video_features_tpu_torch.config import parse_args
    from video_features_tpu_torch.extract.registry import build_extractor

    for mode in ("host", "device"):
        ex = build_extractor(parse_args([*clip_args, "--allow_random_init", "--preprocess", mode,
                                         "--video_batch", str(DEVICE_VIDEO_BATCH),
                                         "--video_paths", *contract]), external_call=True)
        model = ex.warmup(device)
        group = [ex.prepare(c) for c in contract[:DEVICE_VIDEO_BATCH]]
        x = (np.concatenate([p[0] for p in group]) if mode == "host"
             else np.stack([p[0][0] for p in group]))
        pins = []
        for _ in range(3):
            t0 = time.perf_counter()
            ingest.pinned_copy(x)
            pins.append((time.perf_counter() - t0) * 1e3)
        print(f"device preprocess, pinning one CLIP --video_batch {DEVICE_VIDEO_BATCH} group at "
              f"--preprocess {mode}: {x.dtype} {x.shape}, {x.nbytes / 2 ** 20:.1f} MiB in "
              f"{', '.join(f'{ms:.3f}' for ms in pins)} ms")
        ex.fetch_group(ex.dispatch_group(model, group))
        t0 = time.perf_counter()
        ex.fetch_group(ex.dispatch_group(model, group))
        wall_ms = (time.perf_counter() - t0) * 1e3
        print_top_kernels(device_kernels(lambda: ex.fetch_group(ex.dispatch_group(model, group))),
                          wall_ms, f"device preprocess, one fused CLIP forward of "
                          f"{DEVICE_VIDEO_BATCH} videos at --preprocess {mode} (H2D, "
                          f"{'resample, ' if mode == 'device' else ''}model, D2H)",
                          mark="flash_attention", expect=LAYERS)

    resnet = synth_video(os.path.join(root, "devpre_resnet.mp4"), n_frames=RESNET_CLIP_FRAMES,
                         seed=7)
    device_family(root, device, "ResNet-50", ["--feature_type", "resnet50", "--batch_size",
                                              str(RESNET_BATCH)], [resnet], "rel",
                  k1_want=0, k2_want=0)
    frames, width, height = RAFT_CLIP
    raft = synth_video(os.path.join(root, "devpre_raft.mp4"), n_frames=frames, width=width,
                       height=height, seed=6)
    device_family(root, device, "RAFT", ["--feature_type", "raft", "--batch_size",
                                         str(RAFT_BATCH)], [raft], "identity", k1_want=0, k2_want=0)
    pwc = synth_video(os.path.join(root, "devpre_pwc.mp4"), n_frames=PWC_CLIP_FRAMES, seed=5)
    windows = -(-(PWC_CLIP_FRAMES - 1) // PWC_BATCH)
    _, k2, _, _ = device_family(root, device, "PWC", ["--feature_type", "pwc", "--batch_size",
                                                      str(PWC_BATCH)], [pwc], "identity",
                                k1_want=0, k2_want=windows * len(CORR_LEVELS))
    i3d = [synth_video(os.path.join(root, f"devpre_i3d{i}.mp4"), n_frames=I3D_CLIP_FRAMES,
                       seed=i) for i in range(I3D_VIDEOS)]
    _, k2_i3d, _, _ = device_family(
        root, device, "I3D + PWC", ["--feature_type", "i3d", "--flow_type", "pwc"], i3d, "rel",
        k1_want=0, k2_want=I3D_VIDEOS * I3D_STACKS * len(CORR_LEVELS))
    return {"flash_attention": k1, "local_correlation": k2 + k2_i3d}


def hold_fused_shapes(device):
    """Phase 3, the fused shapes of phase 13: K1 at N=64 and K2 at N=16 and
    N=128 against their plain versions, each with a profiler window of its
    own early in the process (late in a long run the profiler loses
    launches). Returns each kernel's records by shape."""
    attention = hold_flash_attention(device, FUSED_ATTENTION_SHAPE, torch.float32, None,
                                     seed=200)
    pwc = hold_correlation_levels(device, 2 * PWC_BATCH, pwc_levels(256, 320),
                                  "a fused PWC forward", seed=300)
    i3d = hold_correlation_levels(device, 2 * STACK, CORR_LEVELS, "a fused I3D stack group",
                                  seed=400)
    return {"flash_attention": {"N=64 (--video_batch 4)": attention},
            "local_correlation": {"N=16 (pwc --video_batch 2)": pwc,
                                  "N=128 (i3d --video_batch 2)": i3d}}


def hold_mesh_shapes(device):
    """Phase 3, K1 at the mesh shapes of phases 21 and 24 (``MESH_ATTENTION_SHAPES``)
    against its plain version, early, where the profiler keeps every
    launch. Returns the records by shape."""
    return {label: hold_flash_attention(device, shape, torch.float32, None, seed=500 + i)
            for i, (label, shape) in enumerate(MESH_ATTENTION_SHAPES.items())}


def hold_mesh_correlation(device):
    """Phase 3, K2 at phase 22's per-shard shapes (``MESH_CORRELATION_CASES``:
    PWC's five levels at each) against its plain version, early, where the
    profiler keeps every launch. Returns the records by shape."""
    return {label: hold_correlation_levels(device, n, pwc_levels(hp, wp), f"a mesh row, {label}",
                                           seed=600 + 10 * i)
            for i, (label, (n, hp, wp)) in enumerate(MESH_CORRELATION_CASES.items())}


def resample_taps(src, taps, device):
    """The placed taps of one ``RESAMPLE_CASES`` entry, and the bucket."""
    from video_features_tpu_torch.extract.ingest import place_taps
    from video_features_tpu_torch.ops.resize import (
        fused_resize_crop_banded,
        shape_contract_banded,
    )
    from video_features_tpu_torch.ops.window import spatial_bucket

    h, w = src
    bh, bw = spatial_bucket(h, w)
    if taps[0] == "fused":
        _, resize_to, crop, method = taps
        wt_y, idx_y, wt_x, idx_x = fused_resize_crop_banded(h, w, resize_to, crop, method,
                                                           bh, bw)
    else:
        _, side, (out_h, out_w), (top, left) = taps
        wt_y, idx_y, wt_x, idx_x = shape_contract_banded(h, w, side, out_h, out_w, top, left,
                                                         "bilinear", bh, bw, "edge")
    return place_taps(((wt_y, idx_y), (wt_x, idx_x)), device), (bh, bw)


def measure_resample(device):
    """Phase 3, the device preprocess's banded resample (plain torch ops,
    as the JAX package leaves it to XLA) at the main paths' shapes: its
    time by CUDA events and, from a profiler window of its own, its device
    time and launches; the bytes it must move (uint8 frames in, fp32 out)
    over the card's rate give its bound. Returns the records by label."""
    from video_features_tpu_torch.ops.preprocess import (
        CLIP_MEAN,
        CLIP_STD,
        device_preprocess_frames,
        device_resize_frames,
    )
    from video_features_tpu_torch.extract.ingest import stack_taps

    records = {}
    rng = np.random.default_rng(500)
    for label, lead, src, taps, per_video, normalize in RESAMPLE_CASES:
        placed, bucket = resample_taps(src, taps, device)
        if per_video:
            placed = stack_taps([placed] * lead[0])
        x = torch.from_numpy(rng.integers(0, 256, lead + bucket + (3,), dtype=np.uint8)).to(device)
        if normalize:
            fn = lambda: device_preprocess_frames(x, *placed, CLIP_MEAN, CLIP_STD)  # noqa: E731
        else:
            fn = lambda: device_resize_frames(x, *placed)  # noqa: E731
        out = fn()
        ms = time_ms(fn, iters=50, warmup=5)
        traced = device_kernels(fn, iters=5)
        device_ms = sum(t for t, _ in traced.values()) or None
        launches = sum(n for _, n in traced.values())
        bound_ms = (x.numel() + out.numel() * 4) / PEAK_BYTES_PER_S * 1e3
        k = placed[0][0].shape[-1]
        print(f"resample on the device, {label}: uint8 {tuple(x.shape)} -> fp32 "
              f"{tuple(out.shape)}, K={k}; {ms:.3f} ms by events, on the device "
              f"{us_or_not(device_ms)} (profiler) in {launches:g} launches, bound (bytes) "
              f"{bound_ms * 1e3:.2f} us")
        records[label] = dict(ms=ms, device_ms=device_ms, launches=launches, bound_ms=bound_ms)
    return records


def schema_errors(row, schema) -> list:
    """What in one span row breaks ``spans_schema.json`` (required keys,
    JSON types, the stage enum, minLength, minimum): the schema is draft 7
    and the card's machine has no validator package."""
    kinds = {"string": str, "integer": int, "number": (int, float), "null": type(None)}
    errors = [f"missing {k}" for k in schema["required"] if k not in row]
    for key, rule in schema["properties"].items():
        if key not in row:
            continue
        value, want = row[key], rule.get("type")
        types = [want] if isinstance(want, str) else (want or [])
        if types and not any(isinstance(value, kinds[t]) and not (
                t in ("integer", "number") and isinstance(value, bool)) for t in types):
            errors.append(f"{key}={value!r} is not {types}")
        if "enum" in rule and value not in rule["enum"]:
            errors.append(f"{key}={value!r} is not in the enum")
        if isinstance(value, str) and len(value) < rule.get("minLength", 0):
            errors.append(f"{key} is shorter than {rule['minLength']}")
        if isinstance(value, (int, float)) and value < rule.get("minimum", value):
            errors.append(f"{key}={value} is below {rule['minimum']}")
    return errors


def trace_kernel_names(profile_dir: str, name: str) -> list:
    """The full name of each launch of the device kernels whose name holds
    ``name`` in the Chrome traces ``--profile_dir`` wrote
    (``trace-<pid>-<n>.json``); a name carries its template arguments."""
    paths = sorted(glob.glob(os.path.join(profile_dir, "trace-*.json")))
    if not paths:
        raise AssertionError(f"--profile_dir {profile_dir} holds no trace")
    names = []
    for path in paths:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names += [e["name"] for e in events if str(e.get("cat", "")).lower() == "kernel"
                  and name in e.get("name", "")]
    return names


def trace_kernel_launches(profile_dir: str, name: str) -> int:
    """Launches of the device kernels whose name holds ``name`` in the
    Chrome traces ``--profile_dir`` wrote."""
    return len(trace_kernel_names(profile_dir, name))


def telemetry_cost_us(n: int = TELEMETRY_COST_VIDEOS) -> tuple:
    """(on, off) host µs a video of the pipelined loop's telemetry: the span
    shape of a video (prepare with its decode, dispatch with the H2D count,
    fetch, sink, two counters and a gauge) with ``--telemetry on`` (rows
    buffered for the drain thread, written to a spans file) and ``off``
    (the bare per-stage timer), ``n`` videos each, on this host."""
    import timeit

    from video_features_tpu_torch.runtime.telemetry import Telemetry

    payload = np.zeros((16, 240, 320, 3), np.uint8)

    def one_video(t, key):
        with t.span("prepare", video=key, attempt=1, worker="cuda:0"):
            with t.span("decode", video=key):
                t.metrics.inc("frames_decoded", FRAMES)
        with t.span("dispatch", video=key, attempt=1, worker="cuda:0"):
            t.count_h2d(payload)
        with t.span("fetch", video=key, attempt=1, worker="cuda:0"):
            pass
        with t.span("sink", video=key):
            pass
        t.metrics.inc("videos_done")
        t.metrics.set_gauge("queue_depth.pending", 3)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tele_") as tmp:
        off, on = Telemetry(enabled=False), Telemetry(output_root=tmp, enabled=True)
        seq = iter(range(4 * n))
        off_s = timeit.timeit(lambda: one_video(off, f"/videos/{next(seq)}.mp4"), number=n)
        on_s = timeit.timeit(lambda: one_video(on, f"/videos/{next(seq)}.mp4"), number=n)
        on.close()
        if len(on.spans()) != 5 * n:
            raise AssertionError(f"{len(on.spans())} spans written, expected {5 * n}")
    return on_s / n * 1e6, off_s / n * 1e6


def run_telemetry_path(root: str, device):
    """Phase 15: the run telemetry and the preflight probe, at the CLI's
    defaults (--telemetry on, --preflight on). CLIP (full width, uni_12,
    --attn flash, --decode_workers 2, --preprocess device) on cell 9's 8
    clips plus a 4 KiB file of random bytes and an empty file, under
    --profile_dir; I3D + PWC on one 129-frame clip under --profile_dir;
    --telemetry off on 4 of the clips; and the telemetry's bookkeeping
    cost a video against CLIP's ms/video. Returns each kernel's launches
    in its CLI runs."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.runtime import faults
    from video_features_tpu_torch.runtime.telemetry import overlap_report, read_spans
    from video_features_tpu_torch.telemetry import load_schema
    from video_features_tpu_torch.utils.synth import synth_video

    clips = [synth_video(os.path.join(root, f"telemetry{i}.mp4"), seed=20 + i)
             for i in range(CONTRACT_VIDEOS)]
    noise, empty = os.path.join(root, "noise.mp4"), os.path.join(root, "empty.mp4")
    with open(noise, "wb") as f:
        f.write(np.random.default_rng(15).integers(0, 256, 4096, np.uint8).tobytes())
    open(empty, "wb").close()
    clip_args = ["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                 "--attn", "flash", "--decode_workers", "2", "--preprocess", "device",
                 "--allow_random_init", "--on_extraction", "save_numpy",
                 "--tmp_path", os.path.join(root, "tmp")]

    def run(out, videos, *extra):
        reset_counts()
        t0 = time.perf_counter()
        cli.main([*clip_args, "--output_path", os.path.join(root, out), *extra,
                  "--video_paths", *videos])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, flash_attention.launches, read_features(
            os.path.join(root, out))

    # 1. CLIP at the defaults, with two files the probe must reject, and
    # 2. I3D + PWC under --profile_dir, in turn in one fresh process for
    # whole traces (cli_in_fresh_process)
    prof = os.path.join(root, "tele_clip_profile")
    clip129 = synth_video(os.path.join(root, "tele_i3d.mp4"), n_frames=I3D_CLIP_FRAMES, seed=0)
    prof_i3d = os.path.join(root, "tele_i3d_profile")
    (wall, fresh), (i3d_wall, fresh_i3d) = cli_in_fresh_process([
        [*clip_args, "--output_path", os.path.join(root, "tele_clip"), "--profile_dir", prof,
         "--video_paths", *clips, noise, empty],
        ["--feature_type", "i3d", "--flow_type", "pwc", "--allow_random_init",
         "--on_extraction", "save_numpy", "--strict", "--profile_dir", prof_i3d,
         "--output_path", os.path.join(root, "tele_i3d"),
         "--tmp_path", os.path.join(root, "tmp"), "--video_paths", clip129]])
    k1, on = fresh["flash_attention"], read_features(os.path.join(root, "tele_clip"))
    out = os.path.join(root, "tele_clip")
    with open(os.path.join(out, "_manifest", "summary.json")) as f:
        summary = json.load(f)
    records = list(faults.iter_manifest_records(out))
    if summary["done"] != CONTRACT_VIDEOS or len(on) != CONTRACT_VIDEOS:
        raise AssertionError(f"{summary['done']} done, {len(on)} files: {summary['videos']}")
    for bad in (noise, empty):
        rec = summary["videos"][bad]
        retries = [r for r in records if r.get("video") == bad and r.get("status") == "retry"]
        print(f"telemetry and preflight, {os.path.basename(bad)}: {rec['status']}, stage "
              f"{rec.get('stage')}, {rec.get('error_class')}, {rec.get('error_type')}, "
              f"attempts {rec.get('attempts')}: {rec.get('message')}")
        if (rec["status"], rec.get("stage"), rec.get("error_class"), rec.get("attempts"),
                retries) != ("failed", "preflight", "permanent", 1, []):
            raise AssertionError(f"{bad}: {rec}, retries {retries}")
    schema = load_schema()
    rows = [r for p in sorted(glob.glob(os.path.join(out, "_telemetry", "spans-*.jsonl")))
            for r in read_spans(p)]
    bad_rows = [(r.get("span"), e) for r in rows for e in schema_errors(r, schema)]
    if not rows or bad_rows:
        raise AssertionError(f"{len(rows)} span rows; off the schema: {bad_rows[:5]}")
    stages = {}
    for r in rows:
        stages.setdefault(r.get("video"), set()).add(r["stage"])
    missing = {c: sorted(set(TELEMETRY_STAGES) - stages.get(c, set())) for c in clips}
    missing = {c: m for c, m in missing.items() if m}
    if missing:
        raise AssertionError(f"done videos without spans of every stage: {missing}")
    tele = summary.get("telemetry")
    if "telemetry_error" in summary or not tele or not {"throughput", "overlap"} <= set(tele):
        raise AssertionError(f"summary.json telemetry: {summary.get('telemetry_error')!r}, "
                             f"keys {sorted(tele or {})}")
    traced_k1 = trace_kernel_launches(prof, "flash_attention_kernel")
    ov, tput = tele["overlap"], tele["throughput"]
    ms_video = 1e3 / tput["videos_per_s"]
    print(f"telemetry and preflight, CLIP at the defaults + --decode_workers 2 --preprocess "
          f"device --profile_dir (cold CLI run in a fresh process, model build and profiler "
          f"included): "
          f"{CONTRACT_VIDEOS} done + 2 rejected in {wall:.3f} s; summary {tput['videos_per_s']:.3f} "
          f"videos/s ({ms_video:.2f} ms/video), {tput['decode_fps']:.1f} decode fps; "
          f"{len(rows)} spans, stages {dict(sorted(tele['stages'].items()))}; "
          f"counters {tele['counters']}")
    print(f"telemetry and preflight, CLIP overlap report: wall {ov['wall_s']:.4f} s, host busy "
          f"{ov['host_busy_s']:.4f} s, device busy {ov['device_busy_s']:.4f} s, overlapped "
          f"{ov['overlap_s']:.4f} s, efficiency {ov['overlap_efficiency']:.4f} of wall, "
          f"{ov['overlap_of_device']:.4f} of device busy; device_utilization "
          f"{tele['device_utilization']:.4f}")
    print(f"telemetry and preflight, CLIP --profile_dir trace: flash_attention_kernel "
          f"{traced_k1} launches (wrapper count {k1}, expected {CONTRACT_VIDEOS * LAYERS}); "
          f"{', '.join(os.path.basename(p) for p in glob.glob(os.path.join(prof, '*')))}")
    if traced_k1 != CONTRACT_VIDEOS * LAYERS or k1 != CONTRACT_VIDEOS * LAYERS:
        raise AssertionError(f"K1 launches: trace {traced_k1}, wrapper {k1}")

    # 2. the I3D + PWC run's trace
    k2 = fresh_i3d["local_correlation"]
    traced_k2 = trace_kernel_launches(prof_i3d, "local_correlation_kernel")
    want_k2 = I3D_STACKS * len(CORR_LEVELS)
    print(f"telemetry and preflight, I3D + PWC --profile_dir on one {I3D_CLIP_FRAMES}-frame clip "
          f"(CLI run in the fresh process after CLIP's, model build and profiler included): "
          f"{i3d_wall:.3f} s; local_correlation_kernel in "
          f"the trace {traced_k2} "
          f"launches (wrapper count {k2}, expected {want_k2})")
    if traced_k2 != want_k2 or k2 != want_k2:
        raise AssertionError(f"K2 launches: trace {traced_k2}, wrapper {k2}")

    # 3. --telemetry off on 4 of the clips
    off_clips = clips[:TELEMETRY_OFF_VIDEOS]
    _, k1_off, off = run("tele_off", off_clips, "--telemetry", "off", "--strict")
    shared = {k: on[k] for k in off}
    err = max_abs_diff(off, shared) if len(off) == len(off_clips) else float("inf")
    has_dir = os.path.exists(os.path.join(root, "tele_off", "_telemetry"))
    print(f"telemetry and preflight, --telemetry off on {len(off_clips)} clips: _telemetry/ "
          f"{'present' if has_dir else 'absent'}; features vs the telemetry run max_abs_err "
          f"{err:.3e} (tol {CONTRACT_ATOL:g}); flash_attention launches {k1_off}")
    if has_dir or not err <= CONTRACT_ATOL or k1_off != TELEMETRY_OFF_VIDEOS * LAYERS:
        raise AssertionError(f"--telemetry off: _telemetry {has_dir}, err {err}, K1 {k1_off}")

    # 4. the bookkeeping cost, against CLIP's ms/video on the card: the
    # cold run's above, and a warm pass of the same pipelined extractor
    ex = build_extractor(ExtractionConfig(
        feature_type="CLIP-ViT-B/32", video_paths=clips, extract_method=f"uni_{FRAMES}",
        attn="flash", allow_random_init=True, decode_workers=2, preprocess="device"),
        external_call=True)
    ex(device=device)  # model build, cuBLAS and allocator set-up
    t0 = time.perf_counter()
    ex(device=device)  # ends in copies to the host
    warm_ms = (time.perf_counter() - t0) / CONTRACT_VIDEOS * 1e3
    on_us, off_us = telemetry_cost_us()
    cost_us = max(on_us - off_us, 0.0)
    shares = {"cold": cost_us / (ms_video * 1e3), "warm": cost_us / (warm_ms * 1e3)}
    print(f"telemetry and preflight, bookkeeping over {TELEMETRY_COST_VIDEOS} videos on this "
          f"host: on {on_us:.2f} µs/video, off {off_us:.2f} µs/video, cost {cost_us:.2f} "
          f"µs/video = {shares['cold']:.4%} of the cold run's {ms_video:.2f} ms/video and "
          f"{shares['warm']:.4%} of a warm pass's {warm_ms:.2f} ms/video (ceiling "
          f"{TELEMETRY_COST_CEILING:.0%})")
    if not max(shares.values()) < TELEMETRY_COST_CEILING:
        raise AssertionError(f"telemetry bookkeeping {cost_us:.2f} µs/video: {shares}")
    return {"flash_attention": k1 + k1_off, "local_correlation": k2}


def bf16_ceiling(feature_type: str, name: str):
    """(kind, ceiling) of a bf16 feature file against its fp32 run: the
    port's copy of the committed ceilings, "e2e" where the family has one
    (I3D's flow stream "e2e_flow"), else "model"."""
    from video_features_tpu_torch.config import PARITY_CEILINGS, model_family

    family = model_family(feature_type)
    if family == "i3d":
        kind = "e2e_flow" if name.endswith("_flow.npy") else "model"
    else:
        kind = "e2e" if (family, "bfloat16", "e2e") in PARITY_CEILINGS else "model"
    return kind, PARITY_CEILINGS[(family, "bfloat16", kind)]


@contextlib.contextmanager
def kernel_inputs():
    """Yields {"K1": set, "K2": set} of the dtypes K1 and K2 get while it
    is open: CLIP's flash core and PWC's cost volume wrapped by recorders
    that call the real wrappers (whose launch counts stay the only
    counts)."""
    from video_features_tpu_torch.models.clip import extract_clip
    from video_features_tpu_torch.models.pwc import model as pwc_model

    seen = {"K1": set(), "K2": set()}
    flash, corr = extract_clip.CORES["flash"], pwc_model.local_correlation

    def k1(q, k, v, **kw):
        seen["K1"].add(str(q.dtype)[6:])
        return flash(q, k, v, **kw)

    def k2(f1, f2, *a, **kw):
        seen["K2"].add(str(f1.dtype)[6:])
        return corr(f1, f2, *a, **kw)

    with mock.patch.dict(extract_clip.CORES, {"flash": k1}), \
            mock.patch.object(pwc_model, "local_correlation", k2):
        yield seen


def bf16_families(root: str):
    """(label, CLI feature args, clips, expected K1 and K2 launches a run,
    the kernel a bf16 run is profiled for) of each admitted family, on the
    clips of its earlier phase."""
    pwc_windows = -(-(PWC_CLIP_FRAMES - 1) // PWC_BATCH)
    i3d_k2 = I3D_STACKS * len(CORR_LEVELS)
    return [
        ("CLIP", ["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                  "--attn", "flash"],
         [os.path.join(root, f"clip{i}.mp4") for i in range(N_VIDEOS)], N_VIDEOS * LAYERS, 0,
         "flash_attention_kernel"),
        ("ResNet-50", ["--feature_type", "resnet50", "--batch_size", str(RESNET_BATCH)],
         [os.path.join(root, "resnet50.mp4")], 0, 0, None),
        ("R(2+1)D-18", ["--feature_type", "r21d_rgb"], [os.path.join(root, "r21d_rgb.mp4")],
         0, 0, None),
        ("RAFT", ["--feature_type", "raft", "--batch_size", str(RAFT_BATCH)],
         [os.path.join(root, "raft.mp4")], 0, 0, None),
        ("PWC", ["--feature_type", "pwc", "--batch_size", str(PWC_BATCH)],
         [os.path.join(root, "pwc.mp4")], 0, pwc_windows * len(CORR_LEVELS),
         "local_correlation_kernel"),
        ("I3D + PWC", ["--feature_type", "i3d", "--flow_type", "pwc"],
         [os.path.join(root, "i3d0.mp4")], 0, i3d_k2, "local_correlation_kernel"),
        ("I3D + RAFT", ["--feature_type", "i3d", "--flow_type", "raft"],
         [os.path.join(root, "i3d_raft0.mp4")], 0, 0, None),
    ]


def run_bf16_path(root: str, device):
    """Phase 16: --dtype bfloat16. Each admitted family through the CLI at
    --dtype float32 and bfloat16 in this process, on its earlier phase's
    clips: the bf16 features fp32 at the fp32 run's shapes and within the
    family's ceiling of them; K1's and K2's launches at the fp32 counts,
    read from the wrappers and from a --profile_dir trace of the bf16 run,
    K1 fed bf16 and K2 fp32; warm videos/s at both dtypes and one bf16
    forward's top kernels; and K1 in bf16 at the CLIP path's shape against
    its plain version. Returns each kernel's launches in the CLI runs."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import parse_args
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention

    card = card_line()
    launches = {"flash_attention": 0, "local_correlation": 0}
    traced_runs = []  # (label, kernel, --profile_dir, this process's launches, argv)
    for label, args, clips, want_k1, want_k2, traced in bf16_families(root):
        tag = label.replace(" ", "").replace("+", "_").replace("(", "").replace(")", "")
        feats, inputs = {}, {}
        for dtype in ("float32", "bfloat16"):
            out = os.path.join(root, f"bf16_{tag}_{dtype}")
            argv = [*args, "--dtype", dtype, "--allow_random_init", "--on_extraction",
                    "save_numpy", "--strict", "--tmp_path", os.path.join(root, "tmp")]
            reset_counts()
            with kernel_inputs() as seen:
                cli.main([*argv, "--output_path", out, "--video_paths", *clips])
                torch.cuda.synchronize()
            k1, k2 = flash_attention.launches, local_correlation_kernel.launches
            launches["flash_attention"] += k1
            launches["local_correlation"] += k2
            if (k1, k2) != (want_k1, want_k2):
                raise AssertionError(f"bfloat16 {label} --dtype {dtype}: K1 {k1}, K2 {k2} "
                                     f"launches, expected {want_k1}, {want_k2}")
            feats[dtype], inputs[dtype] = read_features(out), (seen["K1"], seen["K2"])
            if dtype == "bfloat16" and traced:
                # the same run again under --profile_dir, after the loop in
                # one fresh process for whole traces (cli_in_fresh_process)
                prof = out + "_profile"
                traced_runs.append((label, traced, prof, k1 + k2, [
                    *argv, "--output_path", out + "_traced", "--profile_dir", prof,
                    "--video_paths", *clips]))
        k1_in, k2_in = inputs["bfloat16"]
        if (want_k1 and k1_in != {"bfloat16"}) or (want_k2 and k2_in != {"float32"}):
            raise AssertionError(f"bfloat16 {label}: K1 got {sorted(k1_in)}, K2 got "
                                 f"{sorted(k2_in)} (want bf16 q/k/v, fp32 cost volumes)")
        f32, b16 = feats["float32"], feats["bfloat16"]
        if sorted(f32) != sorted(b16) or not f32:
            raise AssertionError(f"bfloat16 {label}: files {sorted(b16)} vs {sorted(f32)}")
        drifts = []
        for name in sorted(f32):
            a, b = f32[name], b16[name]
            if b.dtype != np.float32 or b.shape != a.shape or not np.isfinite(b).all():
                raise AssertionError(f"bfloat16 {label} {name}: {b.dtype} {b.shape}, fp32 run "
                                     f"{a.shape}, finite {np.isfinite(b).all()}")
            kind, ceiling = bf16_ceiling(args[1], name)
            drift = rel_l2(b, a)
            drifts.append((name, drift, kind, ceiling))
            if not 0 < drift <= ceiling:
                raise AssertionError(f"bfloat16 {label} {name}: rel_l2 {drift} against fp32, "
                                     f"ceiling {ceiling} ({kind})")
        worst = max(drifts, key=lambda d: d[1] / d[3])
        print(f"bfloat16 {label}: {len(f32)} files fp32 at the fp32 shapes; rel_l2 against "
              f"--dtype float32 max {worst[1]:.3e} ({worst[0]}; ceiling {worst[3]:g}, "
              f"{worst[2]}); " + ", ".join(f"{n} {d:.3e}" for n, d, _, _ in drifts[:4])
              + f"; K1 inputs {sorted(k1_in) or '-'}, K2 inputs {sorted(k2_in) or '-'}")

        warm = {}
        for dtype in ("float32", "bfloat16"):
            ex = build_extractor(parse_args([*args, "--dtype", dtype, "--allow_random_init",
                                             "--video_paths", *clips]), external_call=True)
            prep, fwd = warm_split(ex, clips, device)
            warm[dtype] = (prep, fwd)
        n = len(clips)
        line = ", ".join(f"{d} {n / sum(t):.3f} videos/s ({sum(t) / n * 1e3:.2f} ms/video = "
                         f"host {t[0] / n * 1e3:.2f} + forward {t[1] / n * 1e3:.2f})"
                         for d, t in warm.items())
        print(f"bfloat16 {label} (warm extractor, {n} video(s)): {line}; {card}")
        model, payload = ex.warmup(device), ex.prepare(clips[0])
        t0 = time.perf_counter()
        ex.forward(model, payload)
        one_ms = (time.perf_counter() - t0) * 1e3
        mark = "flash_attention" if want_k1 else ("local_correlation" if want_k2 else "")
        expect = LAYERS if want_k1 else (want_k2 // n if want_k2 else 0)
        print_top_kernels(device_kernels(lambda: ex.forward(model, payload)), one_ms,
                          f"bfloat16 {label}, one --dtype bfloat16 forward on the device "
                          f"({card})", mark=mark, expect=expect)

    fresh_runs = cli_in_fresh_process([argv for *_, argv in traced_runs])
    for (label, traced, prof, here, _), (_, fresh) in zip(traced_runs, fresh_runs):
        for name, n in fresh.items():
            launches[name] += n
        wrapper = fresh["flash_attention"] + fresh["local_correlation"]
        names = trace_kernel_names(prof, traced)
        kinds = sorted({"bfloat16" if "bfloat16" in n else "float32" for n in names})
        print(f"bfloat16 {label}: {traced} in the --dtype bfloat16 --profile_dir trace of a "
              f"fresh process ({len(traced_runs)} traced runs in turn) {len(names)} launches "
              f"(that run's wrapper count {wrapper}), their types {kinds}")
        if not len(names) == wrapper == here:
            raise AssertionError(f"bfloat16 {label}: the trace holds {len(names)} {traced} "
                                 f"launches, the wrapper {wrapper} there and {here} here")

    # K1 in bf16 at the CLIP path's shape (N=16, H=12, L=50, d=64); the
    # kernels line takes phase 3's record of it, as late in a long process
    # a profiler window may lose the launches
    hold_flash_attention(device, *BF16_ATTENTION_CASE, seed=60)
    return launches


def http_json(port: int, path: str, payload=None, method=None):
    """(status, body) of one request to the daemon's HTTP door on
    127.0.0.1; the body parsed as JSON, or as text for /metrics."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as exc:
        body, status = exc.read().decode(), exc.code
    return status, (body if path == "/metrics" else json.loads(body))


def quantile(values, q: float) -> float:
    return float(np.quantile(np.asarray(values, np.float64), q))


def state_bytes(state) -> int:
    """Bytes of a built model state's parameters and buffers (a module, or
    a dict of them): the weights W a model keeps on the card."""
    modules = state.values() if isinstance(state, dict) else [state]
    return sum(t.numel() * t.element_size() for m in modules
               for t in [*m.parameters(), *m.buffers()])


def param_mib(state) -> float:
    """MiB of a built model state's parameters and buffers."""
    return state_bytes(state) / 2**20


def entry_bytes(entry) -> int:
    """One ledger entry's own footprint: arguments + outputs + temp."""
    mem = entry["memory"]
    return mem["argument_bytes"] + mem["output_bytes"] + mem.get("temp_bytes", 0)


def captures(ledger, model: str) -> dict:
    """{entry key: n_compiles} of one model's ledger entries."""
    return {(e["family"], e["bucket"]): e["n_compiles"] for e in ledger.entries()
            if e["model"] == model}


def group_peak(daemon, device, post, payloads, wait_terminal, model: str) -> int:
    """``max_memory_allocated`` over one served group of ``payloads``,
    posted so that they coalesce (the wait raised until the group is
    full). The group must capture nothing: a capture resets the peak."""
    before = captures(daemon.ledger, model)
    wait_s = daemon.batcher.max_batch_wait_s
    daemon.batcher.max_batch_wait_s = 5.0
    try:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        answers, _ = post(payloads)
        recs = wait_terminal([p["id"] for p in payloads])
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    finally:
        daemon.batcher.max_batch_wait_s = wait_s
    if any(code != 202 for code, _ in answers) or any(r["state"] != "done" for r in recs.values()):
        raise AssertionError(f"{model} group for P failed: {answers} {recs}")
    if captures(daemon.ledger, model) != before:
        raise AssertionError(f"{model}'s P group captured a ledger entry: the peak is not its own")
    return peak


def evict_fall(daemon, device, model: str):
    """(E, the allocation after): the fall in ``memory_allocated`` when the
    daemon's pool evicts ``model``."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    daemon.pool.evict(model)
    torch.cuda.synchronize(device)
    after = torch.cuda.memory_allocated(device)
    return before - after, after


def capture_cost_ms(model, device, x) -> tuple:
    """(ms of one forward, ms of the same forward under a ledger capture):
    medians of 5 on the card, the capture's FlopCounterMode and memory
    statistics included, its record left out."""
    from video_features_tpu_torch.telemetry import ledger as ledger_mod

    def once(capture: bool) -> float:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            if capture:
                # no module: the model's own hooks leave this capture alone
                ledger_mod._TLS.capture = ledger_mod._Capture(None, device, 0, (x,), {})
            try:
                out = model(x)
            finally:
                if capture:
                    cap, ledger_mod._TLS.capture = ledger_mod._TLS.capture, None
                    cap.finish(out)
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3

    once(False)
    plain = float(np.median([once(False) for _ in range(5)]))
    captured = float(np.median([once(True) for _ in range(5)]))
    return plain, captured


def hold_serve_ledger(root: str, daemon, device, port, post, wait_terminal,
                      first_group_ms: float):
    """Phase 17's ledger gates (module docstring) on the running daemon.
    Returns (K1, K2) launches of the requests it serves."""
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.telemetry.exposition import validate_exposition
    from video_features_tpu_torch.telemetry.ledger import format_bytes
    from video_features_tpu_torch.utils.synth import synth_video

    clip_ft, mib = "CLIP-ViT-B/32", 2**20
    led = daemon.ledger
    weights = {ft: state_bytes(daemon.pool.get(ft).warmup(device)) for ft in (clip_ft, "i3d")}
    entries = led.entries()
    for e in entries:
        mem = e.get("memory") or {}
        if e.get("platform") != "cuda" or "temp_bytes" not in mem:
            raise AssertionError(f"a capture on the card recorded no memory block: {e}")
    proj = led.hbm_projection()
    if sorted(proj) != sorted([clip_ft, "i3d"]) \
            or not all(p["resident"] > 0 for p in proj.values()):
        raise AssertionError(f"empty HBM projection on the card: {proj}")
    print(f"serve, ledger ({len(entries)} entries, {card_line()}): " + "; ".join(
        f"{e['model']}|{e['family']}|{e['bucket']} args {e['memory']['argument_bytes'] / mib:.1f} "
        f"out {e['memory']['output_bytes'] / mib:.2f} temp {e['memory']['temp_bytes'] / mib:.1f} "
        f"MiB, {e['flops']:.4g} flops, n_compiles {e['n_compiles']}" for e in entries))
    print("serve, projection: " + "; ".join(
        f"{m} resident {p['resident'] / mib:.1f} MiB (arguments {p['arguments'] / mib:.1f}, "
        f"outputs {p['outputs'] / mib:.2f}, temp {p['temp'] / mib:.1f})" for m, p in sorted(
            proj.items())))
    # CLIP's flops per image against ViT-B/32 at 224 px: timm's 4.41 GMACs
    per_image = {e["bucket"]: e["flops"] / int(e["bucket"].split("x")[0])
                 for e in entries if e["model"] == clip_ft}
    print(f"serve, CLIP flops per image by bucket {per_image} against {CLIP_FLOPS_PER_IMAGE:.4g} "
          f"(tol {CLIP_FLOPS_RTOL:.0%})")
    if not per_image or any(abs(f / CLIP_FLOPS_PER_IMAGE - 1) > CLIP_FLOPS_RTOL
                            for f in per_image.values()):
        raise AssertionError(f"CLIP flops per image {per_image}")

    # the live gauges: the sampler on the daemon's device, then /metrics
    if daemon.sampler.sample_once() != 1:
        raise AssertionError("the device-memory sampler set no gauge on the card")
    dev = f"cuda:{device.index if device.index is not None else torch.cuda.current_device()}"
    gauges = daemon.telemetry.metrics.snapshot()["gauges"]
    kinds = {k: v for k, v in gauges.items() if k.startswith(f"device_mem_bytes.{dev}|")}
    code_m, text = http_json(port, "/metrics")
    problems = validate_exposition(text)
    print(f"serve, device memory gauges {dict((k.split('|')[1], int(v)) for k, v in kinds.items())}"
          f", headroom {gauges.get('device_mem_headroom_bytes', 0) / mib:.1f} MiB; /metrics "
          f"{code_m}, {len(problems)} problems")
    if len(kinds) != 4 or "device_mem_headroom_bytes" not in gauges or code_m != 200 \
            or problems or "vft_hbm_bytes{" not in text \
            or f'vft_device_mem_bytes{{device="{dev}"' not in text:
        raise AssertionError(f"ledger series missing: {kinds}, {problems[:5]}")

    # the capture's cost on CLIP's largest group, against its first served group
    clip_model = daemon.pool.get(clip_ft).warmup(device)
    x = torch.randn(4 * 16, 3, 224, 224, device=device)
    plain_ms, captured_ms = capture_cost_ms(clip_model, device, x)
    del clip_model, x
    print(f"serve, a ledger capture of CLIP's 64-image forward: {captured_ms:.3f} ms against "
          f"{plain_ms:.3f} ms plain, +{captured_ms - plain_ms:.3f} ms, "
          f"{(captured_ms - plain_ms) / first_group_ms:.2%} of the first served CLIP group "
          f"({first_group_ms:.1f} ms), {card_line()}")

    # P: each model's largest group again (4 fresh CLIP clips, one fresh
    # I3D stack), with nothing left to capture
    fresh = [synth_video(os.path.join(root, f"serve_p{i}.mp4"), n_frames=60, seed=200 + i)
             for i in range(4)]
    fresh_i3d = synth_video(os.path.join(root, "serve_p_i3d.mp4"), n_frames=STACK + 1, seed=210)
    reset_counts()
    peak = {clip_ft: group_peak(daemon, device, post, [
        {"feature_type": clip_ft, "video_path": c, "id": f"p-clip-{i}", "bucket": "320x240"}
        for i, c in enumerate(fresh)], wait_terminal, clip_ft)}
    peak["i3d"] = group_peak(daemon, device, post, [
        {"feature_type": "i3d", "video_path": fresh_i3d, "id": "p-i3d"}], wait_terminal, "i3d")
    k1, k2 = flash_attention.launches, local_correlation_kernel.launches

    # E and P: CLIP's evict (I3D + PWC resident through both readings),
    # CLIP rebuilt by one request, then I3D + PWC's evict
    fall, base = {}, {}
    first = {(e["family"], e["bucket"]): e for e in entries if e["model"] == clip_ft}
    fall[clip_ft], base[clip_ft] = evict_fall(daemon, device, clip_ft)
    mem = [base[clip_ft] + fall[clip_ft], base[clip_ft]]
    reset_counts()
    code, _ = http_json(port, "/v1/extract", {"feature_type": clip_ft, "id": "rebuilt",
                                              "video_path": os.path.join(root, "clip0.mp4")})
    (rebuilt,) = wait_terminal(["rebuilt"]).values()
    torch.cuda.synchronize(device)
    mem.append(torch.cuda.memory_allocated(device))
    k1_rebuilt = flash_attention.launches
    print(f"serve, evict CLIP and serve one more request: {rebuilt['state']}, builds "
          f"{daemon.pool.build_count}, K1 launches {k1_rebuilt}; "
          f"torch.cuda.memory_allocated before {mem[0] / mib:.1f} MiB, after the evict "
          f"{mem[1] / mib:.1f} MiB, after the rebuild and request {mem[2] / mib:.1f} MiB; "
          f"resident weights and buffers: CLIP {weights[clip_ft] / mib:.1f} MiB, I3D + PWC "
          f"{weights['i3d'] / mib:.1f} MiB")
    if code != 202 or rebuilt["state"] != "done" or daemon.pool.build_count[clip_ft] != 2 \
            or k1_rebuilt != LAYERS:
        raise AssertionError(f"rebuild: {code} {rebuilt} {daemon.pool.build_count}")
    again = {(e["family"], e["bucket"]): e for e in led.entries() if e["model"] == clip_ft}
    redone = [k for k, e in again.items() if k in first and e["n_compiles"] == 2]
    shifts = {k: entry_bytes(again[k]) / entry_bytes(first[k]) - 1 for k in redone}
    print(f"serve, CLIP's rebuild re-recorded {redone}: n_compiles 2, its footprint moved "
          f"{', '.join(f'{v:+.2%}' for v in shifts.values())} (tol {REBUILD_RTOL:.0%})")
    if not redone or any(abs(v) > REBUILD_RTOL for v in shifts.values()):
        raise AssertionError(f"CLIP's rebuild did not re-record its entry: {again}")
    fall["i3d"], base["i3d"] = evict_fall(daemon, device, "i3d")

    rows = []
    for ft in (clip_ft, "i3d"):
        w, e, r = weights[ft], fall[ft], proj[ft]["resident"]
        p = peak[ft] - base[ft]
        rows.append((ft, w, e, r, p))
        print(f"serve, {ft}: W {w / mib:.1f} MiB, E {e / mib:.1f} MiB, resident "
              f"{r / mib:.1f} MiB, P {p / mib:.1f} MiB, resident / P {r / p:.4f} "
              f"(gates W <= E <= resident, resident / P in [{RESIDENT_P_RANGE[0]}, "
              f"{RESIDENT_P_RANGE[1]}]), {card_line()}")
    for ft, w, e, r, p in rows:
        if not w <= e <= r or not RESIDENT_P_RANGE[0] <= r / p <= RESIDENT_P_RANGE[1]:
            raise AssertionError(f"{ft}: W {w}, E {e}, resident {r}, P {p}")
    print(f"serve, warmup line hbm= for CLIP: {format_bytes(proj[clip_ft]['resident'])}")
    return k1 + k1_rebuilt, k2


def hold_hbm_budget(root: str, ledger, out: str) -> None:
    """Phase 17's warmup budget: a daemon on the same output path fails
    its warmup one byte below the two models' projected sum, with the JAX
    package's message, and passes at the sum."""
    from video_features_tpu_torch.config import parse_serve_args
    from video_features_tpu_torch.serve.daemon import ServeDaemon
    from video_features_tpu_torch.telemetry.ledger import format_bytes

    clip_ft = "CLIP-ViT-B/32"
    total = ledger.projected_resident_bytes([clip_ft, "i3d"])
    verdicts = []
    for budget in (total - 1, total):
        daemon = ServeDaemon(parse_serve_args([
            "--feature_types", clip_ft, "i3d", "--flow_type", "pwc", "--attn", "flash",
            "--extract_method", f"uni_{FRAMES}", "--allow_random_init",
            "--warmup", f"{clip_ft}:320x240", "--output_path", out,
            "--tmp_path", os.path.join(root, "tmp"), "--heartbeat_s", "0",
            "--hbm_budget_bytes", str(budget)]))
        try:
            daemon.start()
            verdicts.append("passed")
        except RuntimeError as exc:
            verdicts.append(str(exc))
        finally:
            daemon.shutdown(drain=True)
    want = (f"serve: projected resident HBM {format_bytes(total)} exceeds --hbm_budget_bytes "
            f"{format_bytes(total - 1)} for models {clip_ft}, i3d — shrink the resident set or "
            "raise the budget")
    print(f"serve, --hbm_budget_bytes at the projected sum - 1 ({total - 1}): {verdicts[0]!r}; "
          f"at the sum: {verdicts[1]}")
    if verdicts != [want, "passed"]:
        raise AssertionError(f"warmup budget: {verdicts}")


def span_ms(spans, stage: str, ids) -> list:
    """Durations (ms) of the daemon's ``stage`` spans of the requests ``ids``."""
    return [(s["t1"] - s["t0"]) * 1e3 for s in spans
            if s["stage"] == stage and s.get("request") in ids]


def run_serve_cache(root: str, clips) -> None:
    """Phase 17, step 1: the batch CLI twice over cell 9's clips with
    --cache_dir: the repeat is 8 cache hits, no K1 launch, the same bytes."""
    from video_features_tpu_torch.runtime.faults import iter_manifest_records

    args = ["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
            "--attn", "flash", "--cache_dir", os.path.join(root, "serve_cache_D")]
    runs = []
    for out in ("serve_batch_1", "serve_batch_2"):
        wall, k1, _, feats = ingest_cli(root, out, args, clips)
        blobs = {f: open(f, "rb").read() for f in sorted(glob.glob(
            os.path.join(root, out, "**", "*.npy"), recursive=True))}
        notes = [r.get("note") for r in iter_manifest_records(os.path.join(root, out))
                 if r.get("status") == "done"]
        runs.append((wall, k1, feats, list(blobs.values()), notes))
    (w1, k1a, _, b1, _), (w2, k1b, _, b2, notes) = runs
    print(f"serve, batch cache: first run {w1:.3f} s, {k1a} K1 launches; repeat {w2:.3f} s, "
          f"{k1b} K1 launches, {notes.count('cache_hit')} cache_hit records, files byte-equal "
          f"{b1 == b2}")
    if k1a != CONTRACT_VIDEOS * LAYERS or k1b != 0 or b1 != b2 or len(b1) != CONTRACT_VIDEOS \
            or notes != ["cache_hit"] * CONTRACT_VIDEOS:
        raise AssertionError(f"batch cache repeat: K1 {k1a}/{k1b}, notes {notes}")


def run_serve_fanout(root: str) -> None:
    """Phase 17, step 2: --feature_types CLIP-ViT-B/32 resnet50 on cell
    6's clip decodes it once and writes what the single-model runs write."""
    from video_features_tpu_torch.extract import plan

    clip = os.path.join(root, "resnet50.mp4")
    common = ["--extract_method", f"uni_{FRAMES}", "--attn", "flash",
              "--batch_size", str(RESNET_BATCH)]
    seen = []
    make = plan.cache_for

    def spy(cfg, fts):
        seen.append(make(cfg, fts))
        return seen[-1]

    with mock.patch.object(plan, "cache_for", spy):
        wall, k1, _, both = ingest_cli(root, "serve_fanout", ["--feature_types",
                                       "CLIP-ViT-B/32", "resnet50", *common], [clip])
    stats = seen[0].stats()
    single = {}
    for ft in ("CLIP-ViT-B/32", "resnet50"):
        single.update(ingest_cli(root, f"serve_single_{ft[:4]}", ["--feature_type", ft,
                                 *common], [clip])[3])
    errs = {}
    for name, ref in single.items():
        if name not in both or both[name].shape != ref.shape:
            raise AssertionError(f"fan-out: {name} missing or reshaped: {sorted(both)}")
        errs[name] = (float(np.abs(both[name] - ref).max()) if "CLIP" in name
                      else rel_l2(both[name], ref))
    print(f"serve, batch fan-out --feature_types CLIP-ViT-B/32 resnet50 on one "
          f"{RESNET_CLIP_FRAMES}-frame clip: {wall:.3f} s, frame cache {stats}; against the "
          f"single-model runs: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (CLIP abs tol {FEATURE_ATOL:g}, ResNet rel_l2 tol {CNN_FEATURE_RTOL:g}); "
          f"K1 launches {k1}")
    if stats["populated"] != 1 or stats["clips"] != 1 or len(both) != 2 or k1 != LAYERS:
        raise AssertionError(f"fan-out decoded {stats}, files {sorted(both)}, K1 {k1}")
    if not all(e <= (FEATURE_ATOL if "CLIP" in n else CNN_FEATURE_RTOL) for n, e in errs.items()):
        raise AssertionError(f"fan-out features disagree with the single runs: {errs}")


def run_serve_path(root: str, device):
    """Phase 17: the serve daemon (module docstring). Returns each
    kernel's launches in the served burst."""
    from video_features_tpu_torch.config import parse_serve_args
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.serve.daemon import ServeDaemon
    from video_features_tpu_torch.telemetry.exposition import validate_exposition
    from video_features_tpu_torch.utils.synth import synth_video

    t_phase = time.perf_counter()
    print(f"serve: {card_line()}")
    clips = [os.path.join(root, f"contract{i}.mp4") for i in range(CONTRACT_VIDEOS)]
    run_serve_cache(root, clips)
    run_serve_fanout(root)

    clip_ft = "CLIP-ViT-B/32"
    i3d_clips = [os.path.join(root, f"i3d{i}.mp4") for i in range(I3D_VIDEOS)]
    fan_clip = os.path.join(root, "i3d65.mp4")
    # the batch CLI's CLIP features of the fan-out request's clip
    fan_ref = ingest_cli(root, "serve_batch_fan", ["--feature_type", clip_ft, "--extract_method",
                                                   f"uni_{FRAMES}", "--attn", "flash"],
                         [fan_clip])[3]
    out = os.path.join(root, "serve_out")
    t0 = time.perf_counter()
    daemon = ServeDaemon(parse_serve_args([
        "--feature_types", clip_ft, "i3d", "--flow_type", "pwc", "--attn", "flash",
        "--extract_method", f"uni_{FRAMES}", "--allow_random_init", "--max_group_size", "4",
        "--port", "0", "--cache_dir", os.path.join(root, "serve_cache_D2"),
        "--warmup", f"{clip_ft}:320x240", "--output_path", out,
        "--tmp_path", os.path.join(root, "tmp"), "--heartbeat_s", "0"]))
    if daemon.device != device:
        raise AssertionError(f"the daemon resolved {daemon.device}, not {device}")
    try:
        daemon.start()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        port = daemon.http_port
        print(f"serve: cold start to warm (daemon built, CLIP loaded, warmup clip 320x240 "
              f"served, HTTP open) {warm_s:.3f} s; warmup record "
              f"{daemon.tracker.get('warmup-CLIP-ViT-B-32-320x240')['state']}")

        def post_all(payloads):
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(len(payloads)) as pool:
                t_start = time.monotonic()
                got = list(pool.map(lambda p: http_json(port, "/v1/extract", p), payloads))
            return got, time.monotonic() - t_start

        def wait_terminal(ids, timeout=300.0):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                recs = {i: daemon.tracker.get(i) or {} for i in ids}
                if all(r.get("state") in ("done", "failed", "rejected", "expired", "cancelled")
                       for r in recs.values()):
                    return recs
                time.sleep(0.01)
            raise AssertionError(f"requests not terminal after {timeout} s: {recs}")

        clip_ex = daemon.pool.get(clip_ft)
        t_burst = time.monotonic()
        reset_counts()
        burst = [{"feature_type": clip_ft, "video_path": c, "id": f"clip-{i}", "bucket": "320x240"}
                 for i, c in enumerate(clips)]
        others = [{"feature_type": "i3d", "video_path": c, "id": f"i3d-{i}"}
                  for i, c in enumerate(i3d_clips)]
        others.append({"feature_types": [clip_ft, "i3d"], "video_path": fan_clip, "id": "fan"})
        answers, post_s = post_all(burst)
        answers += post_all(others)[0]
        if any(code != 202 for code, _ in answers):
            raise AssertionError(f"a POST was refused: {answers}")
        fan_ids = [f"fan.{clip_ft.replace('/', '-')}", "fan.i3d"]
        ids = [p["id"] for p in burst + others[:-1]] + fan_ids
        recs = wait_terminal(ids)
        torch.cuda.synchronize()
        k1, k2 = flash_attention.launches, local_correlation_kernel.launches
        bad = {i: r for i, r in recs.items() if r.get("state") != "done"}
        if bad:
            raise AssertionError(f"served requests failed: {bad}")

        # what the CLIP extractor dispatched in the burst: each 'request'
        # span is a group, each dispatch (pipelined) or extract (serial)
        # span one forward
        spans = [s for s in clip_ex.telemetry.spans() if s["t0"] >= t_burst]
        groups = sorted((len(s["requests"]) for s in spans if s["stage"] == "request"),
                        reverse=True)
        forwards = sum(1 for s in spans if s["stage"] in ("dispatch", "extract"))
        burst_groups = [s for s in spans if s["stage"] == "request"
                        and set(s["requests"]) <= {p["id"] for p in burst}]
        wait_s = daemon.scfg.max_batch_wait_ms / 1e3
        print(f"serve, burst of {len(burst)} CLIP requests (posted in {post_s * 1e3:.1f} ms, "
              f"--max_batch_wait_ms {daemon.scfg.max_batch_wait_ms:g}): CLIP groups "
              f"{[len(s['requests']) for s in burst_groups]} (all CLIP groups with the fan-out's "
              f"{groups}), {forwards} CLIP forwards, K1 launches {k1}; K2 launches {k2}")
        if k1 != LAYERS * forwards:
            raise AssertionError(f"K1 launched {k1} times over {forwards} CLIP forwards")
        if post_s <= wait_s and len(burst_groups) != -(-len(burst) // 4):
            raise AssertionError(f"a burst inside the wait ran in {len(burst_groups)} groups")

        batch_dir = os.path.join(root, "serve_batch_1", "CLIP-ViT-B", "32")
        clip_errs = []
        for p in burst:
            (path,) = recs[p["id"]]["features"]
            ref = np.load(os.path.join(batch_dir, os.path.basename(path)))
            clip_errs.append(float(np.abs(np.load(path) - ref).max()))
        print(f"serve, CLIP features against the batch CLI's (cell 9): max_abs_err "
              f"{max(clip_errs):.3e} (tol {INGEST_ATOL:g})")
        if not max(clip_errs) <= INGEST_ATOL:
            raise AssertionError(f"served CLIP disagrees with batch: {clip_errs}")

        # I3D + PWC against phase 5's files; the flow tolerance from the
        # share of uint8 flow levels two runs of one stack flip on the card
        def run_to_run_tol():
            ex = daemon.pool.get("i3d")
            models = ex.warmup(device)
            stack = torch.from_numpy(np.stack(ex.prepare(i3d_clips[0])[0][: STACK + 1]))
            a, b = (stack_streams(ex, models, stack.to(device)) for _ in range(2))
            return flow_feature_rtol(float(np.mean(a[1] != b[1])), a[1])

        flow_tol = run_to_run_tol()
        stacks = 0
        for p in others[:-1] + [{"id": "fan.i3d"}]:
            for path in recs[p["id"]]["features"]:
                stacks += np.load(path).shape[0] if path.endswith("_rgb.npy") else 0
        i3d_errs = []
        for p in others[:-1]:
            for path in recs[p["id"]]["features"]:
                ref = np.load(os.path.join(root, "i3d_out", "i3d", os.path.basename(path)))
                tol = flow_tol if path.endswith("_flow.npy") else I3D_FEATURE_RTOL
                i3d_errs.append((os.path.basename(path), rel_l2(np.load(path), ref), tol))
        print("serve, I3D + PWC features against phase 5's: " + ", ".join(
            f"{n} rel_l2 {e:.3e} (tol {t:.3e})" for n, e, t in i3d_errs)
            + f"; {stacks} stacks served, K2 launches {k2} (5 x {stacks})")
        if any(not e <= t for _, e, t in i3d_errs) or len(i3d_errs) != 2 * I3D_VIDEOS:
            raise AssertionError(f"served I3D disagrees with batch: {i3d_errs}")
        if k2 != len(CORR_LEVELS) * stacks:
            raise AssertionError(f"K2 launched {k2} times over {stacks} I3D + PWC forwards")
        # the fan-out: its CLIP file against the batch CLI's on that clip,
        # its I3D files against phase 5's card features of the clip
        fan_errs = []
        fan_files = {os.path.basename(f): f for i in fan_ids for f in recs[i]["features"]}
        want = sorted([*fan_ref, "i3d65_flow.npy", "i3d65_rgb.npy"])
        if sorted(fan_files) != want:
            raise AssertionError(f"fan-out files {sorted(fan_files)}, not {want}")
        for name, path in sorted(fan_files.items()):
            got = np.load(path)
            if name in fan_ref:
                err = float(np.abs(got - fan_ref[name]).max()) if got.shape == \
                    fan_ref[name].shape else float("inf")
                fan_errs.append((name, "max_abs_err", err, INGEST_ATOL))
            else:
                stream = name[len("i3d65_"):-len(".npy")]
                ref = np.load(os.path.join(root, f"i3d65_card_{stream}.npy"))
                err = rel_l2(got, ref) if got.shape == ref.shape else float("inf")
                fan_errs.append((name, "rel_l2", err,
                                 flow_tol if stream == "flow" else I3D_FEATURE_RTOL))
        fan = daemon.stats()["cache"].get("frame_cache", {})
        print(f"serve, fan-out request on {os.path.basename(fan_clip)}: "
              f"{[recs[i]['state'] for i in fan_ids]}; " + ", ".join(
                  f"{n} {m} {e:.3e} (tol {t:.3e})" for n, m, e, t in fan_errs)
              + f" (CLIP against the batch CLI, I3D against phase 5); frame cache {fan}")
        if any(not e <= t for _, _, e, t in fan_errs):
            raise AssertionError(f"the served fan-out disagrees: {fan_errs}")

        # the repeat: every request a cache hit at admission, no launch
        before = {p["id"]: open(recs[p["id"]]["features"][0], "rb").read() for p in burst}
        reset_counts()
        again = [dict(p, id=p["id"] + "-again") for p in burst]
        hits, hit_post_s = post_all(again)
        k1_hit = flash_attention.launches
        same = all(open(r["features"][0], "rb").read() == before[p["id"]]
                   for p, (_, r) in zip(burst, hits))
        print(f"serve, the burst again: states {sorted({r['state'] for _, r in hits})} at the "
              f"POST ({hit_post_s * 1e3:.1f} ms for all {len(again)}), K1 launches {k1_hit}, "
              f"files byte-equal {same}; cache {daemon.stats()['cache']}")
        if any(r["state"] != "done" for _, r in hits) or k1_hit or not same:
            raise AssertionError(f"repeat not served from the cache: {hits}, K1 {k1_hit}")

        miss = [recs[p["id"]]["wall_s"] for p in burst]
        hit = [daemon.tracker.get(p["id"])["wall_s"] for p in again]
        print(f"serve, request latency (received to terminal), {card_line()}: burst miss p50 "
              f"{quantile(miss, 0.5) * 1e3:.1f} ms, p95 {quantile(miss, 0.95) * 1e3:.1f} ms; "
              f"hit p50 {quantile(hit, 0.5) * 1e3:.2f} ms, p95 "
              f"{quantile(hit, 0.95) * 1e3:.2f} ms")
        # where a request's time goes, from the daemon's and the CLIP
        # extractor's spans: admission (preflight probe, hash, cache
        # lookup, and for a hit the copy), the queue wait, the group
        dspans = daemon.telemetry.spans()
        burst_ids = {p["id"] for p in burst}
        parts = {"miss admission": span_ms(dspans, "admission", burst_ids),
                 "miss queue_wait": span_ms(dspans, "queue_wait", burst_ids),
                 "hit admission": span_ms(dspans, "admission", {p["id"] for p in again}),
                 "CLIP group service": [(s["t1"] - s["t0"]) * 1e3 for s in burst_groups]}
        print("serve, spans (ms, p50/max): " + ", ".join(
            f"{k} {quantile(v, 0.5):.2f}/{max(v):.2f} (n={len(v)})" for k, v in parts.items()
            if v))

        code, health = http_json(port, "/healthz")
        code_m, text = http_json(port, "/metrics")
        problems = validate_exposition(text)
        code_r, rec = http_json(port, "/v1/requests/clip-0")
        print(f"serve, endpoints: /healthz {code} {health['status']} warm {health['warm']}; "
              f"/metrics {code_m}, {len(text.splitlines())} lines, {len(problems)} problems; "
              f"/v1/requests/clip-0 {code_r} {rec.get('state')}")
        if code != 200 or health["status"] != "ok" or code_m != 200 or problems \
                or "vft_stage_seconds" not in text or "vft_slo_latency_seconds" not in text \
                or code_r != 200 or rec.get("state") != "done":
            raise AssertionError(f"endpoints: {code} {health}, {problems[:5]}, {code_r} {rec}")

        # the device cost ledger against the card: each model's weights W,
        # its projected resident set, the peak of its largest group P and
        # the fall E at its evict, then CLIP rebuilt
        del clip_ex
        first = min(burst_groups, key=lambda s: s["t0"])
        k1_more, k2_more = hold_serve_ledger(root, daemon, device, port, post_all,
                                             wait_terminal, (first["t1"] - first["t0"]) * 1e3)
    finally:
        daemon.shutdown(drain=True)
    counts = daemon.tracker.counts()
    print(f"serve, shutdown with drain: {counts}")
    if counts["queued"] or counts["dispatched"]:
        raise AssertionError(f"requests left non-terminal at shutdown: {counts}")
    hold_hbm_budget(root, daemon.ledger, out)
    print(f"serve: phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention": k1 + k1_more, "local_correlation": k2 + k2_more}


def run_flags_path(root: str, device):
    """Phase 18: flow read from disk and the output flags on cell 2's
    65-frame clip (64-frame stacks), phase 6's PWC clip and phase 10's
    R(2+1)D clip. Returns each kernel's launches in the phase."""
    import cv2

    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract import ingest
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.models.i3d.extract_i3d import rgb_chain
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.preprocess import flow_quantize_uint8_np, scale_to_1_1
    from video_features_tpu_torch.utils import flow_viz

    t_phase = time.perf_counter()
    print(f"flags: TF32 cudnn {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}; {card_line()}")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the fp32 comparisons need it off")
    clip, stem = os.path.join(root, "i3d65.mp4"), "i3d65"
    pwc_clip, r21d_clip = os.path.join(root, "pwc.mp4"), os.path.join(root, "r21d_rgb.mp4")
    k2 = 0

    # PWC --on_extraction save_jpg, and the same run saving the .npy flow
    pwc_args = ["--feature_type", "pwc", "--side_size", "256", "--batch_size", str(PWC_BATCH)]
    windows = -(-STACK // PWC_BATCH)
    wall, _, k2_jpg, _ = ingest_cli(root, "flags_jpg", pwc_args, [clip],
                                    "--on_extraction", "save_jpg")
    jpg_dir = os.path.join(root, "flags_jpg", "pwc", stem)
    xs = sorted(glob.glob(os.path.join(jpg_dir, "flow_x_*.jpg")))
    ys = sorted(glob.glob(os.path.join(jpg_dir, "flow_y_*.jpg")))
    _, _, k2_npy, npy = ingest_cli(root, "flags_npy", pwc_args, [clip])
    (flow,) = npy.values()
    if len(xs) != STACK or len(ys) != STACK or flow.shape != (STACK, 2, 256, 341):
        raise AssertionError(f"save_jpg: {len(xs)} x / {len(ys)} y files, .npy {flow.shape}")
    read = np.stack([np.stack([cv2.imread(x, cv2.IMREAD_GRAYSCALE),
                               cv2.imread(y, cv2.IMREAD_GRAYSCALE)]) for x, y in zip(xs, ys)])
    levels = np.abs(read.astype(np.int16) - flow_quantize_uint8_np(flow).astype(np.int16))
    print(f"flags, PWC --on_extraction save_jpg on {stem}: {len(xs)} flow_x/flow_y pairs in "
          f"{wall:.3f} s; read back against flow_quantize_uint8_np of the .npy run: mean "
          f"{levels.mean():.4f} levels, max {levels.max()} (mean tol {JPEG_MEAN_LEVELS:g}); "
          f"K2 launches {k2_jpg} and {k2_npy} ({len(CORR_LEVELS)} x {windows} forwards each)")
    if not levels.mean() <= JPEG_MEAN_LEVELS:
        raise AssertionError(f"save_jpg files off the quantized flow: {levels.mean()} levels")
    if k2_jpg != len(CORR_LEVELS) * windows or k2_npy != k2_jpg:
        raise AssertionError(f"K2 launched {k2_jpg} / {k2_npy} times over {windows} forwards")
    k2 += k2_jpg + k2_npy

    # I3D --flow_type flow on those JPEGs: no flow net, so no K2 launch
    wall, k1_disk, k2_disk, disk = ingest_cli(
        root, "flags_disk", ["--feature_type", "i3d", "--flow_type", "flow", "--flow_paths",
                             jpg_dir], [clip])
    want = sorted(f"{stem}_{s}.npy" for s in ("rgb", "flow"))
    if sorted(disk) != want or any(f.shape != (1, 1024) or not np.isfinite(f).all()
                                   for f in disk.values()):
        raise AssertionError(f"disk flow files {[(k, v.shape) for k, v in disk.items()]}")
    if k1_disk or k2_disk:
        raise AssertionError(f"I3D on disk flow launched K1 {k1_disk}, K2 {k2_disk} times")
    disk_ex = build_extractor(ExtractionConfig(
        feature_type="i3d", flow_type="flow", video_paths=[clip], flow_paths=[jpg_dir],
        allow_random_init=True), external_call=True)
    (card,) = disk_ex(device=device)
    (cpu,) = disk_ex(device=torch.device("cpu"))
    errs = {s: rel_l2(card[s], cpu[s]) for s in ("rgb", "flow")}
    fly = np.load(os.path.join(root, f"{stem}_card_flow.npy"))
    trip = rel_l2(disk[f"{stem}_flow.npy"], fly)
    print(f"flags, I3D --flow_type flow on those JPEGs (cold CLI run {wall:.3f} s): rgb/flow "
          f"(1, 1024), K1 {k1_disk} and K2 {k2_disk} launches; card vs the port on the CPU rel_l2 "
          f"rgb {errs['rgb']:.3e}, flow {errs['flow']:.3e} (tol {I3D_FEATURE_RTOL:g}); flow "
          f"stream against phase 5's on-the-fly I3D + PWC flow features rel_l2 {trip:.3e} "
          f"(tol {ROUND_TRIP_RTOL:g})")
    if not all(e <= I3D_FEATURE_RTOL for e in errs.values()):
        raise AssertionError(f"disk flow features card vs CPU: {errs}")
    if not trip <= ROUND_TRIP_RTOL:
        raise AssertionError(f"the save_jpg round trip is off the on-the-fly flow: {trip}")

    # I3D + PWC --show_pred: the top-5 per stream, and the features unchanged
    ex = build_extractor(ExtractionConfig(feature_type="i3d", flow_type="pwc",
                                          video_paths=[clip], allow_random_init=True,
                                          conv3d_impl="direct"), external_call=True)
    models = ex.warmup(device)
    frames, fps, stamps, _, path = ex.prepare(clip)
    stack = torch.from_numpy(np.stack(frames[: STACK + 1])).to(device)
    a, b = (stack_streams(ex, models, stack) for _ in range(2))
    flow_tol = flow_feature_rtol(float(np.mean(a[1] != b[1])), a[1])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        _, _, k2_pred, pred = ingest_cli(root, "flags_pred", ["--feature_type", "i3d",
                                         "--flow_type", "pwc", "--show_pred"], [clip])
    lines = text.getvalue().splitlines()
    heads = [i for i, ln in enumerate(lines) if " @ stack " in ln]
    top = [lines[i: i + 6] for i in heads]
    for block in top:
        print("flags, --show_pred: " + " | ".join(block))
    ok = [lines[i] for i in heads] == [f"{clip} @ stack 0 ({s} stream)" for s in ("rgb", "flow")]
    ok = ok and all(len(bl) == 6 and all(len(ln.split(" ", 2)) == 3 for ln in bl[1:])
                    for bl in top)
    pred_errs = {s: rel_l2(pred[f"{stem}_{s}.npy"], np.load(os.path.join(
        root, f"{stem}_card_{s}.npy"))) for s in ("rgb", "flow")}
    print(f"flags, I3D + PWC --show_pred: features against phase 5's without the flag rel_l2 "
          f"rgb {pred_errs['rgb']:.3e} (tol {I3D_FEATURE_RTOL:g}), flow {pred_errs['flow']:.3e} "
          f"(tol {flow_tol:.3e}); K2 launches {k2_pred}")
    if not ok:
        raise AssertionError(f"--show_pred printed {lines}")
    if not (pred_errs["rgb"] <= I3D_FEATURE_RTOL and pred_errs["flow"] <= flow_tol):
        raise AssertionError(f"--show_pred changed the features: {pred_errs}")
    if k2_pred != len(CORR_LEVELS):
        raise AssertionError(f"K2 launched {k2_pred} times over one I3D + PWC forward")
    k2 += k2_pred

    # PWC --show_pred in this process: the display replaced by a recorder
    seen = []

    def record(flow, frame):
        img = np.concatenate([frame.astype(np.uint8), flow_viz.flow_to_image(flow)], axis=0)
        seen.append((img.shape, bool(np.isfinite(flow).all() and np.isfinite(frame).all())))

    pwc_ex = build_extractor(ExtractionConfig(feature_type="pwc", video_paths=[pwc_clip],
                                              batch_size=PWC_BATCH, show_pred=True,
                                              allow_random_init=True), external_call=True)
    reset_counts()
    with mock.patch.object(flow_viz, "show_flow_on_frame", record):
        (shown,) = pwc_ex(device=device)
    k2_show = local_correlation_kernel.launches
    pairs = PWC_CLIP_FRAMES - 1
    print(f"flags, PWC --show_pred: {len(seen)} show_flow_on_frame calls for {pairs} pairs, "
          f"images {sorted({sh for sh, _ in seen})}, all finite {all(f for _, f in seen)}; "
          f"K2 launches {k2_show}")
    if (len(seen) != pairs or shown["pwc"].shape[0] != pairs or not all(f for _, f in seen)
            or {sh for sh, _ in seen} != {(480, 320, 3)}):
        raise AssertionError(f"PWC --show_pred drew {seen}")
    if k2_show != len(CORR_LEVELS) * -(-pairs // PWC_BATCH):
        raise AssertionError(f"K2 launched {k2_show} times for PWC --show_pred")
    k2 += k2_show

    # --conv3d_impl decomposed against direct: I3D's two streams on one
    # stack's inputs (PWC's levels of the stack above), R(2+1)D-18 on 4 stacks
    dec = build_extractor(ExtractionConfig(feature_type="i3d", flow_type="pwc",
                                           video_paths=[clip], allow_random_init=True,
                                           conv3d_impl="decomposed"), external_call=True)
    x_rgb = rgb_chain(stack[None, :-1])
    x_flow = scale_to_1_1(torch.from_numpy(a[1]).to(device))
    conv = {}
    for impl, e in (("direct", ex), ("decomposed", dec)):
        m = e.warmup(device)

        def i3d_pair(m=m):
            with torch.inference_mode():
                return m["rgb"](x_rgb)[0], m["flow"](x_flow)[0]

        feats = [f.cpu().numpy() for f in i3d_pair()]
        one = (frames[: STACK + 1], fps, stamps[: STACK + 1], None, path)
        conv[impl] = (feats, time_ms(i3d_pair, iters=5, warmup=2),
                      time_ms(lambda e=e, m=m: e.forward(m, one), iters=3, warmup=1))
    i3d_errs = [rel_l2(d, r) for d, r in zip(conv["decomposed"][0], conv["direct"][0])]
    r21d = {}
    for impl in ("direct", "decomposed"):
        e = build_extractor(ExtractionConfig(feature_type="r21d_rgb", video_paths=[r21d_clip],
                                             allow_random_init=True, conv3d_impl=impl),
                            external_call=True)
        m, payload = e.warmup(device), e.prepare(r21d_clip)
        r21d[impl] = (e.forward(m, payload)["r21d_rgb"],
                      time_ms(lambda e=e, m=m, p=payload: e.forward(m, p), iters=5, warmup=2))
    r21d_err = rel_l2(r21d["decomposed"][0], r21d["direct"][0])
    print(f"flags, --conv3d_impl decomposed vs direct (TF32 off; {card_line()}): I3D rgb/flow "
          f"features rel_l2 {i3d_errs[0]:.3e} / {i3d_errs[1]:.3e}, R(2+1)D-18 {r21d_err:.3e} "
          f"(tol {CONV3D_RTOL:g}); forward ms direct -> decomposed: I3D two streams on one "
          f"{STACK}-frame stack {conv['direct'][1]:.2f} -> {conv['decomposed'][1]:.2f}, the whole "
          f"I3D + PWC stack {conv['direct'][2]:.2f} -> {conv['decomposed'][2]:.2f}, R(2+1)D-18 "
          f"on {R21D_CLIP_FRAMES // 16} stacks {r21d['direct'][1]:.2f} -> "
          f"{r21d['decomposed'][1]:.2f}")
    if not all(err <= CONV3D_RTOL for err in [*i3d_errs, r21d_err]):
        raise AssertionError(f"decomposed and direct disagree: I3D {i3d_errs}, R21D {r21d_err}")

    # R(2+1)D --uint8_transfer off against on, with the pinned bytes of each
    pinned = {}
    real = ingest.pinned_copy
    for transfer in ("on", "off"):
        e = build_extractor(ExtractionConfig(feature_type="r21d_rgb", video_paths=[r21d_clip],
                                             allow_random_init=True, uint8_transfer=transfer),
                            external_call=True)
        m, payload = e.warmup(device), e.prepare(r21d_clip)
        sizes = []

        def counting(x, sizes=sizes):
            host = real(x)
            sizes.append(host.numel() * host.element_size())
            return host

        with mock.patch.object(ingest, "pinned_copy", counting):
            feats = e.forward(m, payload)["r21d_rgb"]
        pinned[transfer] = (feats, sum(sizes))
    diff = float(np.abs(pinned["off"][0] - pinned["on"][0]).max())
    print(f"flags, R(2+1)D-18 --uint8_transfer off vs on: features max_abs_err {diff:.3e} (tol "
          f"{CONTRACT_ATOL:g}); pinned bytes {pinned['on'][1]} (on) and {pinned['off'][1]} (off)")
    if (not diff <= CONTRACT_ATOL or pinned["off"][1] != 4 * pinned["on"][1]
            or (device.type == "cuda" and not pinned["on"][1])):
        raise AssertionError(f"--uint8_transfer off: {diff}, pinned {pinned['on'][1]} / "
                             f"{pinned['off'][1]}")

    # --fps_retarget reencode needs an ffmpeg binary
    import shutil

    binary = shutil.which("ffmpeg")
    print(f"flags, --fps_retarget reencode: shutil.which('ffmpeg') = {binary!r}")
    if binary is None:
        print("flags, --fps_retarget reencode: not run, this host has no ffmpeg binary "
              "(unverified on the card)")
    else:
        retarget = ["--feature_type", "pwc", "--batch_size", str(PWC_BATCH), "--extraction_fps",
                    f"{FPS_RETARGET_FPS:g}"]
        _, _, k2_re, re_out = ingest_cli(root, "flags_reencode", retarget, [pwc_clip],
                                         "--fps_retarget", "reencode")
        (re_flow,) = re_out.values()
        want_frames = round(PWC_CLIP_FRAMES / 25.0 * FPS_RETARGET_FPS)
        print(f"flags, --fps_retarget reencode --extraction_fps {FPS_RETARGET_FPS:g}: flow "
              f"{re_flow.shape}, {re_flow.shape[0] + 1} frames (expected {want_frames} +- 1); "
              f"K2 launches {k2_re}")
        if abs(re_flow.shape[0] + 1 - want_frames) > 1 or not np.isfinite(re_flow).all():
            raise AssertionError(f"re-encoded flow {re_flow.shape}")
        k2 += k2_re
    print(f"flags: phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention": 0, "local_correlation": k2}


def run_preempt_path(root: str, device):
    """Phase 19: HBM-aware preemption against a real memory wall (module
    docstring). Returns each kernel's launches in the phase."""
    from video_features_tpu_torch.config import parse_serve_args
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.runtime.faults import iter_manifest_records
    from video_features_tpu_torch.serve.daemon import ServeDaemon
    from video_features_tpu_torch.serve.lifecycle import requests_root

    t_phase = time.perf_counter()
    print(f"preempt: {card_line()}")
    clip_ft, mib = "CLIP-ViT-B/32", 2**20
    out = os.path.join(root, "serve_out")  # phase 17's: its ledger prices I3D + PWC
    daemon = ServeDaemon(parse_serve_args([
        "--feature_types", clip_ft, "i3d", "--flow_type", "pwc", "--attn", "flash",
        "--extract_method", f"uni_{FRAMES}", "--allow_random_init", "--max_group_size", "4",
        "--port", "0", "--warmup", f"{clip_ft}:320x240", "--output_path", out,
        "--tmp_path", os.path.join(root, "tmp"), "--heartbeat_s", "0", "--preempt", "on",
        "--preempt_cooldown_s", "0", "--preempt_min_residency_s", "0",
        "--breaker_cooldown_s", str(PREEMPT_BREAKER_COOLDOWN_S)]))
    events_seen = len(_preempt_events(out))
    ballast = None
    k1 = k2 = 0

    def wait_terminal(ids, timeout=300.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            recs = {i: daemon.tracker.get(i) or {} for i in ids}
            if all(r.get("state") in ("done", "failed", "rejected", "expired", "cancelled")
                   for r in recs.values()):
                return recs
            time.sleep(0.01)
        raise AssertionError(f"requests not terminal after {timeout} s: {recs}")

    def headroom() -> int:
        daemon.sampler.sample_once()
        return int(daemon.telemetry.metrics.snapshot()["gauges"]["device_mem_headroom_bytes"])

    def wall_up(target: int):
        """A ballast tensor that leaves the sampler's headroom at ``target``."""
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        t = torch.empty(headroom() - target, dtype=torch.uint8, device=device)
        got = headroom()
        print(f"preempt, ballast {t.numel() / 2**30:.3f} GiB: headroom {got / mib:.1f} MiB "
              f"(target {target / mib:.1f} MiB)")
        if abs(got - target) > BALLAST_SLACK:
            raise AssertionError(f"ballast left headroom {got}, not {target}")
        return t

    try:
        daemon.start()
        port = daemon.http_port
        proj = daemon.ledger.hbm_projection()
        r_clip, r_i3d = proj[clip_ft]["resident"], proj["i3d"]["resident"]
        temps = {e["family"]: e["memory"]["temp_bytes"] for e in daemon.ledger.entries()
                 if e["model"] == "i3d"}
        target = r_i3d - min(r_clip, r_i3d) // 2
        print(f"preempt, projected resident: CLIP {r_clip / mib:.1f} MiB, I3D + PWC "
              f"{r_i3d / mib:.1f} MiB; the wall leaves I3D + PWC's minus half the smaller")

        # step 2-3: the wall, then an I3D + PWC request evicts CLIP
        ballast = wall_up(target)
        verdict = daemon.preemptor.check("i3d")
        print(f"preempt, admission check for I3D + PWC: {verdict}")
        if verdict[0] != "overcommit":
            raise AssertionError(f"I3D + PWC not overcommitted behind the wall: {verdict}")
        reset_counts()
        clip_path = os.path.join(root, "i3d0.mp4")
        t_post = time.time()
        code, _ = http_json(port, "/v1/extract", {"feature_type": "i3d", "video_path": clip_path,
                                                  "id": "p19-i3d"})
        clip_breaker = daemon._breaker(clip_ft).state()
        resident_after = sorted(daemon.pool.feature_types())
        (rec,) = wait_terminal(["p19-i3d"]).values()
        torch.cuda.synchronize(device)
        k2_i3d = local_correlation_kernel.launches
        retries = [r for r in iter_manifest_records(out) if r.get("status") == "retry"
                   and r.get("ts", 0) >= t_post]
        print(f"preempt, I3D + PWC request behind the wall: {code}, {rec['state']}"
              + (f" ({rec.get('message')})" if rec["state"] != "done" else "")
              + f"; CLIP's breaker {clip_breaker} at admission, residents then {resident_after},"
              f" retries {len(retries)}, K2 launches {k2_i3d}, headroom after "
              f"{headroom() / mib:.1f} MiB")
        if code != 202 or rec["state"] != "done" or retries:
            raise AssertionError(f"I3D + PWC behind the wall: {code} {rec} {retries}")
        if clip_breaker != "open" or clip_ft in resident_after:
            raise AssertionError(f"CLIP not preempted: {clip_breaker}, {resident_after}")
        walled = {e["family"]: e["memory"]["temp_bytes"] for e in daemon.ledger.entries()
                  if e["model"] == "i3d"}
        print("preempt, I3D + PWC's temp by family, captured again behind the wall against "
              "phase 17's: " + ", ".join(f"{f} {walled[f] / mib:.1f} MiB ({temps[f] / mib:.1f})"
                                         for f in sorted(walled)))
        stacks = sum(np.load(p).shape[0] for p in rec["features"] if p.endswith("_rgb.npy"))
        if k2_i3d != len(CORR_LEVELS) * stacks:
            raise AssertionError(f"K2 launched {k2_i3d} times over {stacks} forwards")
        code_m, text = http_json(port, "/metrics")
        line = f'vft_preemptions_total{{feature_type="{clip_ft}"}} 1'
        events = _preempt_events(out)[events_seen:]
        print(f"preempt, events {events}; /metrics {line!r} {line in text}")
        if events[:1] != [("preempted", clip_ft, "i3d")] or line not in text:
            raise AssertionError(f"preemption trail: {events}, {line in text}")

        # step 4: the wall down, CLIP back through the half-open probe
        del ballast
        ballast = None
        gc.collect()
        headroom()
        ex = daemon.pool.get("i3d")
        models = ex.warmup(device)
        stack = torch.from_numpy(np.stack(ex.prepare(clip_path)[0][: STACK + 1])).to(device)
        a, b = (stack_streams(ex, models, stack) for _ in range(2))
        flow_tol = flow_feature_rtol(float(np.mean(a[1] != b[1])), a[1])
        del ex, models, stack
        errs = []
        for path in rec["features"]:
            ref = np.load(os.path.join(root, "i3d_out", "i3d", os.path.basename(path)))
            tol = flow_tol if path.endswith("_flow.npy") else I3D_FEATURE_RTOL
            errs.append((os.path.basename(path), rel_l2(np.load(path), ref), tol))
        print("preempt, I3D + PWC features against phase 5's: " + ", ".join(
            f"{n} rel_l2 {e:.3e} (tol {t:.3e})" for n, e, t in errs))
        if len(errs) != 2 or any(not e <= t for _, e, t in errs):
            raise AssertionError(f"I3D + PWC behind the wall disagrees: {errs}")
        time.sleep(PREEMPT_BREAKER_COOLDOWN_S)
        reset_counts()
        t_probe = time.monotonic()
        contract = os.path.join(root, "contract0.mp4")
        code, _ = http_json(port, "/v1/extract", {"feature_type": clip_ft, "video_path": contract,
                                                  "id": "p19-clip", "bucket": "320x240"})
        (crec,) = wait_terminal(["p19-clip"]).values()
        torch.cuda.synchronize(device)
        k1_probe = flash_attention.launches
        spans = [s for s in daemon.pool.get(clip_ft).telemetry.spans() if s["t0"] >= t_probe]
        forwards = sum(1 for s in spans if s["stage"] in ("dispatch", "extract"))
        ref = np.load(os.path.join(root, "serve_batch_1", "CLIP-ViT-B", "32",
                                   "contract0_CLIP-ViT-B-32.npy"))
        err = float(np.abs(np.load(crec["features"][0]) - ref).max()) \
            if crec["state"] == "done" else float("inf")
        events = _preempt_events(out)[events_seen:]
        print(f"preempt, CLIP after the cooldown: {code}, {crec['state']}, breaker "
              f"{daemon._breaker(clip_ft).state()}, {forwards} forwards (the probe's re-warm and "
              f"the request), K1 launches {k1_probe}; features max_abs_err {err:.3e} against the "
              f"batch CLI's (tol {INGEST_ATOL:g}); events {events}")
        if code != 202 or crec["state"] != "done" or not err <= INGEST_ATOL \
                or k1_probe != LAYERS * forwards or forwards < 1 \
                or ("rewarmed", clip_ft, None) not in events:
            raise AssertionError(f"CLIP's re-warm: {code} {crec} {k1_probe} {events}")

        # step 5: a beneficiary whose build fails hands the victim back
        daemon.pool.evict("i3d")
        ballast = wall_up(daemon.ledger.hbm_projection()["i3d"]["resident"] - min(
            r_clip, r_i3d) // 2)
        build = daemon.pool._build

        def failing_build(cfg):
            if cfg.feature_type == "i3d":
                raise RuntimeError("injected build failure of the preemption's beneficiary")
            return build(cfg)

        daemon.pool._build = failing_build
        try:
            code, _ = http_json(port, "/v1/extract", {"feature_type": "i3d", "id": "p19-fail",
                                                      "video_path": os.path.join(root,
                                                                                 "i3d1.mp4")})
            (frec,) = wait_terminal(["p19-fail"]).values()
        finally:
            daemon.pool._build = build
            del ballast
            ballast = None
        gc.collect()
        headroom()
        reset_counts()
        code_c, _ = http_json(port, "/v1/extract", {"feature_type": clip_ft, "id": "p19-back",
                                                    "video_path": os.path.join(root,
                                                                               "contract1.mp4"),
                                                    "bucket": "320x240"})
        (brec,) = wait_terminal(["p19-back"]).values()
        k1_back = flash_attention.launches
        events = _preempt_events(out)[events_seen:]
        print(f"preempt, I3D + PWC whose build fails: {code} {frec['state']}; CLIP's breaker "
              f"{daemon._breaker(clip_ft).state()}, then a CLIP request {code_c} "
              f"{brec['state']}, K1 launches {k1_back}; events {events}")
        if frec["state"] != "failed" or brec["state"] != "done" or k1_back != LAYERS \
                or events[-2:] != [("preempted", clip_ft, "i3d"),
                                   ("preemption_rollback", clip_ft, "i3d")]:
            raise AssertionError(f"rollback: {frec} {brec} {events}")
        k1, k2 = k1_probe + k1_back, k2_i3d
    finally:
        ballast = None
        daemon.shutdown(drain=True)
    print(f"preempt: phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention": k1, "local_correlation": k2}


def native_build_probe():
    """Phase 20's first lines: the compiler, both native builds with their
    times, the libav versions the decoder links (or why it does not
    build), and the cores the chains may use. Returns (preprocess built,
    decoder built)."""
    from video_features_tpu_torch import native

    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as exc:
        gxx = f"not runnable ({type(exc).__name__}: {exc})"
    print(f"native: g++ --version: {gxx}")
    built = {}
    for name, libs, probe in (("preprocess", (), native.available),
                              ("decoder", native.DECODER_LIBS, native.decoder_available)):
        found = native.library_path(name, libs).exists()
        t0 = time.perf_counter()
        built[name] = probe()
        err = native.build_error() if name == "preprocess" else native.decoder_build_error()
        print(f"native: {name} library {'built' if built[name] else 'NOT built'} in "
              f"{time.perf_counter() - t0:.2f} s ({'found in' if found else 'compiled into'} "
              f"_build/)" + ("" if built[name] else
                             f": {' | '.join(err.strip().splitlines()[:3])}"))
    if built["decoder"]:
        lib = native.load_decoder()
        versions = []
        for part in ("avformat", "avcodec", "swscale", "avutil"):
            fn = getattr(lib, f"{part}_version")
            fn.restype = ctypes.c_uint
            v = fn()
            versions.append(f"lib{part} {v >> 16}.{(v >> 8) & 0xFF}.{v & 0xFF}")
        print(f"native: the decoder links {', '.join(versions)}")
    print(f"native: cpu_budget() {native.cpu_budget()} (os.cpu_count() {os.cpu_count()})")
    return built["preprocess"], built["decoder"]


def native_decode_sweep(clips) -> None:
    """Phase 20, the decoder built: each clip through a raw
    ``vfdec_retrieve`` into a buffer with a sentinel tail (untouched),
    frame for frame against the host's cv2 (byte-equal), with cv2's frame
    count and fps; then ms per clip by backend, whole decode and uni_12."""
    import cv2

    from video_features_tpu_torch import native
    from video_features_tpu_torch.io.video import extract_frames, stream_frames

    worst = 0
    for path in clips:
        cap = cv2.VideoCapture(path)
        with native.NativeVideoReader(path) as reader:
            h, w = reader.height, reader.width
            n = touched = diff = 0
            while reader.grab() >= 0:
                buf = np.full(h * w * 3 + NATIVE_SENTINEL, 0xA5, np.uint8)
                reader.retrieve_into(buf)
                touched += int((buf[-NATIVE_SENTINEL:] != 0xA5).sum())
                ok, ref = cap.read()
                if not ok:
                    raise AssertionError(f"{path}: cv2 ended at frame {n}, the native "
                                         "decoder went on")
                ref = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB)
                diff = max(diff, int(np.abs(buf[:-NATIVE_SENTINEL].reshape(h, w, 3)
                                            .astype(np.int16) - ref).max()))
                n += 1
            more = cap.read()[0]
            fps, count = reader.fps, reader.frame_count
        cv2_fps, cv2_count = cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        print(f"native decode {os.path.basename(path)} ({w}x{h}): {n} frames, max_abs_diff vs "
              f"cv2 {diff} (gate 0), sentinel bytes written {touched} (gate 0), count "
              f"{count} vs cv2 {cv2_count}, fps {fps} vs cv2 {cv2_fps}")
        if diff or touched or more or (count, fps) != (cv2_count, cv2_fps):
            raise AssertionError(f"{path}: the native decoder disagrees with cv2 (diff {diff}, "
                                 f"tail {touched}, cv2 had more {more}, count {count} vs "
                                 f"{cv2_count}, fps {fps} vs {cv2_fps})")
        worst = max(worst, diff)
    ms = {("whole", b): [] for b in ("native", "cv2")}
    ms.update({("uni_12", b): [] for b in ("native", "cv2")})
    for backend in ("native", "cv2", "cv2", "native"):
        for path in clips:
            t0 = time.perf_counter()
            for _ in stream_frames(path, None, backend):
                pass
            t1 = time.perf_counter()
            extract_frames(path, f"uni_{FRAMES}", backend)
            ms[("whole", backend)].append((t1 - t0) * 1e3)
            ms[("uni_12", backend)].append((time.perf_counter() - t1) * 1e3)
    print(f"native decode, {len(clips)} clips, mean ms per clip over two passes each: whole "
          f"decode native {np.mean(ms[('whole', 'native')]):.3f} vs cv2 "
          f"{np.mean(ms[('whole', 'cv2')]):.3f}; uni_{FRAMES} native "
          f"{np.mean(ms[('uni_12', 'native')]):.3f} vs cv2 {np.mean(ms[('uni_12', 'cv2')]):.3f}"
          f"; max_abs_diff {worst}")


def native_preprocess_check(clips) -> None:
    """Phase 20: both C++ chains against PIL on the clips' decoded frames,
    within the JAX package's bounds, and host ms per video of each."""
    from PIL import Image

    from video_features_tpu_torch import native
    from video_features_tpu_torch.io.video import extract_frames, stream_frames
    from video_features_tpu_torch.ops.preprocess import (
        CLIP_MEAN,
        CLIP_STD,
        imagenet_preprocess,
        normalize_chw,
        pil_center_crop,
        pil_resize,
        to_float_chw,
    )

    def pil_clip(f):
        img = pil_center_crop(pil_resize(f, 224, interpolation=Image.BICUBIC), 224)
        return normalize_chw(to_float_chw(img), CLIP_MEAN, CLIP_STD)

    threads = native.cpu_budget()
    chains = {
        "imagenet": (lambda p: [f for f, _ in stream_frames(p)], imagenet_preprocess,
                     lambda x: native.imagenet_preprocess_batch(x, threads=threads)),
        "clip": (lambda p: extract_frames(p, f"uni_{FRAMES}")[0], pil_clip,
                 lambda x: native.clip_preprocess_batch(x, threads=threads)),
    }
    for chain, (frames_of, pil, nat) in chains.items():
        diffs, t_pil, t_nat = [], 0.0, 0.0
        for path in clips:
            frames = frames_of(path)
            t0 = time.perf_counter()
            ref = np.stack([pil(f) for f in frames])
            t1 = time.perf_counter()
            out = nat(np.stack(frames))
            t_pil, t_nat = t_pil + t1 - t0, t_nat + time.perf_counter() - t1
            diffs.append(np.abs(out - ref))
        mean = float(np.mean([d.mean() for d in diffs]))
        worst = float(max(d.max() for d in diffs))
        mean_bound, max_bound = NATIVE_PIL_BOUNDS[chain]
        print(f"native preprocess, {chain} chain on {len(clips)} clips' frames: vs PIL mean "
              f"{mean:.5f} (< {mean_bound:g}), max {worst:.5f} (< {max_bound:g}); host ms per "
              f"video PIL {t_pil / len(clips) * 1e3:.2f} vs native {t_nat / len(clips) * 1e3:.2f} "
              f"({threads} threads)")
        if not (mean < mean_bound and worst < max_bound):
            raise AssertionError(f"native {chain} chain off PIL: mean {mean}, max {worst}")


def run_native_path(root: str, device):
    """Phase 20: --host_preprocess native and --decoder native (module
    docstring). Returns each kernel's launches in the phase."""
    from video_features_tpu_torch import cli, native
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.utils.synth import synth_video

    print(f"native: {card_line()}")
    pre_ok, dec_ok = native_build_probe()
    if not pre_ok:
        raise AssertionError("the native preprocess library does not build on this host")
    cell1 = [os.path.join(root, f"clip{i}.mp4") for i in range(N_VIDEOS)]
    sweep = [synth_video(os.path.join(root, f"native_w{w}.mp4"), width=w, height=240, seed=w)
             for w in NATIVE_SWEEP_WIDTHS]
    contract = [os.path.join(root, f"contract{i}.mp4") for i in range(CONTRACT_VIDEOS)]
    resnet_clip = os.path.join(root, "resnet50.mp4")
    tmp = os.path.join(root, "tmp")
    if dec_ok:
        native_decode_sweep(cell1 + sweep)
        decoder = "native"
    else:
        print("native: the decoder does not build on this host, so --decoder native stays "
              "unverified here; checking its refusal and auto's fallback to cv2")
        out = os.path.join(root, "native_refused")
        try:
            cli.main(["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                      "--attn", "flash", "--allow_random_init", "--decoder", "native",
                      "--on_extraction", "save_numpy", "--strict", "--output_path", out,
                      "--tmp_path", tmp, "--video_paths", cell1[0]])
        except SystemExit as exc:
            code = exc.code
        else:
            raise AssertionError("--decoder native --strict without the decoder exited 0")
        with open(os.path.join(out, "_manifest", "summary.json")) as f:
            rec = json.load(f)["videos"][cell1[0]]
        first = native.decoder_build_error().strip().splitlines()[0]
        print(f"native: --decoder native --strict without the decoder: exit "
              f"{str(code).splitlines()[0]!r}; record {rec['status']}, {rec['error_type']}: "
              f"{rec.get('message', '')[:160]!r}")
        if code in (0, None) or rec["status"] != "failed" or first not in rec.get("message", ""):
            raise AssertionError(f"--decoder native refusal: exit {code!r}, record {rec}")
        decoder = "auto"
    native_preprocess_check(cell1 + sweep)

    def clip_run(out, *extra, videos=contract):
        reset_counts()
        native.reset_reader_counts()
        t0 = time.perf_counter()
        cli.main(["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                  "--attn", "flash", "--allow_random_init", "--decode_workers", "2",
                  "--on_extraction", "save_numpy", "--strict", "--output_path",
                  os.path.join(root, out), "--tmp_path", tmp, *extra, "--video_paths", *videos])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, flash_attention.launches, dict(native.readers_opened),
                read_features(os.path.join(root, out)))

    wall, k1, readers, nat = clip_run("native_clip", "--host_preprocess", "native",
                                      "--decoder", decoder)
    print(f"native CLIP (--host_preprocess native --decoder {decoder} --decode_workers 2, "
          f"{CONTRACT_VIDEOS} clips, cold CLI run): {CONTRACT_VIDEOS / wall:.3f} videos/s; "
          f"flash_attention launches {k1}; readers {readers}")
    if len(nat) != CONTRACT_VIDEOS or k1 != CONTRACT_VIDEOS * LAYERS:
        raise AssertionError(f"native CLIP run: {len(nat)} files, {k1} K1 launches")
    want = {"native": readers["native"] + readers["cv2"], "cv2": 0} if dec_ok else \
        {"native": 0, "cv2": readers["native"] + readers["cv2"]}
    if readers != want or not readers[decoder if dec_ok else "cv2"]:
        raise AssertionError(f"native CLIP run opened readers {readers}, expected {want}")
    _, k1_pil, _, pil = clip_run("native_clip_pil", "--host_preprocess", "pil",
                                 "--decoder", "cv2")
    cpu_wall, _, _, cpu = clip_run("native_clip_cpu", "--host_preprocess", "native",
                                   "--decoder", decoder, "--cpu")
    err = max(float(np.abs(nat[k] - cpu[k]).max()) for k in nat)
    drift = max(rel_l2(nat[k], pil[k]) for k in nat)
    print(f"native CLIP: card vs the port on the CPU (same flags, {cpu_wall:.1f} s there) "
          f"max_abs_err {err:.3e} (tol {FEATURE_ATOL:g}); vs the card's pil/cv2 run rel_l2 "
          f"{drift:.3e} (tol {NATIVE_REL_L2:g})")
    if sorted(cpu) != sorted(nat) or not err <= FEATURE_ATOL or not drift <= NATIVE_REL_L2:
        raise AssertionError(f"native CLIP features: card vs CPU {err}, vs pil {drift}")

    def warm_host(feature_type, clips, **kw):
        """Warm host ms per video (prepare) at pil and at native, over the
        same clips, in turns pil, native, native, pil."""
        exs = {hp: build_extractor(ExtractionConfig(
            feature_type=feature_type, video_paths=clips, allow_random_init=True,
            host_preprocess=hp, decoder=decoder, **kw), external_call=True)
            for hp in ("pil", "native")}
        ms = {"pil": [], "native": []}
        for hp in ("pil", "native", "native", "pil"):
            prep, _ = warm_split(exs[hp], clips, device)
            ms[hp].append(prep / len(clips) * 1e3)
        return {hp: float(np.mean(v)) for hp, v in ms.items()}

    host = warm_host("CLIP-ViT-B/32", contract, extract_method=f"uni_{FRAMES}", attn="flash")
    print(f"native CLIP warm host ms/video (decode + preprocess, --decoder {decoder}): pil "
          f"{host['pil']:.2f} vs native {host['native']:.2f} "
          f"({host['pil'] / host['native']:.2f}x); {card_line()}")
    k1 += k1_pil + flash_attention.launches  # the warm runs' launches too

    def resnet_run(out, *extra):
        reset_counts()
        native.reset_reader_counts()
        cli.main(["--feature_type", "resnet50", "--batch_size", str(RESNET_BATCH),
                  "--allow_random_init", "--on_extraction", "save_numpy", "--strict",
                  "--output_path", os.path.join(root, out), "--tmp_path", tmp, *extra,
                  "--video_paths", resnet_clip])
        torch.cuda.synchronize()
        (feats,) = read_features(os.path.join(root, out)).values()
        return feats, dict(native.readers_opened)

    rn, readers = resnet_run("native_resnet", "--host_preprocess", "native", "--decoder", "auto")
    no_kernel_launches("native ResNet-50 path")
    print(f"native ResNet-50 (--host_preprocess native --decoder auto): {rn.shape}; "
          f"readers {readers}")
    if rn.shape != (RESNET_CLIP_FRAMES, 2048) or not np.isfinite(rn).all():
        raise AssertionError(f"native ResNet-50: {rn.shape}")
    want = ({"native": readers["native"], "cv2": 0} if dec_ok
            else {"native": 0, "cv2": readers["cv2"]})
    if readers != want or not sum(readers.values()):
        raise AssertionError(f"--decoder auto opened {readers}, expected {want}")
    rn_pil, _ = resnet_run("native_resnet_pil", "--host_preprocess", "pil", "--decoder", "cv2")
    rn_cpu, _ = resnet_run("native_resnet_cpu", "--host_preprocess", "native", "--decoder",
                           "auto", "--cpu")
    err, drift = rel_l2(rn, rn_cpu), rel_l2(rn, rn_pil)
    print(f"native ResNet-50: card vs the port on the CPU rel_l2 {err:.3e} (tol "
          f"{CNN_FEATURE_RTOL:g}); vs the card's pil/cv2 run rel_l2 {drift:.3e} (tol "
          f"{NATIVE_REL_L2:g})")
    if not err <= CNN_FEATURE_RTOL or not drift <= NATIVE_REL_L2:
        raise AssertionError(f"native ResNet-50 features: card vs CPU {err}, vs pil {drift}")
    host = warm_host("resnet50", [resnet_clip], batch_size=RESNET_BATCH)
    print(f"native ResNet-50 warm host ms/video (decode + preprocess, --decoder {decoder}): "
          f"pil {host['pil']:.2f} vs native {host['native']:.2f} "
          f"({host['pil'] / host['native']:.2f}x); {card_line()}")
    no_kernel_launches("native ResNet-50 warm runs")
    return {"flash_attention": k1, "local_correlation": 0}


@contextlib.contextmanager
def k1_shapes():
    """Yields the set of q shapes CLIP's flash core gets while it is open
    (a recorder around the real wrapper, whose count stays the only
    count; the recorder is taken at each extractor's build)."""
    from video_features_tpu_torch.models.clip import extract_clip

    seen = set()
    flash = extract_clip.CORES["flash"]

    def k1(q, k, v, **kw):
        seen.add(tuple(q.shape))
        return flash(q, k, v, **kw)

    with mock.patch.dict(extract_clip.CORES, {"flash": k1}):
        yield seen


def run_parallel_path(root: str, device):
    """Phase 21: queue mode and CLIP's mesh (module docstring). Returns
    each kernel's launches in the phase."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.parallel.scheduler import parallel_feature_extraction

    card = card_line()
    print(f"parallel: {card}; {torch.cuda.device_count()} visible CUDA device(s)")
    clips = [os.path.join(root, f"contract{i}.mp4") for i in range(CONTRACT_VIDEOS)]
    launches = {"flash_attention": 0, "local_correlation": 0}
    forwards = CONTRACT_VIDEOS  # one uni_12 forward a video
    want_mesh_k1 = LAYERS * 2 * forwards  # 12 blocks x 2 cells x forwards

    def run(out, *extra, attn="flash"):
        reset_counts()
        with k1_shapes() as shapes:
            t0 = time.perf_counter()
            cli.main(["--feature_type", "CLIP-ViT-B/32", "--extract_method", f"uni_{FRAMES}",
                      "--attn", attn, "--allow_random_init", "--on_extraction", "save_numpy",
                      "--strict", "--output_path", os.path.join(root, out), "--tmp_path",
                      os.path.join(root, "tmp"), *extra, "--video_paths", *clips])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k1 = flash_attention.launches
        launches["flash_attention"] += k1
        launches["local_correlation"] += local_correlation_kernel.launches
        feats = read_features(os.path.join(root, out))
        if len(feats) != CONTRACT_VIDEOS:
            raise AssertionError(f"{out}: {len(feats)} files of {CONTRACT_VIDEOS}")
        print(f"parallel, {' '.join(extra)} --attn {attn} (cold CLI run, model build "
              f"included): {CONTRACT_VIDEOS} videos in {wall:.3f} s, "
              f"{CONTRACT_VIDEOS / wall:.3f} videos/s; K1 launches {k1} at {sorted(shapes)} "
              f"[{card}]")
        return k1, sorted(shapes), feats

    def lanes(out):
        with open(os.path.join(root, out, "_manifest", "summary.json")) as f:
            summary = json.load(f)
        threads = set()
        for path in glob.glob(os.path.join(root, out, "_telemetry", "spans-*.jsonl")):
            with open(path) as f:
                threads |= {json.loads(line).get("thread_name") for line in f if line.strip()}
        return (sorted(summary["telemetry"]["utilization"]["devices"]),
                sorted(t for t in threads if t and t.startswith("extract-")))

    def warm_queue(devices, where):
        """Warm queue mode over ``devices`` (two), 1 and 2 workers in turns,
        ``WARM_QUEUE_PASSES`` passes each over a window of
        ``WARM_QUEUE_COPIES`` hard links to each clip (its own name each):
        the median and range of videos/s, and the device lanes of a
        2-worker pass (both models built, so both workers take videos)."""
        from video_features_tpu_torch.runtime.telemetry import utilization_report

        window = []
        os.makedirs(os.path.join(root, "warm_window"), exist_ok=True)
        for c in range(WARM_QUEUE_COPIES):
            for clip in clips:
                dst = os.path.join(root, "warm_window", f"{c:02d}_{os.path.basename(clip)}")
                if not os.path.exists(dst):
                    os.link(clip, dst)
                window.append(dst)
        ex = build_extractor(ExtractionConfig(
            feature_type="CLIP-ViT-B/32", video_paths=clips, extract_method=f"uni_{FRAMES}",
            attn="flash", allow_random_init=True), external_call=True)
        lists = {1: devices[:1], 2: devices}
        for w in (1, 2):
            parallel_feature_extraction(ex, lists[w])  # builds, cuBLAS and allocator set-up
        ex.path_list = window  # the timed passes run the window on the warm models
        walls = {1: [], 2: []}
        for w in (1, 2) * WARM_QUEUE_PASSES:
            before = len(ex.telemetry.spans())
            t0 = time.perf_counter()
            parallel_feature_extraction(ex, lists[w])  # each worker ends in copies to the host
            torch.cuda.synchronize()
            walls[w].append(time.perf_counter() - t0)
            if w == 2:
                pass_lanes = sorted(utilization_report(ex.telemetry.spans()[before:])["devices"])
        vps = {w: [len(window) / t for t in ts] for w, ts in walls.items()}
        med = {w: float(np.median(v)) for w, v in vps.items()}
        print(f"parallel, warm queue mode {where}, {len(window)} videos a pass, "
              f"{WARM_QUEUE_PASSES} passes each in turns 1, 2 workers: 1 worker median "
              f"{med[1]:.3f} videos/s (range {min(vps[1]):.3f}-{max(vps[1]):.3f}; passes "
              f"{', '.join(f'{v:.3f}' for v in vps[1])}), 2 workers median {med[2]:.3f} "
              f"(range {min(vps[2]):.3f}-{max(vps[2]):.3f}; passes "
              f"{', '.join(f'{v:.3f}' for v in vps[2])}); medians {med[2] / med[1]:.3f}x; "
              f"a 2-worker pass's lanes {pass_lanes} [{card}]")
        if len(pass_lanes) != 2:
            raise AssertionError(f"warm queue mode {where}: lanes {pass_lanes}")

    def queue_and_mesh(ids, tag):
        """(a)-(c) on the device ids ``ids`` (two of them). On one card the
        second worker's warmup finds the model built, so both workers take
        videos of the cold run; on two cards the second builds its own and
        may find the queue drained (``warm_queue`` shows both at work)."""
        k1, _, one = run(f"par_{tag}_q1", "--device_ids", ids[0])
        k1_two, _, two = run(f"par_{tag}_q2", "--device_ids", *ids)
        err = max_abs_diff(two, one)
        devices, threads = lanes(f"par_{tag}_q2")
        print(f"parallel (a), queue mode on devices {' '.join(ids)}: features against one "
              f"worker max_abs_err {err:.3e} (tol {CONTRACT_ATOL:g}); K1 {k1} and {k1_two}; "
              f"device lanes in summary.json {devices}; worker threads in the spans {threads}")
        both = len(devices) == 2 and len(threads) == 2
        if not (err <= CONTRACT_ATOL and k1 == k1_two == CONTRACT_VIDEOS * LAYERS
                and (both or ids[0] != ids[1])):
            raise AssertionError(f"queue mode on {ids}: err {err}, K1 {k1}/{k1_two}, "
                                 f"lanes {devices}, threads {threads}")
        for label, mesh_args, tol, shape in (
                ("(b) data parallel", ("--mesh_model", "1"), MESH_ATOL["data"], (8, 12, 50, 64)),
                ("(c) tensor parallel", ("--mesh_model", "2"), MESH_ATOL["tensor"],
                 (16, 6, 50, 64))):
            k1_mesh, shapes, feats = run(f"par_{tag}_{label[1]}", "--sharding", "mesh",
                                         "--device_ids", *ids, *mesh_args)
            err = max_abs_diff(feats, one)
            print(f"parallel {label}, mesh {' '.join(ids)} {' '.join(mesh_args)}: features "
                  f"against queue mode max_abs_err {err:.3e} (tol {tol:g}); K1 {k1_mesh} "
                  f"(want {want_mesh_k1}) at {shapes}")
            if not (err <= tol and k1_mesh == want_mesh_k1 and shapes == [shape]):
                raise AssertionError(f"mesh {label} on {ids}: err {err}, K1 {k1_mesh}, {shapes}")
        return one

    t_phase = time.perf_counter()
    idx = str(device.index or 0)
    one = queue_and_mesh([idx, idx], "same")
    warm_queue([device, device], "on one card")

    k1, _, ctx = run("par_context", "--sharding", "mesh", "--device_ids", *[idx] * 4,
                     "--mesh_model", "2", "--mesh_context",
                     attn="fused")
    err = max_abs_diff(ctx, one)
    print(f"parallel (d) context parallel, mesh 2 x 2 on one card --mesh_context: features "
          f"against queue mode max_abs_err {err:.3e} (tol {MESH_ATOL['context']:g}); K1 {k1}")
    if not (err <= MESH_ATOL["context"] and k1 == 0):
        raise AssertionError(f"--mesh_context: err {err}, K1 {k1}")

    if torch.cuda.device_count() > 1:
        queue_and_mesh(["0", "1"], "distinct")
        warm_queue([torch.device("cuda", 0), torch.device("cuda", 1)], "on two cards")
        if torch.cuda.device_count() >= 4:  # a 2 x 2 mesh of distinct cards
            four = ["0", "1", "2", "3"]
            for label, extra, attn, tol, want in (
                    ("data x tensor parallel", (), "flash", MESH_ATOL["tensor"], want_mesh_k1 * 2),
                    ("context parallel", ("--mesh_context",), "fused", MESH_ATOL["context"], 0)):
                k1, _, feats = run(f"par_four_{attn}", "--sharding", "mesh", "--device_ids", *four,
                                   "--mesh_model", "2", *extra, attn=attn)
                err = max_abs_diff(feats, one)
                print(f"parallel (f), {label} 2 x 2 on cards 0-3: features against queue mode "
                      f"max_abs_err {err:.3e} (tol {tol:g}); K1 {k1} (want {want})")
                if not (err <= tol and k1 == want):
                    raise AssertionError(f"2 x 2 {label} on cards 0-3: err {err}, K1 {k1}")
    else:
        print("parallel (f): one CUDA device on this host, so no run on distinct cards was "
              "possible: nothing here crossed between cards, and no speed-up from more cards "
              "was measured")
    print(f"parallel: phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# phases 5-11's flags of each family but CLIP; phases 22 and 23 run on
# their clips (``family_inputs``) and hold against their '<family>_out'
FAMILY_FLAGS = {"resnet50": ("--batch_size", str(RESNET_BATCH)), "r21d_rgb": (),
                "vggish": (), "pwc": ("--batch_size", str(PWC_BATCH)),
                "raft": ("--batch_size", str(RAFT_BATCH)), "i3d": ("--flow_type", "pwc")}


def family_inputs(root: str) -> dict:
    """Phases 5-11's clips and wavs of each family but CLIP, made here with
    the same seeds and sizes when a phase runs alone."""
    from video_features_tpu_torch.utils.synth import synth_video, synth_wav

    def video(name, n, seed, **size):
        path = os.path.join(root, name)
        return path if os.path.exists(path) else synth_video(path, n_frames=n, seed=seed, **size)

    def wav(i):
        path = os.path.join(root, f"audio{i}.wav")
        return path if os.path.exists(path) else synth_wav(
            path, seconds=VGGISH_SECONDS[i], sample_rate=VGGISH_RATE, channels=2, seed=i)

    n_raft, w_raft, h_raft = RAFT_CLIP
    return {
        "resnet50": [video("resnet50.mp4", RESNET_CLIP_FRAMES, 7)],
        "r21d_rgb": [video("r21d_rgb.mp4", R21D_CLIP_FRAMES, 7)],
        "vggish": [wav(i) for i in range(len(VGGISH_SECONDS))],
        "pwc": [video("pwc.mp4", PWC_CLIP_FRAMES, 5)],
        "raft": [video("raft.mp4", n_raft, 6, width=w_raft, height=h_raft)],
        "i3d": [video(f"i3d{i}.mp4", I3D_CLIP_FRAMES, i) for i in range(I3D_VIDEOS)],
    }


def run_mesh_path(root: str, device):
    """Phase 22: ``--sharding mesh`` for ResNet-50, R(2+1)D-18, VGGish,
    PWC, RAFT and I3D + PWC (module docstring). Returns each kernel's
    launches in the phase."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.parallel.sharding import row_sizes

    card = card_line()
    print(f"mesh: {card}; {torch.cuda.device_count()} visible CUDA device(s)")
    launches = {"flash_attention": 0, "local_correlation": 0}
    idx = str(device.index or 0)
    tmp = os.path.join(root, "tmp")

    def run(out, feature_type, inputs, *extra):
        reset_counts()
        t0 = time.perf_counter()
        cli.main(["--feature_type", feature_type, "--allow_random_init", "--on_extraction",
                  "save_numpy", "--strict", "--output_path", os.path.join(root, out),
                  "--tmp_path", tmp, *extra, "--video_paths", *inputs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = flash_attention.launches, local_correlation_kernel.launches
        launches["flash_attention"] += k1
        launches["local_correlation"] += k2
        return read_features(os.path.join(root, out)), k1, k2, wall

    # each family's clips and its one-device run of phases 5-11 (the same
    # clips, seeds and flags), made here when this phase runs alone
    clips, flags = family_inputs(root), FAMILY_FLAGS
    # R(2+1)D's phase ran one stack a forward: the mesh splits a batch of 4
    mesh_flags = dict(flags, r21d_rgb=("--batch_size", "4"))
    refs = {}
    for ft, paths in clips.items():
        out = f"{ft}_out"
        if not os.path.isdir(os.path.join(root, out)):
            print(f"mesh: {out} absent, the one-device run made here")
            run(out, ft, paths, *flags[ft], "--device_ids", idx)
        refs[ft] = read_features(os.path.join(root, out))

    def held(got, want, k1, k2, k2_want, label, tol_fn, against="the one-device run"):
        names = sorted(want)
        if sorted(got) != names:
            raise AssertionError(f"mesh {label}: files {sorted(got)}, want {names}")
        shapes_ok = all(got[n].shape == want[n].shape and np.isfinite(got[n]).all()
                        for n in names)
        errs = [tol_fn(got[n], want[n]) for n in names]
        err, tol = max(e for e, _ in errs), errs[0][1]
        print(f"mesh {label}: {len(names)} file(s) {[want[n].shape for n in names]} against "
              f"{against} {err:.3e} (tol {tol:g}); K1 {k1}, K2 {k2} (want {k2_want})")
        if not (shapes_ok and err <= tol and k1 == 0 and k2 == k2_want):
            raise AssertionError(f"mesh {label}: err {err}, K1 {k1}, K2 {k2}, "
                                 f"shapes {shapes_ok}")

    def rel(a, b):
        return rel_l2(a, b), FAMILY_MESH_RTOL

    def flow(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max()), FLOW_RTOL

    def i3d_abs(a, b):
        return float(np.abs(a - b).max()), I3D_MESH_ATOL

    pwc_windows = -(-(PWC_CLIP_FRAMES - 1) // PWC_BATCH)
    i3d_stacks = I3D_VIDEOS * I3D_STACKS

    def families(ids, tag):
        """(a)-(c) on the device ids ``ids``: the DP families on two rows,
        the flows and I3D on ``data`` 2 and 4 (``ids`` repeated to 4)."""
        two, four = ids[:2], (ids * 4)[:4]
        for ft in ("resnet50", "r21d_rgb", "vggish"):
            got, k1, k2, wall = run(f"mesh_{tag}_{ft}", ft, clips[ft], *mesh_flags[ft],
                                    "--sharding", "mesh", "--device_ids", *two)
            held(got, refs[ft], k1, k2, 0,
                 f"(a) {ft} data parallel on {' '.join(two)} ({wall:.1f} s)", rel)
        host = {}
        for ft in ("pwc", "raft"):
            for rows in (two, four):
                got, k1, k2, wall = run(f"mesh_{tag}_{ft}{len(rows)}", ft, clips[ft],
                                        *flags[ft], "--sharding", "mesh", "--device_ids", *rows)
                shard = row_sizes(PWC_BATCH, len(rows))
                want = len(CORR_LEVELS) * sum(1 for s in shard if s) * pwc_windows
                held(got, refs[ft], k1, k2, want if ft == "pwc" else 0,
                     f"(b) {ft} --batch_size {PWC_BATCH}, data {len(rows)} on "
                     f"{' '.join(rows)}, a window's pairs per row {shard} ({wall:.1f} s)", flow)
                host[ft, len(rows)] = got
        for rows in (two, four):
            got, k1, k2, wall = run(f"mesh_{tag}_i3d{len(rows)}", "i3d", clips["i3d"],
                                    *flags["i3d"], "--sharding", "mesh", "--device_ids", *rows)
            shard = row_sizes(STACK, len(rows), 8)
            ran = sum(1 for s in shard if s)
            held(got, refs["i3d"], k1, k2, len(CORR_LEVELS) * ran * i3d_stacks,
                 f"(c) i3d --flow_type pwc, data {len(rows)} on {' '.join(rows)}, each stack's "
                 f"pairs per row {shard} (K2 at N={max(shard)}), rows that sat out on the tail "
                 f"stack {len(rows) - ran} ({wall:.1f} s)", i3d_abs)
            host["i3d", len(rows)] = got
        return host

    t_phase = time.perf_counter()
    host = families([idx, idx], "same")

    def drift(a, b):
        return rel_l2(a, b), DEVICE_DRIFT

    for ft, k2_want in (("pwc", len(CORR_LEVELS) * 2 * pwc_windows),
                        ("i3d", len(CORR_LEVELS) * 2 * i3d_stacks)):
        got, k1, k2, wall = run(f"mesh_device_{ft}", ft, clips[ft], *flags[ft],
                                "--preprocess", "device", "--sharding", "mesh",
                                "--device_ids", idx, idx)
        held(got, host[ft, 2], k1, k2, k2_want,
             f"(d) {ft} --preprocess device, data 2 ({wall:.1f} s)", drift,
             against="the --preprocess host mesh run")

    want = ("--mesh_model 2 needs tensor-parallel param specs, which ExtractResNet does not "
            "define (only the batch axis shards); use --mesh_model 1")
    try:
        cli.main(["--feature_type", "resnet50", "--allow_random_init", "--sharding", "mesh",
                  "--mesh_model", "2", "--device_ids", idx, idx, "--output_path",
                  os.path.join(root, "mesh_refused"), "--tmp_path", tmp,
                  "--video_paths", clips["resnet50"][0]])
    except ValueError as exc:
        got = str(exc)
    else:
        raise AssertionError("--mesh_model 2 on resnet50 was not refused")
    print(f"mesh (e), --sharding mesh --mesh_model 2 --feature_type resnet50: ValueError (exit 1 "
          f"from the command line): {got}")
    if got != want:
        raise AssertionError(f"the refusal's message differs from the JAX package's: {got!r}")

    count = torch.cuda.device_count()
    if count > 1:  # two rows on cards 0 and 1; four on 0-3, or 0 1 0 1 on two
        families([str(i) for i in range(min(count, 4))], "distinct")
    else:
        print("mesh (f): one CUDA device on this host, so no run on distinct cards was "
              "possible: nothing here crossed between cards, and no speed-up from more cards "
              "was measured")
    print(f"mesh: phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def run_multiprocess_path(root: str, device):
    """Phase 24: ``--sharding mesh`` across launched processes (module
    docstring). Returns each kernel's launches in the phase: the ranks'
    sums and those of the one-process runs they are held to."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.parallel.distributed import backend_for
    from video_features_tpu_torch.utils.synth import synth_video

    t_phase = time.perf_counter()
    card = card_line()
    count = torch.cuda.device_count()
    print(f"multi-process: {card}; {count} visible CUDA device(s)")
    launches = {"flash_attention": 0, "local_correlation": 0}
    # phase 5's 65-frame clip, made here when this phase runs alone
    clips = [os.path.join(root, MULTIPROCESS_CLIP)]
    if not os.path.exists(clips[0]):
        synth_video(clips[0], n_frames=STACK + 1, seed=9)
    tmp = os.path.join(root, "tmp")
    k1_held = set(MESH_ATTENTION_SHAPES.values())
    k2_held = {(n, c, h, w) for n, hp, wp in MESH_CORRELATION_CASES.values()
               for _, c, h, w in pwc_levels(hp, wp)}

    def flags(models):
        return ["--feature_types", *models, "--extract_method", f"uni_{FRAMES}", "--attn",
                "flash", "--flow_type", "pwc", "--allow_random_init", "--on_extraction",
                "save_numpy", "--strict", "--sharding", "mesh", "--tmp_path", tmp]

    def summary_of(out):
        with open(os.path.join(out, "_manifest", "summary.json")) as f:
            return json.load(f)

    def one_process(label, models, ids, *extra):
        """The one-process mesh of a grid, deterministic cuDNN as in the ranks."""
        out = os.path.join(root, f"multi_one_{label}")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            reset_counts()
            cli.main([*flags(models), *extra, "--device_ids", *ids, "--output_path", out,
                      "--video_paths", *clips])
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        launches["flash_attention"] += flash_attention.launches
        launches["local_correlation"] += local_correlation_kernel.launches
        # the ranks run next, beside this process: free its cached blocks
        gc.collect()
        torch.cuda.empty_cache()
        return read_features(out), summary_of(out)

    def ranks_run(label, models, extra, visible, cards, one, cells):
        """One launch of the two ranks over ``extra`` (their device flags),
        each seeing ``cards`` cards (``visible``), against the one-process
        run ``one``; ``cells`` is a rank's mesh cells (one data row)."""
        out = os.path.join(root, f"multi_{label}")
        shutil.rmtree(out, ignore_errors=True)
        free = torch.cuda.mem_get_info(device)[0] / 2**30
        wall, ranks, log = launch_ranks(root, label, [*flags(models), *extra, "--output_path",
                                                      out, "--video_paths", *clips], visible)
        want_backend = backend_for(False, MULTIPROCESS_RANKS, cards)
        backends = sorted({line.split("backend ")[1].split(",")[0]
                           for line in log.splitlines() if line.startswith("distributed:")})
        got, (want, one_summary) = read_features(out), one
        names = sorted(want)
        errs = {n: float(np.abs(got[n] - want[n]).max()) for n in names if n in got}
        err = max(errs.values(), default=float("inf"))
        print(f"multi-process {label}: max_abs_err by file "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
        # one writer: the sink spans of one process only (spans-<pid>-*.jsonl,
        # a file a model), one a video a model
        sinks = {}
        for path in glob.glob(os.path.join(out, "_telemetry", "spans-*.jsonl")):
            with open(path) as f:
                n = sum(1 for line in f if line.strip() and json.loads(line)["stage"] == "sink")
            if n:
                pid = os.path.basename(path).split("-")[1]
                sinks[pid] = sinks.get(pid, 0) + n
        summary = summary_of(out)
        k1 = sum(r["flash_attention"] for r in ranks)
        k2 = sum(r["local_correlation"] for r in ranks)
        k1_shapes = {tuple(sh) for r in ranks for sh in r["K1"]}
        k2_shapes = {tuple(sh) for r in ranks for sh in r["K2"]}
        # the least of card 0 a rank had: what was free at the launch less
        # the other ranks' peaks where they share it
        peaks = [r["peak_reserved"] / 2**30 for r in ranks]
        room = free - (sum(peaks) - min(peaks) if cards == 1 else 0.0)
        # a uni_12 forward a video, 12 blocks a cell; 5 levels a stack a row
        k1_want = LAYERS * cells * len(clips) if "CLIP-ViT-B/32" in models else 0
        k2_want = len(CORR_LEVELS) if "i3d" in models else 0  # one stack
        print(f"multi-process {label}: {' '.join(models)} on {MULTIPROCESS_RANKS} ranks "
              f"({' '.join(extra)} each), backend {backends} (the layout rule: "
              f"{want_backend} for {MULTIPROCESS_RANKS} processes over {cards} card(s)); "
              f"{len(got)} files; features against the one-process mesh max_abs_err {err:.3e} "
              f"(want 0); sink spans by process id {sinks}; summary.json {summary['done']}/"
              f"{summary['total']} done (one process {one_summary['done']}/"
              f"{one_summary['total']}); K1 by rank {[r['flash_attention'] for r in ranks]} "
              f"(want {k1_want} each) at {sorted(k1_shapes)}; K2 by rank "
              f"{[r['local_correlation'] for r in ranks]} (want {k2_want} each) at N="
              f"{sorted({sh[0] for sh in k2_shapes})}; card 0 {free:.2f} GiB free at the "
              f"launch, the ranks' peak reserved {[round(p, 2) for p in peaks]} GiB, so a rank "
              f"had at least {room:.2f} GiB (want >= {MULTIPROCESS_HEADROOM_GIB}); torchrun "
              f"wall {wall:.1f} s [{card}]")
        if room < MULTIPROCESS_HEADROOM_GIB:
            raise AssertionError(f"multi-process {label}: a rank had {room:.2f} GiB of the card, "
                                 f"under {MULTIPROCESS_HEADROOM_GIB}: too full a card for an "
                                 "exact comparison")
        if backends != [want_backend]:
            raise AssertionError(f"multi-process {label}: backend {backends}, the layout rule "
                                 f"gives {want_backend}")
        if sorted(got) != names or err != 0.0:
            raise AssertionError(f"multi-process {label}: files {sorted(got)} vs {names}, "
                                 f"err {err}")
        if len(sinks) != 1 or sum(sinks.values()) != len(models) * len(clips):
            raise AssertionError(f"multi-process {label}: sink spans {sinks}, want one process "
                                 f"with {len(models) * len(clips)}")
        if (summary["done"], summary["total"], summary["failed"]) != (
                one_summary["done"], one_summary["total"], 0):
            raise AssertionError(f"multi-process {label}: summary.json {summary}")
        if any((r["flash_attention"], r["local_correlation"]) != (k1_want, k2_want)
               for r in ranks):
            raise AssertionError(f"multi-process {label}: K1 and K2 by rank {ranks}")
        if not (k1_shapes <= k1_held and k2_shapes <= k2_held):
            raise AssertionError(f"multi-process {label}: K1 at {k1_shapes - k1_held} or K2 at "
                                 f"{k2_shapes - k2_held}, not held in phase 3")
        launches["flash_attention"] += k1
        launches["local_correlation"] += k2

    both = ["CLIP-ViT-B/32", "i3d"]
    idx = str(device.index or 0)
    one = one_process("both", both, [idx, idx])
    # both ranks on one card: gloo (NCCL runs no two ranks of one
    # communicator on one card)
    ranks_run("gloo", both, ["--device_ids", "0"], "0" if count > 1 else None, 1, one, 1)
    if count > 1:  # a card a rank: NCCL
        ranks_run("nccl", both, ["--device_ids", "0"], "0,1", 2, one, 1)
    if count >= 4:  # two cards a rank: CLIP data x tensor, the model axis in each rank
        tp = one_process("tp", ["CLIP-ViT-B/32"], [idx] * 4, "--mesh_model", "2")
        ranks_run("nccl_tp", ["CLIP-ViT-B/32"], ["--device_ids", "0", "1", "--mesh_model", "2"],
                  "0,1,2,3", 4, tp, 2)
    if count == 1:
        print("multi-process: one CUDA device on this host, so no NCCL run (two ranks on "
              "distinct cards) was possible")
    print(f"multi-process: phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


@contextlib.contextmanager
def timed_builds(cls):
    """Record each outermost ``cls._build(device)`` while the block runs:
    (ms from the call to a model on the device, the built state). A mesh
    build calls ``_build`` again for its first device; that inner call is
    part of the outer one."""
    built, depth = [], [0]
    original = cls._build

    def build(self, device):
        depth[0] += 1
        t0 = time.perf_counter()
        try:
            state = original(self, device)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            torch.cuda.synchronize()
            built.append(((time.perf_counter() - t0) * 1e3, state))
        return state

    with mock.patch.object(cls, "_build", build):
        yield built


def state_mismatches(state, seeded) -> list:
    """The names whose tensors in a built model (or I3D's dict of models)
    differ from the seeded state dict, bit for bit."""
    if isinstance(state, dict):
        return [f"{kind}:{n}" for kind, model in state.items()
                for n in state_mismatches(model, seeded[kind])]
    got = state.state_dict()
    return [k for k, v in seeded.items() if not k.endswith("num_batches_tracked")
            and not torch.equal(got[k].detach().cpu(), v)]


def run_weights_path(root: str, device):
    """Phase 23: ``--weights_path`` from files in every format (module
    docstring). Returns each kernel's launches in the phase."""
    from video_features_tpu_torch import cli
    from video_features_tpu_torch.config import parse_args
    from video_features_tpu_torch.convert_weights import converters
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.models.common.flax_msgpack import load_msgpack, save_msgpack
    from video_features_tpu_torch.models.common.orbax import load_orbax, save_orbax
    from video_features_tpu_torch.models.i3d.extract_i3d import WEIGHT_FILES
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention
    from video_features_tpu_torch.utils.synth import synth_video, synth_wav

    card = card_line()
    print(f"weights: {card}")
    launches = {"flash_attention": 0, "local_correlation": 0}
    idx = str(device.index or 0)
    tmp, wdir = os.path.join(root, "tmp"), os.path.join(root, "weights")
    os.makedirs(wdir, exist_ok=True)

    def video(name, n, seed, **size):
        path = os.path.join(root, name)
        return [path if os.path.exists(path) else synth_video(path, n_frames=n, seed=seed, **size)]

    wav = os.path.join(root, "weights.wav")
    if not os.path.exists(wav):
        synth_wav(wav, seconds=WEIGHTS_WAV_SECONDS, sample_rate=VGGISH_RATE, channels=2, seed=0)
    _, w_raft, h_raft = RAFT_CLIP
    pairs, windows = WEIGHTS_FLOW_FRAMES - 1, -(-(WEIGHTS_FLOW_FRAMES - 1) // PWC_BATCH)
    # family: (CLI flags, its input, K1 and K2 a run)
    families = {
        "CLIP-ViT-B/32": (("--extract_method", f"uni_{FRAMES}", "--attn", "flash"),
                          video("clip0.mp4", 60, 0), LAYERS, 0),
        "resnet50": (FAMILY_FLAGS["resnet50"], video("weights_resnet50.mp4", RESNET_BATCH, 7),
                     0, 0),
        "r21d_rgb": ((), video("weights_r21d_rgb.mp4", 16, 7), 0, 0),
        "vggish": ((), [wav], 0, 0),
        "pwc": (FAMILY_FLAGS["pwc"], video("weights_pwc.mp4", WEIGHTS_FLOW_FRAMES, 5), 0,
                len(CORR_LEVELS) * windows),
        "raft": (FAMILY_FLAGS["raft"], video("weights_raft.mp4", WEIGHTS_FLOW_FRAMES, 6,
                                             width=w_raft, height=h_raft), 0, 0),
        "i3d": (FAMILY_FLAGS["i3d"], video("i3d65.mp4", STACK + 1, 9), 0, len(CORR_LEVELS)),
    }
    print(f"weights: one input a family (PWC and RAFT {pairs} pairs, I3D one stack of {STACK}, "
          f"VGGish {WEIGHTS_WAV_SECONDS:g} s); cuDNN deterministic for the phase")

    def run(out, ft, flags, paths, *extra):
        reset_counts()
        cli.main(["--feature_type", ft, *flags, "--on_extraction", "save_numpy", "--strict",
                  "--output_path", os.path.join(root, out), "--tmp_path", tmp, *extra,
                  "--video_paths", *paths])
        torch.cuda.synchronize()
        k1, k2 = flash_attention.launches, local_correlation_kernel.launches
        launches["flash_attention"] += k1
        launches["local_correlation"] += k2
        return read_features(os.path.join(root, out)), k1, k2

    def held(got, want, label):
        """The largest difference over the largest magnitude, file by file."""
        if sorted(got) != sorted(want):
            raise AssertionError(f"weights {label}: files {sorted(got)}, want {sorted(want)}")
        errs = []
        for name, feats in got.items():
            if feats.shape != want[name].shape or not np.isfinite(feats).all():
                raise AssertionError(f"weights {label}: {name} {feats.shape}, want "
                                     f"{want[name].shape}, finite {np.isfinite(feats).all()}")
            errs.append(float(np.abs(feats - want[name]).max() / np.abs(want[name]).max()))
        return max(errs)

    def host_state(state):
        if isinstance(state, dict):
            return {kind: host_state(m) for kind, m in state.items()}
        return {k: v.detach().cpu().clone() for k, v in state.state_dict().items()}

    t_phase = time.perf_counter()
    table = []
    deterministic = torch.backends.cudnn.deterministic
    # PWC's transpose convolutions take a non-deterministic cuDNN algorithm:
    # two runs of one set of weights differed by 4.862e-07 of PWC's largest
    # flow, and 4.036e-05 of I3D's largest feature after the flow's uint8
    # levels; with deterministic algorithms two runs agree bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        for ft, (flags, paths, k1_want, k2_want) in families.items():
            tag = ft.replace("/", "-")
            ex = build_extractor(parse_args(["--feature_type", ft, *flags, "--video_paths",
                                             *paths]))
            # the random-init run, and its seeded weights as they reached the card
            with timed_builds(type(ex)) as built:
                ref, k1, k2 = run(f"weights_{tag}_random", ft, flags, paths,
                                  "--allow_random_init")
            (init_ms, state), = built
            if k1 != k1_want or k2 != k2_want:
                raise AssertionError(f"weights {ft} random init: K1 {k1}, K2 {k2}")
            seeded = host_state(state)
            del state, built

            t0 = time.perf_counter()
            files = {}
            if ft == "i3d":  # the reference names under one directory, as the JAX package's
                files["pt"] = os.path.join(wdir, "i3d_pt")
                os.makedirs(files["pt"], exist_ok=True)
                files["orbax"] = os.path.join(wdir, "i3d_orbax")
                os.makedirs(files["orbax"], exist_ok=True)
                for kind, sd in seeded.items():
                    torch.save(sd, os.path.join(files["pt"], WEIGHT_FILES[kind]))
                    save_orbax(converters("pwc" if kind == "pwc" else "i3d")[2](sd),
                               os.path.join(files["orbax"], WEIGHT_FILES[kind]))
            else:
                files["pt"] = os.path.join(wdir, f"{tag}.pt")
                torch.save({f"visual.{k}": v for k, v in seeded.items()} if ft.startswith("CLIP")
                           else seeded, files["pt"])
                tree = converters(ft)[2](seeded)
                files["msgpack"] = os.path.join(wdir, f"{tag}.msgpack")
                save_msgpack(tree, files["msgpack"])
                files["orbax"] = os.path.join(wdir, f"{tag}_orbax")
                save_orbax(tree, files["orbax"])
                del tree
            write_s = time.perf_counter() - t0

            row = {"family": ft, "random init": init_ms}
            for fmt, path in files.items():
                with timed_builds(type(ex)) as built:
                    got, k1, k2 = run(f"weights_{tag}_{fmt}", ft, flags, paths,
                                      "--weights_path", path)
                (load_ms, state), = built
                bad = state_mismatches(state, seeded)
                del state, built
                err = held(got, ref, f"{ft} from {fmt}")
                print(f"weights {ft} from {fmt} ({path.replace(root, '<root>')}): {len(got)} "
                      f"file(s) {[f.shape for f in got.values()]} against the random-init run "
                      f"{err:.3e} of the largest (tol {WEIGHTS_RTOL:g}); weights on the card "
                      f"{'equal to' if not bad else 'DIFFERENT from'} the seeded ones bit for "
                      f"bit; load {load_ms:.1f} ms; K1 {k1} (want {k1_want}), K2 {k2} "
                      f"(want {k2_want})")
                if bad or not err <= WEIGHTS_RTOL or k1 != k1_want or k2 != k2_want:
                    raise AssertionError(f"weights {ft} from {fmt}: err {err}, K1 {k1}, K2 {k2},"
                                         f" differing tensors {bad[:5]}")
                row[fmt] = load_ms
            # the host's read of each converted file alone, the rest of the
            # load being params_from_jax and the model's build on the card
            for fmt, read in (("msgpack", load_msgpack), ("orbax", load_orbax)):
                if fmt in files:
                    t0 = time.perf_counter()
                    for sub in ([os.path.join(files[fmt], WEIGHT_FILES[k]) for k in seeded]
                                if ft == "i3d" else [files[fmt]]):
                        read(sub)
                    row[f"{fmt} read"] = (time.perf_counter() - t0) * 1e3
            if ft == "i3d":
                print("weights i3d from msgpack: not a route, in either package: I3D looks up "
                      "only its reference file names under --weights_path")
            table.append((row, write_s))

        # CLIP's mesh, the card listed twice: from .msgpack against the
        # random-init mesh run (one batch split, so the same kernels)
        flags, paths = families["CLIP-ViT-B/32"][:2]
        mesh = ("--sharding", "mesh", "--device_ids", idx, idx)
        ref, k1, _ = run("weights_mesh_random", "CLIP-ViT-B/32", flags, paths,
                         "--allow_random_init", *mesh)
        for fmt in ("msgpack", "orbax"):
            path = os.path.join(wdir, "CLIP-ViT-B-32" + (".msgpack" if fmt == "msgpack"
                                                         else "_orbax"))
            got, k1, k2 = run(f"weights_mesh_{fmt}", "CLIP-ViT-B/32", flags, paths,
                              "--weights_path", path, *mesh)
            err = held(got, ref, f"CLIP mesh from {fmt}")
            print(f"weights CLIP-ViT-B/32 --sharding mesh --device_ids {idx} {idx} from {fmt}: "
                  f"against the random-init mesh run {err:.3e} of the largest (tol "
                  f"{WEIGHTS_RTOL:g}); K1 {k1} (want {LAYERS * 2}), K2 {k2}")
            if not err <= WEIGHTS_RTOL or k1 != LAYERS * 2 or k2:
                raise AssertionError(f"weights CLIP mesh from {fmt}: err {err}, K1 {k1}, K2 {k2}")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    print(f"weights, ms from --weights_path to a model on the card (the host's read of the "
          f"file alone in brackets; random init beside it) [{card}]:")
    for row, write_s in table:
        cells = ", ".join(
            (f"{fmt} {row[fmt]:.1f}" + (f" (read {row[fmt + ' read']:.1f})"
                                        if fmt + " read" in row else ""))
            if fmt in row else f"{fmt} not a route" for fmt in ("pt", "msgpack", "orbax"))
        print(f"  {row['family']}: {cells}; random init {row['random init']:.1f} (files "
              f"written in {write_s:.1f} s)")
    print(f"weights: phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def sync_witness(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and
    return ``{(path, line, function): count}`` of the innermost frame in
    the port of every synchronization it reported (a sync with no port
    frame is keyed ``None``)."""
    import traceback
    import warnings

    sites: dict = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return  # e.g. the mode's own "prototype feature" notice
        port = [f for f in traceback.extract_stack()[:-1]
                if f"{os.sep}video_features_tpu_torch{os.sep}" in f.filename]
        key = (port[-1].filename, port[-1].lineno, port[-1].name) if port else None
        sites[key] = sites.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def run_lint_path(root: str, device):
    """Phase 25; returns K1's and K2's launches in its runs."""
    t_phase = time.perf_counter()
    # the sweep (one host core, ~10 s) runs beside the witness below
    sweep = subprocess.Popen([sys.executable, "-m", "video_features_tpu_torch.analysis"],
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        launches = _witness_paths(root, device)
        out, err = sweep.communicate(timeout=300)
    finally:
        if sweep.poll() is None:
            sweep.kill()
            sweep.wait()
    sweep_s = time.perf_counter() - t_phase
    last = (out.strip().splitlines() or ["(no output)"])[-1]
    print(f"graftcheck over video_features_tpu_torch/ on the card host: exit "
          f"{sweep.returncode}, done {sweep_s:.1f} s into the phase, {os.cpu_count()} "
          f"cores: {last}")
    if sweep.returncode != 0:
        raise AssertionError(f"graftcheck exit {sweep.returncode}:\n{out[-4000:]}"
                             f"{err[-2000:]}")
    print(f"lint: phase wall {time.perf_counter() - t_phase:.1f} s [{card_line()}]")
    return launches


def _witness_paths(root: str, device):
    """Phase 25's witness: a warm CLIP group and a warm I3D + PWC stack
    under the sync debug mode, each sync judged by the lint; then a
    deliberate one. Returns K1's and K2's launches."""
    from video_features_tpu_torch.analysis.hostsync import sync_site_verdict
    from video_features_tpu_torch.config import ExtractionConfig
    from video_features_tpu_torch.extract.registry import build_extractor
    from video_features_tpu_torch.ops import preprocess
    from video_features_tpu_torch.ops.correlation_kernel import local_correlation_kernel
    from video_features_tpu_torch.ops.flash_attention import flash_attention

    clips = synth_clips(root)
    clip65 = os.path.join(root, "i3d65.mp4")  # phase 5's
    clip_ex = build_extractor(ExtractionConfig(
        feature_type="CLIP-ViT-B/32", video_paths=clips, extract_method=f"uni_{FRAMES}",
        attn="flash", allow_random_init=True, video_batch=N_VIDEOS, decode_workers=2),
        external_call=True)
    i3d_ex = build_extractor(ExtractionConfig(
        feature_type="i3d", flow_type="pwc", video_paths=[clip65], allow_random_init=True),
        external_call=True)
    # the group's 4 videos fuse into one forward: K1 once a layer
    runs = [("a warm CLIP group", clip_ex, LAYERS, 0),
            ("a warm I3D + PWC stack", i3d_ex, 0, len(CORR_LEVELS))]
    reset_counts()
    verdicts = {}
    for label, ex, k1_want, k2_want in runs:
        ex(device=device)  # warm: models, cuDNN plans, taps, allocator
        k1, k2 = flash_attention.launches, local_correlation_kernel.launches
        t0 = time.perf_counter()
        sites = sync_witness(lambda ex=ex: ex(device=device))
        wall = time.perf_counter() - t0
        k1, k2 = flash_attention.launches - k1, local_correlation_kernel.launches - k2
        if (k1, k2) != (k1_want, k2_want):
            raise AssertionError(f"{label}: K1 {k1} (want {k1_want}), K2 {k2} "
                                 f"(want {k2_want})")
        judged = {key: (n, "outside the port" if key is None
                        else sync_site_verdict(key[0], key[1]))
                  for key, n in sites.items()}
        verdicts[label] = judged
        print(f"sync witness, {label} under set_sync_debug_mode('warn'): {wall:.2f} s, "
              f"K1 {k1}, K2 {k2}, {sum(sites.values())} synchronization(s) reported"
              + "".join(f"\n  {n} x {_site(key)}: {verdict}"
                        for key, (n, verdict) in sorted(judged.items(), key=str)))
    bad = [(label, key) for label, judged in verdicts.items()
           for key, (_, verdict) in judged.items() if verdict == "unaccounted"]
    if bad:
        raise AssertionError(f"syncs in hot functions GC10x neither allowlists nor "
                             f"waives: {bad}")

    # the witness's own check: a waived upload, called past its cache
    sites = sync_witness(lambda: preprocess._channel_stats.__wrapped__(
        (0.5,), (0.25,), device))
    judged = {key: sync_site_verdict(key[0], key[1]) for key in sites if key}
    print(f"sync witness, ops/preprocess.py::_channel_stats uncached: "
          + ", ".join(f"{n} x {_site(key)}: {judged.get(key, 'outside the port')}"
                      for key, n in sorted(sites.items(), key=str)))
    if not judged or set(judged.values()) != {"waived"}:
        raise AssertionError(f"the witness saw no waived sync in _channel_stats: {sites}")
    return {"flash_attention": flash_attention.launches,
            "local_correlation": local_correlation_kernel.launches}


def _site(key) -> str:
    if key is None:
        return "no frame of the port"
    path, line, name = key
    return f"{os.path.relpath(path, os.path.dirname(os.path.abspath(__file__)))}:{line} {name}"


def _preempt_events(out: str) -> list:
    """The daemon manifests' (event, feature type, beneficiary) rows of
    preemption, rollback and re-warm, in order."""
    from video_features_tpu_torch.runtime.faults import iter_manifest_records
    from video_features_tpu_torch.serve.lifecycle import requests_root

    rows = [r for r in iter_manifest_records(requests_root(out))
            if r.get("event") in ("preempted", "preemption_rollback", "rewarmed")]
    return [(r["event"], r.get("feature_type"), r.get("beneficiary")) for r in rows]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from video_features_tpu_torch.devices import pin_fp32
    from video_features_tpu_torch.ops import kernels

    print(card_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    pin_fp32()
    device = torch.device("cuda", torch.cuda.current_device())

    t0 = time.perf_counter()
    built = kernels.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")

    k1, k1_bf16 = check_flash_attention(device)
    k2 = check_local_correlation(device)
    fused_shapes = hold_fused_shapes(device)
    mesh_shapes = hold_mesh_shapes(device)
    mesh_correlation = hold_mesh_correlation(device)
    measure_resample(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        # phase 24 first, while this process holds almost none of the
        # card: later phases leave tens of GiB in the caching allocator,
        # pinned by small live tensors, which its 0 gate cannot afford
        phases = [
            ("multi-process mesh", lambda: run_multiprocess_path(root, device)),
            ("CLIP", lambda: run_main_path(root)),
            ("I3D + PWC", lambda: run_i3d_path(root, device)),
            ("PWC", lambda: run_pwc_path(root)),
            ("I3D + RAFT", lambda: run_i3d_raft_path(root, device)),
            ("RAFT", lambda: run_raft_path(root, device)),
            ("ResNet-50", lambda: run_cnn_path(
                root, device, "resnet50", RESNET_CLIP_FRAMES, (RESNET_CLIP_FRAMES, 2048),
                RESNET_BATCH)),
            ("R(2+1)D-18", lambda: run_cnn_path(
                root, device, "r21d_rgb", R21D_CLIP_FRAMES, (R21D_CLIP_FRAMES // 16, 512))),
            ("VGGish", lambda: run_vggish_path(root, device)),
            ("run contract", lambda: run_contract_path(root, device)),
            ("async ingest", lambda: run_ingest_path(root, device)),
            ("device preprocess", lambda: run_device_path(root, device)),
            ("telemetry and preflight", lambda: run_telemetry_path(root, device)),
            ("bfloat16", lambda: run_bf16_path(root, device)),
            ("serve", lambda: run_serve_path(root, device)),
            ("disk flow and output flags", lambda: run_flags_path(root, device)),
            ("preemption", lambda: run_preempt_path(root, device)),
            ("native host path", lambda: run_native_path(root, device)),
            ("parallel", lambda: run_parallel_path(root, device)),
            ("mesh", lambda: run_mesh_path(root, device)),
            ("converted weights", lambda: run_weights_path(root, device)),
            ("lint", lambda: run_lint_path(root, device)),
        ]
        results = {}
        for name, phase in phases:
            t0 = time.perf_counter()
            results[name] = phase()
            free, total = torch.cuda.mem_get_info(device)
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s; then this process holds "
                  f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated, "
                  f"{torch.cuda.memory_reserved(device) / 2**30:.2f} GiB reserved; the card "
                  f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
        # each kernel's launches: its main path's run, then those of every
        # later phase that drives it
        later_names = ("async ingest", "device preprocess", "telemetry and preflight",
                       "bfloat16", "serve", "disk flow and output flags", "preemption",
                       "native host path", "parallel", "mesh", "converted weights",
                       "multi-process mesh", "lint")
        later = [results[n] for n in later_names]
        k1_launches = results["CLIP"] + sum(r["flash_attention"] for r in later)
        k2_launches = results["I3D + PWC"] + sum(r["local_correlation"] for r in later)
        print("launches by phase: K1 " + ", ".join(
            [f"CLIP {results['CLIP']}"]
            + [f"{n} {results[n]['flash_attention']}" for n in later_names])
            + "; K2 " + ", ".join(
            [f"I3D + PWC {results['I3D + PWC']}"]
            + [f"{n} {results[n]['local_correlation']}" for n in later_names]))

    records = [
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "video_features_tpu_torch/csrc/flash_attention.cu",
            "replaces": "video_features_tpu/ops/pallas/flash_attention.py:36",
            "launches": k1_launches,
            **k1,
            "fused_shapes": fused_shapes["flash_attention"],
            "mesh_shapes": mesh_shapes,
            "bf16_main_path": k1_bf16,
        },
        {
            "name": "local_correlation",
            "route": "cuda",
            "source": "video_features_tpu_torch/csrc/local_correlation.cu",
            "replaces": "video_features_tpu/ops/pallas/correlation_kernel.py:39",
            "launches": k2_launches,
            **k2,
            "fused_shapes": fused_shapes["local_correlation"],
            "mesh_shapes": mesh_correlation,
        },
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        sys.exit(1)
