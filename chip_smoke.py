#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and ``nvcc`` (under
``$CUDA_HOME`` or on ``PATH``).  Phases, each of which must pass:

1. build — compiles ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a, one
   ``nvcc`` per source in parallel, into ``src/repro_torch/kernels/_build``;
   prints what ``-Xptxas -v`` logged for K10's two libraries (registers,
   spills), the wgmma kernel's dynamic shared memory at each head size and,
   where ``cuobjdump`` is in the toolkit, the ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions in its SASS, both of which must be
   there;
2. kernels — holds each kernel (K1 TopK threshold, K2 TopK mask, K3 l2
   norm, K4 Q_r rounding, K5 slot compaction, K6 coded slot compaction,
   K7 fused Q_r pack, K8 code pack, K9 code unpack) against its plain
   PyTorch version on the card, at the main path's shapes, edge cases and
   one large shape: all bit-equal except K3, which must be within
   ``NORM_RTOL``; K9 must invert K8 (K8 on b = 1..32, codes with bits
   above b, rows 1-3 codes off a 16-byte boundary).  K1's cases also take
   rows shorter than a cluster's CTAs, n not a multiple of 4, per-row k of
   0, 1, n-1, n and beyond n, +-0 / subnormals / inf / ties, and rows at
   and just past
   its clusters' shared-memory capacity; ``threshold_mask`` (K1 and K2 in
   one launch) must give K1's and K2's plain outputs on every one of them.
   K4 and K7 are held by both entries: reading u, and drawing u itself
   with threefry (key words at and above 2^31, n = 1, n = 2^24 + 3, 40
   rows) against ``prng.uniform`` + the plain version.  K9 by both
   entries: the codes, and the codes decoded to Q_r values against the
   plain chain (``ref.qr_values`` of K9's plain version), with a sign over
   level 0 heading every row (-0.0) and zero- and NaN-norm rows (+0.0).
   K5's and K6's cases also
   put cap inside their second and last tile, at 0 and above nnz, past an
   all-tie row, on a zero row, n = 50177 and 74 tiles a row, each called
   twice (the second call reuses the tagged workspace).
   ``torch.profiler`` must see one device operation a K1, a keyed K4, a
   K5, a K6, a keyed K7, a K9 (either entry) and a ``threshold_mask`` call
   (two past the shared-memory capacity, where it takes K1 then K2) and
   two an ``ops.quantize_qr`` (K3, K4) and an ``ops.quantize_pack`` (K3,
   K7).  Then times kernel, plain version and the library yardstick
   (K1 and K3 also by their device time a call; K2 as the fused launch,
   beside K1 then K2 and K2 alone, in turns; K4's keyed entry, its memory
   entry and the whole ``ops.quantize_qr`` against the chain it replaced,
   in turns, with the keyed bound's bytes and integer terms, the latter
   from the uniform's own operations, the SASS's count beside it; K7's
   keyed entry, its memory entry and the whole ``ops.quantize_pack``
   against the chain it replaced, in turns, likewise; K9's values entry,
   its codes entry and the chain the values entry replaced, in turns; the
   keyed K7 and both K9 entries also by their device time a call);
3. train — drives the quickstart configuration (MLP 784-64-64-10, 20
   Dirichlet(0.7) clients, 5 per round, batch 32, gamma = 0.1, p = 0.1)
   through ``server.run_federated`` on the card, FedComLoc-Com with
   ``TopK(0.3)``, ``QuantQr(8)``, ``Compose(TopK(0.25), QuantQr(4))``
   (Figure 16's k25_q4), ``Compose(TopK(0.5), QuantQr(16))`` (k50_q16),
   ``Int8Sync()``, ``TopK(0.1)`` with error feedback and server momentum
   0.6, and ``QuantQr(8)`` with geometric local phases, each on the
   account and on the packed wire; every launch counter is set to 0 just
   before a run and read just after, and each must equal the count the
   batching implies (K1 and K2 run as one launch, ``topk_threshold_mask``,
   on every TopK leaf but the packed ``topk`` codec's, which launches K1
   and K5; the account Q_r runs launch the keyed K4, the packed QuantQr
   runs K3, the keyed K7 and K9's values entry, the packed Compose runs
   K9's values entry; the runs with a keyed entry make no bulk
   ``prng.uniform`` draw, and with fixed local phases no call at all).
   The packed runs must ship the payload bytes the
   wire format implies, and reproduce the account runs' uplink bits
   exactly and their parameters within ``PARAM_RTOL``/``PARAM_ATOL``.
   For Compose a further packed run holds, in every round, the server's
   decode against the account transform of the same uplink: equal except
   where the wire saturates a code or drops a tie beyond the cap, as its
   format says.  Where either happened (and in k25_q4, which diverges at
   this configuration in the JAX package as well: loss above 1 by round
   5, NaN by round 15), the two runs part, and the rounds through which
   they agree are printed instead of held.  Every run but k25_q4 must
   train (finite losses, best accuracy above 0.2).  Then times
   steady-state rounds (wall clock, and device busy time under
   ``torch.profiler``, whose idle share is given against both the plain
   and the profiled wall clock, with the device operations and
   ``cudaLaunchKernel`` calls a round) and replays the first rounds of the TopK,
   QuantQr, packed k25_q4 and EF runs on the CPU through the plain
   versions (k25_q4's first ``DIVERGING_REPLAY_ROUNDS``, while its loss is
   finite): cohorts, steps, bits and payload bytes must be equal, the
   train loss within ``LOSS_RTOL``;
4. fig9 — the paper's Figure 9 (``benchmarks/fig9_baselines.py``) on the
   card at the CNN's full width (``CNN(3, 10, 32)``, 62 006 parameters in
   10 leaves): ``make_cifar_like(6000, 1000, seed=1)``, Dirichlet(0.7)
   over 10 clients, 5 a round, batch 32 (``benchmarks/common.py``'s
   ``cifar_setup``, rebuilt from the port's modules), ``FIG9_ROUNDS``
   rounds through ``server.run_federated`` of FedAvg, sparseFedAvg
   (TopK(0.1)), Scaffold, FedDyn (gamma = 0.1, 10 local steps),
   FedComLoc-Com with TopK(0.1) and Scaffnew (gamma = 0.05, p = 0.1), each
   on the account and the packed wire.  The counters are set to 0 just
   before each run and read just after: the two TopK runs launch K1 + K2
   as one launch (``topk_threshold_mask``) a leaf a round on the account
   wire and K1 and K5 a leaf a round on the packed wire, 120 each; the
   dense runs launch nothing.  Every run must train (finite losses, the
   last round's train loss below the first's) but Scaffold, which goes to
   NaN in the JAX package as well (``FIG9_DIVERGING``: only its finite
   rounds are held).  The packed run must give the account run's uplink
   and total bits exactly and its parameters within
   ``PARAM_RTOL``/``PARAM_ATOL``.  Prints best accuracy, total and uplink
   Mbit, and the steady rounds' ms, device busy ms, idle share and device
   operations a round (``profile_rounds``); then replays the first
   ``REPLAY_ROUNDS`` rounds (Scaffold's finite ones) of sparseFedAvg,
   Scaffold and FedComLoc on the CPU: cohorts, steps and bits equal, train
   loss within ``LOSS_RTOL``;
5. hetero — the same setup on ``ClientProfile.lognormal(10, speed_sigma=1,
   bandwidth_sigma=0.7, seed=0)`` with ``bit_cost=1e-7``, ``HETERO_S`` = 4
   clients a round (``async_buffered(2, ...)`` needs a capacity that
   divides it): FedComLoc TopK(0.1), FedAvg and Scaffold under ``sync``,
   ``semi_sync(3)`` and ``async_buffered(2, 0.5)``, then FedComLoc under
   ``sync`` with ``deadline=10.0, drop_stragglers=True`` (slow clients'
   steps truncated) and Scaffold under ``semi_sync(3)`` with
   ``deadline=3.0`` (the slowest client drops).  Each round:
   ``clients_aggregated`` is 3 under ``semi_sync(3)`` unless fewer
   participate, every participant under ``sync``; staleness levels are
   ``rank // 2`` in stable finish order under ``async_buffered``; a
   dropped client sends 0 bits and finishes exactly at the deadline.  The
   FedComLoc runs launch K1 + K2 as one launch a leaf a round, the rest
   nothing.  Then ``REPLAY_ROUNDS`` rounds of each run on the CPU:
   counting metrics equal, ``sim_time`` and ``client_finish`` within
   ``CLOCK_RTOL``, train loss within ``LOSS_RTOL``;
6. scans — holds K11 (RG-LRU) and K12 (WKV6) against their plain versions
   at the serving shapes (8, 2560, 2560) and (8, 40, 2560, 64), T = 1,
   odd T, B = 1, decays near 0 and 1 and zeros; K11 must be bit-equal,
   also at D = 2579, 2562 and 40 (not a multiple of a block's channels,
   D % 4 != 0), T not a multiple of its 32- or 8-step batches, B*D of
   three warps, on both instances, and with odd D or views 4 bytes off
   where the channel-pair instance would run.
   K12's float32 route (the sequential kernel) must give S_T bit-equal
   and y within ``WKV6_YTOL`` of max |y|.  Its bf16 route (the chunked
   tensor-core scan, on the layout prefill launches it on: bf16
   ``rwkv6._heads`` views of (B, T, 2560) activations) at main, T = 1, 63,
   64, 65 and 77 and with w = 1e-7 and 1 - 1e-7 held over whole 2560-step
   heads must be within ``WKV6_BF16_ATOL`` + ``WKV6_BF16_RTOL`` |plain|
   (y: plus one bf16 ulp) of the plain version run in float64.  Times both
   scans at the serving and a larger shape (K12's bf16 route on the
   prefill layout, its float32 route at main);
7. serve — ``rwkv6-3b`` and ``recurrentgemma-2b`` at their published
   width and depth in bf16, weights from the port's own init on the card,
   through ``launch/serve.py``'s :func:`serve`: batch 8, prompt 2560
   (above recurrentgemma's window of 2048, so the ring cache runs), 32
   greedy decode steps.  The launch counters are set to 0 just before and
   read just after: one prefill launches K12 32 times (rwkv) or K11 18
   times (recurrentgemma), and the decode steps launch neither.  Logits
   must be finite, and prefill(T) + one decode step must agree with
   prefill(T + 1)'s last logits within ``GAP_REL`` of max |logits|.
   After a warm-up at the serving shape, prints the median of
   ``SERVE_TIMED`` prefills' ms and of the per-step decode ms, tokens/s,
   the counted run's own times, peak memory (weights
   and serve, above what earlier phases hold), and the device's busy time
   and idle share under ``torch.profiler`` for one prefill and for 8
   decode steps;
8. dense serve — ``qwen2-7b``, ``gemma2-9b`` and ``gemma3-4b`` the same
   way at batch 4, prompt 4608 (above gemma2's window of 4096 and
   gemma3's 1024: the ring branch of prefill and the ring decode run on
   their swa layers), each freed before the next.  Their prefill attends
   through ``chunked_attention``, as the JAX package's models do, so the
   counted run launches no kernel (K10 included).  The warm-up prefill
   hands over the q/k/v of the layers in ``ATTN_CAPTURE``;
9. attention — K10 (``ops.mha_attention``: bf16 on the wgmma kernel fed
   by TMA, float32 on the SIMT kernel) against its plain version
   ``ref.mha_attention`` in float32 and bf16 within ``ATTN_F32_TOL`` /
   ``ATTN_BF16_TOL`` (the JAX tests' tolerances, compared in the working
   type; the gap in bf16 ulps is printed): the JAX package's flash cases
   (five option sets, three GQA shapes, a decode offset), every head size
   32-256 at groups 1, 2, 4, 7 and 8, a ragged T = 1000 and a decode at
   Tk = 4641.  Then the main path: the counters set to 0, one
   ``ops.mha_attention`` on each captured q/k/v (5 launches), read; each
   output held against the plain version and against the models' own
   ``chunked_attention`` on the same q/k/v.  Times K10, the plain version,
   the models' ``chunked_attention`` and, where one PyTorch call computes
   the same function, SDPA (causal with GQA, or a boolean window mask;
   none with a softcap) at each served shape ("main": gemma2-9b's attn
   layer) and at ``ATTN_LARGE``, beside the bound; then, from the served
   layers' times and each dense model's layer pattern, what its prefill
   would save if it called K10 instead of ``chunked_attention`` (the route
   stays as the JAX models have it);
10. CUDA against CPU — the five models at full width and reduced depth
   (``CPU_CHECK_LAYERS``: one block pattern each, gemma3's 6 layers
   included), float32 with TF32 off, batch 2, prompt 128, 4 decode steps,
   the same weights on the card and on the CPU: logits within
   ``CPU_LOGIT_TOL`` and greedy tokens equal.

Prints the card's name and power limit, one line per kernel and shape, a
``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
NORM_RTOL = 1e-5               # K3 vs torch.sum: float32 sums in other orders
LOSS_RTOL = 1e-4               # cuBLAS vs CPU matmuls in the replayed rounds
PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-7   # packed vs account rounds on the card
ROUNDS = 20
REPLAY_ROUNDS = 3
DIVERGING_REPLAY_ROUNDS = 6
PROFILE_ROUNDS = 5
FIG9_ROUNDS = 12              # benchmarks/common.py FAST_ROUNDS
# async_buffered(2, 0.5) needs a capacity that divides clients_per_round,
# so the hetero phase samples 4 of its 10 clients a round (Figure 9: 5)
HETERO_S = 4
CLOCK_RTOL = 1e-6              # sim_time, client_finish: tests/test_golden.py
# Scaffold at Figure 9's gamma = 0.1 and 10 local steps diverges in the JAX
# package as well (on the CPU: loss 7.40, 7.94, then NaN from round 3)
FIG9_DIVERGING = ("scaffold",)
FUSED_K1_K2 = "topk_threshold_mask"   # the launch counter of K1 + K2 fused
KEYED_K7 = "quantize_pack_keyed"       # ... of K7 drawing its uniforms
VALUES_K9 = "unpack_qr_values"         # ... of K9 decoding to Q_r values
LARGE = (4, 1 << 24)
# K12's y and S_T against the plain version, float32: |d| <= WKV6_YTOL *
# max |plain| (64-term sums of y run in another order than the einsum)
WKV6_YTOL = 1e-5
# K12's bf16 (chunked, tensor-core) route, elementwise: |d| <= ATOL + RTOL
# * |plain| (y: plus one bf16 ulp of plain, its own rounding), the JAX
# package's tolerance for this kernel (tests/test_kernels.py: Pallas
# against the oracle).  "plain" is the plain version run in float64: with w
# near 1 over 2560 steps the float32 plain version's own rounding reaches
# past 3e-4 (about 6e-4 in y at 1024 steps on the CPU), while the chunked
# route's products (3xTF32 for R~ S, bf16 hi + lo against bf16 v) stay
# near 2^-21 and 2^-16 a product
WKV6_BF16_RTOL = WKV6_BF16_ATOL = 3e-4
SCAN_MAIN = {"K11": (8, 2560, 2560), "K12": (8, 40, 2560, 64)}
SCAN_LARGE = {"K11": (32, 4096, 2560), "K12": (32, 40, 4096, 64)}
SERVE_GEN = 32
SERVE_PROFILE_STEPS = 8
SERVE_TIMED = 3               # warm prefills timed for the median
# arch -> (batch, prompt, launches of one prefill at full depth):
# rwkv6-3b's 32 rwkv layers run K12, recurrentgemma-2b's 18 rglru layers
# (26 layers, pattern rglru rglru swa) run K11; the dense models' prefill
# attends through chunked_attention, as the JAX package's does, and
# launches nothing.  Prompt 2560 is above recurrentgemma's window of 2048,
# 4608 above gemma2's 4096 (and gemma3's 1024): the ring caches run.
SERVE_SHAPES = {"rwkv6-3b": (8, 2560, {"wkv6_scan": 32}),
                "recurrentgemma-2b": (8, 2560, {"rglru_scan": 18})}
DENSE_SHAPES = {arch: (4, 4608, {})
                for arch in ("qwen2-7b", "gemma2-9b", "gemma3-4b")}
# K10 against its plain version, compared in the working type: the JAX
# package's own tolerances (tests/test_kernels.py:163 and :202)
ATTN_F32_TOL, ATTN_BF16_TOL = 2e-5, 2e-2
BF16_OPS_PER_S = 989.4e12     # H100 SXM dense bf16 tensor cores
# (arch, layer) whose prefill q/k/v K10 runs on: gemma2-9b's swa (window
# 4096, softcap 50) and attn (cap 8192) layers, qwen2-7b's first layer,
# gemma3-4b's swa (window 1024) and attn (cap 8192) layers; "main" is
# gemma2-9b's attn layer, (4, 16, 4608, 256) with 8 KV heads
ATTN_CAPTURE = (("gemma2-9b", 0), ("gemma2-9b", 1), ("qwen2-7b", 0),
                ("gemma3-4b", 0), ("gemma3-4b", 5))
ATTN_MAIN = ("gemma2-9b", 1)
ATTN_LARGE = (1, 16, 8, 16384, 16384, 256)   # B, Hq, Hkv, Tq, Tk, Dh; bf16
# bf16 prefill(T) + one decode step against prefill(T + 1), full width:
# max |d| <= GAP_REL * max |logits| (bf16 activations and caches, other
# matmul shapes on the two routes)
GAP_REL = 0.05
# CUDA against CPU, float32, full width, reduced depth: |d| <= CPU_LOGIT_TOL
# * (1 + |cpu|) (cuBLAS against CPU sums at d = 2560, and bf16 KV-cache
# entries that round the other way)
CPU_LOGIT_TOL = 1e-3
CPU_CHECK_LAYERS = {"rwkv6-3b": 2, "recurrentgemma-2b": 3, "qwen2-7b": 2,
                    "gemma2-9b": 2, "gemma3-4b": 6}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, ops: float, peak: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_rounds(torch, prng, alg, params0, label: str) -> dict:
    """Steady-state rounds (no eval): host wall per round, then the same
    rounds under ``torch.profiler`` for the device's busy time per round,
    its idle share and the device ops that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    def rounds(state, key, n):
        for _ in range(n):
            key, sub = prng.split(key, 2)
            state, _ = alg.round(state, sub)
        torch.cuda.synchronize()
        return state, key

    state, key = rounds(alg.init(params0), prng.PRNGKey(2), 3)   # warm up
    t0 = time.time()
    state, key = rounds(state, key, PROFILE_ROUNDS)
    wall_ms = (time.time() - t0) / PROFILE_ROUNDS * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        rounds(state, key, PROFILE_ROUNDS)
        prof_wall_ms = (time.time() - t0) / PROFILE_ROUNDS * 1e3
    dev_ms = device_ms_by_name(prof)
    dev_ops, launch_calls = round_op_counts(prof)
    print(f"[profile] {label}: steady ms/round {wall_ms!r} (under the "
          f"profiler {prof_wall_ms!r}); {dev_ops / PROFILE_ROUNDS!r} device "
          f"operations and {launch_calls / PROFILE_ROUNDS!r} cudaLaunchKernel "
          f"calls a round", flush=True)
    out = {"wall_ms": wall_ms, "prof_wall_ms": prof_wall_ms, "busy_ms": None,
           "device_ops": dev_ops / PROFILE_ROUNDS,
           "launch_calls": launch_calls / PROFILE_ROUNDS}
    if not dev_ms:
        print(f"[profile] {label}: the profiler recorded no device events; "
              f"device busy time not measured", flush=True)
        return out
    busy_ms = sum(dev_ms.values()) / PROFILE_ROUNDS
    out["busy_ms"] = busy_ms
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] {label}: device busy ms/round {busy_ms!r}, idle share "
          f"{1.0 - busy_ms / wall_ms!r} of the steady round (under the "
          f"profiler {1.0 - busy_ms / prof_wall_ms!r}), {len(dev_ms)} device "
          f"op names; "
          f"top (ms/round): " + "; ".join(
              f"{name[:70]} {ms / PROFILE_ROUNDS!r}" for name, ms in top),
          flush=True)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    print(f"[profile] {label}: host self time (ms/round, calls/round): "
          + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / PROFILE_ROUNDS / 1e3!r}"
                      f" {e.count / PROFILE_ROUNDS!r}" for e in host), flush=True)
    return out


def interleaved_rounds(torch, prng, algs: dict, params0, label: str) -> None:
    """Steady ms/round of two algorithms in turns (A B B A, twice), so
    that host drift falls on both alike.  Every window runs the same 5
    rounds from the state after 3 warm-up rounds."""
    order = list(algs) + list(algs)[::-1]
    states = {}
    for name, alg in algs.items():
        key = prng.PRNGKey(2)
        state = alg.init(params0)
        for _ in range(3):                                  # warm up
            key, sub = prng.split(key, 2)
            state, _ = alg.round(state, sub)
        states[name] = (state, key)
    times = {name: [] for name in algs}
    for name in order * 2:
        alg = algs[name]
        state, key = states[name]
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(PROFILE_ROUNDS):
            key, sub = prng.split(key, 2)
            state, _ = alg.round(state, sub)
        torch.cuda.synchronize()
        times[name].append((time.time() - t0) / PROFILE_ROUNDS * 1e3)
    print(f"[profile] {label} interleaved steady ms/round over windows of "
          f"{PROFILE_ROUNDS}: " + "; ".join(
              f"{name} {ts!r} (median {statistics.median(ts)!r})"
              for name, ts in times.items()), flush=True)


class KernelRecord:
    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.max_abs_err = 0.0
        self.timings = {}

    def err(self, a, b) -> None:
        d = (a.double() - b.double()).abs()
        self.max_abs_err = max(self.max_abs_err, float(d.max()) if d.numel() else 0.0)


def device_ms_by_name(prof) -> dict:
    """The device-side events' durations (kernels, copies, memsets) in a
    ``torch.profiler`` run, summed by name, in ms."""
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out


def round_op_counts(prof) -> tuple:
    """(device operations, host ``cudaLaunchKernel*`` calls) in a
    ``torch.profiler`` run: the device's kernels, copies and memsets, and
    the runtime calls that launched kernels."""
    from torch.autograd import DeviceType
    dev_ops = launch_calls = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            dev_ops += 1
        elif ev.name.startswith("cudaLaunchKernel"):
            launch_calls += 1
    return dev_ops, launch_calls


def device_per_call(torch, fn, calls: int, windows: int = 3):
    """(device ms, device operations) a call of ``fn`` takes: its kernels,
    copies and memsets from ``torch.profiler``; (None, None) where the
    profiler recorded no device event.  The profiler can drop a device
    record, never add one, so of ``windows`` windows of ``calls`` calls the
    one with the most device events is kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (None, None)
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
        if evs and (best[1] is None or len(evs) / calls > best[1]):
            best = (sum(ev.time_range.elapsed_us() for ev in evs) / 1e3
                    / calls, len(evs) / calls)
    return best


def bf16_ulp(torch, y):
    """One bf16 ulp of each value of y."""
    _, e = torch.frexp(y.float())
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 8)


def check_scan_kernels(torch, dev, recs) -> None:
    """Phase 6: K11 and K12 against their plain versions, then timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6
    from repro_torch.models import rwkv6

    gen = torch.Generator(device=dev).manual_seed(14)

    def same_bits(a, b):
        return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    def rglru_inputs(b, t, d, off=0):
        """off > 0: contiguous views ``off`` floats past an allocation's
        start (not 8-byte aligned at odd off)."""
        n = b * t * d
        x = torch.randn(n + off, generator=gen, device=dev)[off:]
        a = torch.rand(n + off, generator=gen, device=dev)[off:]
        return x.view(b, t, d), a.view(b, t, d)

    b, t, d = SCAN_MAIN["K11"]
    edge = rglru_inputs(2, 333, d)
    edge[1][0, :, :64] = 1e-7                    # a near 0
    edge[1][0, :, 64:128] = 1.0 - 1e-7           # a near 1
    edge[1][1, :, :8] = 1.0                      # 1 - a^2 == 0
    edge[0][1, :, 8:64] = 0.0                    # zeros
    # the slab kernel's edges: D not a multiple of a block's channels and
    # D % 4 != 0, T not a multiple of its 32- or 8-step batches, fewer
    # warps than one wave (B*D = 96: three), both instances (a channel a
    # lane, 32 steps: main; channel pairs, 8 steps: past 12 warps an SM,
    # the large shape), and an odd D or an unaligned view there, which
    # takes a channel a lane
    rg_cases = [("main", *rglru_inputs(b, t, d)),
                ("T=1", *rglru_inputs(b, 1, d)),
                ("T=37", *rglru_inputs(b, 37, d)),
                ("B=1", *rglru_inputs(1, t, d)),
                ("edges", *edge),
                ("D=2579 T=2565", *rglru_inputs(2, 2565, 2579)),
                ("D=40 T=47", *rglru_inputs(3, 47, 40)),
                ("B=1 D=96 T=333", *rglru_inputs(1, 333, 96)),
                ("B=32 T=81 (channel pairs)", *rglru_inputs(32, 81, d)),
                ("B=32 D=2562 T=19 (channel pairs)",
                 *rglru_inputs(32, 19, 2562)),
                ("B=32 D=2579 T=9", *rglru_inputs(32, 9, 2579)),
                ("B=32 T=19, views 4 bytes off",
                 *rglru_inputs(32, 19, d, off=1))]
    for label, x, a in rg_cases:
        y, h = rg.rglru_scan(x, a)
        y_r, h_r = ref.rglru_scan(x, a)
        torch.cuda.synchronize()
        if not (same_bits(y, y_r) and same_bits(h, h_r)):
            raise AssertionError(f"K11 {label}: kernel differs from the "
                                 f"plain version")
        recs["K11"].err(y, y_r)
        recs["K11"].err(h, h_r)
    print(f"[scans] K11 bit-equal to the plain version on {len(rg_cases)} "
          f"cases (D % 32 != 0, D % 4 != 0, ragged T, B*D under a wave, "
          f"both instances, odd D and unaligned views past 12 warps an SM)",
          flush=True)
    del rg_cases, edge

    def wkv6_inputs(b, h, t, dtype, heads=False):
        """heads=True: r/k/v/w are ``rwkv6._heads`` views of (B, T, H*64)
        activations, the layout prefill launches K12 on."""
        shape = (b, t, h * 64) if heads else (b, h, t, 64)
        r, k, v = (0.5 * torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
        w = torch.rand(shape, generator=gen, device=dev)
        u = 0.1 * torch.randn((h, 64), generator=gen, device=dev)
        r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
        if heads:
            r, k, v, w = (rwkv6._heads(z, 64) for z in (r, k, v, w))
        return r, k, v, w, u

    b, h, t, _ = SCAN_MAIN["K12"]
    # float32: the sequential kernel, S_T bit-equal, y within WKV6_YTOL
    edge = wkv6_inputs(2, 4, 333, torch.float32)
    edge[3][0, 0] = 1e-7                         # w near 0: forget
    edge[3][0, 1] = 1.0 - 1e-7                   # w near 1: remember
    edge[2][1, 2] = 0.0                          # v = 0
    edge[0][1, 3] = 0.0                          # r = 0: y = 0
    f32_cases = [("main f32", wkv6_inputs(b, h, t, torch.float32)),
                 ("T=1", wkv6_inputs(b, h, 1, torch.float32)),
                 ("B=1", wkv6_inputs(1, h, t, torch.float32)),
                 ("edges", edge)]
    for label, args in f32_cases:
        y, s_t = wkv6.wkv6_scan(*args)
        y_r, s_r = ref.wkv6_scan(*(z.contiguous() for z in args))
        torch.cuda.synchronize()
        if not same_bits(s_t, s_r):
            raise AssertionError(f"K12 {label}: S_T differs from the plain "
                                 f"version's bits")
        dy = float((y - y_r).abs().max())
        if dy > WKV6_YTOL * float(y_r.abs().max()):
            raise AssertionError(f"K12 {label}: y off by {dy!r}")
        recs["K12"].err(y, y_r)
    print(f"[scans] K12 float32 route: S_T bit-equal and y within "
          f"{WKV6_YTOL} of max |plain| on {len(f32_cases)} cases", flush=True)
    del f32_cases, edge

    # bf16: the chunked tensor-core route, held elementwise to the JAX
    # package's tolerance against the plain version run in float64
    def bf16_route_case(label, args):
        y, s_t = wkv6.wkv6_scan(*args)
        y64, s64 = ref.wkv6_scan(*(z.double() for z in args),
                                 dtype=torch.float64)
        torch.cuda.synchronize()
        tol_y = (WKV6_BF16_ATOL + WKV6_BF16_RTOL * y64.abs()
                 + bf16_ulp(torch, y64).double())
        tol_s = WKV6_BF16_ATOL + WKV6_BF16_RTOL * s64.abs()
        dy = (y.double() - y64).abs()
        ds = (s_t.double() - s64).abs()
        if bool((dy > tol_y).any()) or bool((ds > tol_s).any()):
            raise AssertionError(
                f"K12 {label}: bf16 route outside its tolerance: max "
                f"|dy| / tol {float((dy / tol_y).max())!r}, max |dS| / tol "
                f"{float((ds / tol_s).max())!r}")
        recs["K12"].err(y.double(), y64)
        recs["K12"].err(s_t.double(), s64)
        return float((dy / tol_y).max()), float((ds / tol_s).max())

    worst = (0.0, 0.0)
    main_heads = wkv6_inputs(b, h, t, torch.bfloat16, heads=True)
    held = wkv6_inputs(b, h, t, torch.bfloat16, heads=True)
    held[3][:, 0] = 1e-7                         # forget, a whole head
    held[3][:, 1] = 1.0 - 1e-7                   # remember, a whole head
    bf16_cases = [("main bf16 heads", main_heads),
                  ("main bf16", wkv6_inputs(b, h, t, torch.bfloat16))]
    bf16_cases += [(f"T={tt} bf16 heads",
                    wkv6_inputs(b, h, tt, torch.bfloat16, heads=True))
                   for tt in (1, 63, 64, 65, 77)]
    bf16_cases.append(("w=1e-7 and 1-1e-7 over 2560 steps, bf16 heads",
                       held))
    for label, args in bf16_cases:
        q = bf16_route_case(label, args)
        worst = (max(worst[0], q[0]), max(worst[1], q[1]))
    # what the float32 plain version itself is off by where w stays near 1
    y32, s32 = ref.wkv6_scan(*(z.contiguous() for z in held))
    y64, s64 = ref.wkv6_scan(*(z.double() for z in held), dtype=torch.float64)
    print(f"[scans] K12 bf16 route within |d| <= {WKV6_BF16_ATOL} + "
          f"{WKV6_BF16_RTOL} |plain in float64| (y: + one bf16 ulp) on "
          f"{len(bf16_cases)} cases; worst |d| / tolerance y {worst[0]!r}, "
          f"S_T {worst[1]!r}; the float32 plain version on the held-decay "
          f"case is itself off by max |dS| {float((s32.double() - s64).abs().max())!r}"
          f" from float64", flush=True)
    del bf16_cases, main_heads, held, y32, s32, y64, s64
    torch.cuda.empty_cache()

    for tag, shapes, iters, plain_iters, warm in (
            ("main", SCAN_MAIN, 20, 2, 2), ("large", SCAN_LARGE, 5, 1, 1)):
        b, t, d = shapes["K11"]
        x, a = rglru_inputs(b, t, d)
        n = b * t * d
        # reads x and a, writes y and h_T; 7 operations an element
        plans = {"K11": (lambda: rg.rglru_scan(x, a),
                         lambda: ref.rglru_scan(x, a),
                         12 * n + 4 * b * d, 7 * n)}
        b, h, t, _ = shapes["K12"]
        args = wkv6_inputs(b, h, t, torch.bfloat16, heads=True)
        n = b * h * t * 64
        # reads bf16 r, k, v, f32 w and u, writes bf16 y and f32 S_T.  The
        # function's least work a (b, h, t): y = S^T r + (sum_i r_i u_i k_i)
        # v is one FMA (2 operations) a state entry plus 5 a column, and
        # S <- diag(w) S + k v^T is 3 a state entry: 5 * 64 * 65 in all.
        # The bf16 route does them on the tensor cores: its bound takes the
        # bf16 tensor-core peak (the float32 one is printed beside it)
        plans["K12"] = (lambda: wkv6.wkv6_scan(*args),
                        lambda: ref.wkv6_scan(*args),
                        (3 * 2 + 4 + 2) * n + 4 * b * h * 64 * 64
                        + 4 * h * 64, 5 * 65 * n)
        f32_ms, _ = bound_ms(plans["K12"][2], plans["K12"][3])
        tc_ms, tc_by = bound_ms(plans["K12"][2], plans["K12"][3],
                                BF16_OPS_PER_S)
        if tag == "main":
            args32 = wkv6_inputs(b, h, t, torch.float32, heads=True)
            f32_kernel = time_ms(torch, lambda: wkv6.wkv6_scan(*args32), iters)
            f32_bytes = (4 * 4 + 4) * n + 4 * b * h * 64 * 64 + 4 * h * 64
            print(f"[scans] K12 float32 route (sequential kernel) main "
                  f"{shapes['K12']}: kernel_ms={f32_kernel!r} bound_ms="
                  f"{bound_ms(f32_bytes, 5 * 65 * n)!r}", flush=True)
            del args32
        print(f"[scans] K12 bf16 route {tag}: bound against the bf16 tensor "
              f"cores {tc_ms!r} ms ({tc_by}), against float32's 67 TFLOP/s "
              f"{f32_ms!r} ms; held to the first", flush=True)
        for key_, (kern, plain, nbytes, nops) in plans.items():
            rec = recs[key_]
            b_ms, b_by = bound_ms(nbytes, nops,
                                  BF16_OPS_PER_S if key_ == "K12"
                                  else F32_OPS_PER_S)
            row = {"shape": list(shapes[key_]),
                   "kernel_ms": time_ms(torch, kern, iters),
                   "plain_ms": time_ms(torch, plain, plain_iters, warm),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            rec.timings[tag] = row
            print(f"[scans] {key_} {rec.name} {tag} {shapes[key_]}: kernel_ms="
                  f"{row['kernel_ms']!r} plain_ms={row['plain_ms']!r} "
                  f"library_ms=None (no one PyTorch call computes the scan) "
                  f"bound_ms={b_ms!r} ({b_by})", flush=True)
        del x, a, args, plans
        torch.cuda.empty_cache()


def serve_phase(torch, dev, shapes: dict, capture: tuple = ()):
    """Phases 7 and 8: each model of ``shapes`` ({arch: (batch, prompt,
    launches of one prefill)}) at full width and depth through serve().
    Returns ({kernel name: {run label: launches}}, {(arch, layer): (q, k,
    v, chunked_attention's keyword arguments)}) for the (arch, layer) pairs
    in ``capture``, taken from the warm-up prefill."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as tree_util
    from repro_torch.configs import get_spec
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm

    launches, captured = {}, {}
    for arch, (batch, prompt_len, want) in shapes.items():
        m = get_spec(arch).model
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()     # earlier phases' tensors
        params = tfm.init_params(m, torch.Generator(device=dev).manual_seed(0))
        n_params = sum(p.numel() for p in tree_util.leaves(params))
        toks = serve.prompts_for(m, batch, prompt_len + 1, dev)
        prompts = toks[:, :prompt_len]
        # warm up at the serving shape; prefill's attention calls run in
        # layer order, so call i is layer i's (every layer of the dense
        # models attends)
        layers_wanted = [i for a, i in capture if a == arch]
        calls = []
        orig_chunked = attn.chunked_attention

        def capturing(q, k, v, _orig=orig_chunked, **kw):
            if len(calls) in layers_wanted:
                captured[(arch, len(calls))] = (q, k, v, kw)
            calls.append(1)
            return _orig(q, k, v, **kw)

        attn.chunked_attention = capturing
        try:
            serve.serve(params, m, prompts, 2)
        finally:
            attn.chunked_attention = orig_chunked
        decode_counts = []
        orig_decode = tfm.decode_step

        def counting_decode(*a, _orig=orig_decode, **kw):
            before = ops.launch_counts()
            out = _orig(*a, **kw)
            after = ops.launch_counts()
            decode_counts.append({k: after[k] - before[k] for k in after})
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        tfm.decode_step = counting_decode
        try:
            res = serve.serve(params, m, prompts, SERVE_GEN)
        finally:
            tfm.decode_step = orig_decode
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - before
        expect = {**{k: 0 for k in counts}, **want}
        if counts != expect:
            raise AssertionError(f"{arch}: serve launch counts {counts} != "
                                 f"{expect}")
        if any(c[k] for c in decode_counts for k in ("rglru_scan",
                                                      "wkv6_scan")):
            raise AssertionError(f"{arch}: a decode step launched a scan")
        if len(decode_counts) != SERVE_GEN:
            raise AssertionError(f"{arch}: {len(decode_counts)} decode steps")
        for name in want:
            launches.setdefault(name, {})[f"serve {arch}"] = counts[name]
        finite = bool(torch.isfinite(res.prefill_logits).all()) and all(
            bool(torch.isfinite(l).all()) for l in res.logits)
        if not finite or tuple(res.tokens.shape) != (batch, SERVE_GEN):
            raise AssertionError(f"{arch}: non-finite logits or tokens of "
                                 f"shape {tuple(res.tokens.shape)}")
        # the same shape again, warm: the median of SERVE_TIMED prefills
        # and of the per-step decode times (host clock, synchronised)
        max_len = prompt_len + SERVE_GEN + 1
        pre_ms, step_ms = [], []
        for _ in range(SERVE_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, st = tfm.prefill(params, m, prompts, max_len=max_len)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
        tok = logits.argmax(-1)
        for _ in range(SERVE_GEN):
            t0 = time.perf_counter()
            logits, st = tfm.decode_step(params, m, tok, st)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        pre_med = statistics.median(pre_ms)
        step_med = statistics.median(step_ms)
        print(f"[serve] {arch}: {n_params} params bf16, batch {batch} "
              f"prompt {prompt_len} gen {SERVE_GEN}: prefill ms median "
              f"{pre_med!r} of {pre_ms!r}; decode ms/step median {step_med!r}"
              f" (min {min(step_ms)!r}, max {max(step_ms)!r}; "
              f"{batch * 1e3 / step_med!r} tokens/s); the counted serve "
              f"run: prefill ms {res.prefill_s * 1e3!r}, decode ms/step "
              f"{res.decode_s / SERVE_GEN * 1e3!r}; peak memory {peak} B "
              f"(max_memory_allocated over what was allocated before the "
              f"weights); launches {counts} (decode steps: none); "
              f"tokens[0][:8] {res.tokens[0, :8].tolist()}", flush=True)
        del st, logits

        # prefill(T) + one decode step against prefill(T + 1)
        max_len = prompt_len + 2
        _, st = tfm.prefill(params, m, prompts, max_len=max_len)
        l_step, _ = tfm.decode_step(params, m, toks[:, prompt_len], st)
        l_long, _ = tfm.prefill(params, m, toks, max_len=max_len)
        gap = float((l_step - l_long).abs().max())
        scale = float(l_long.abs().max())
        agree = float((l_step.argmax(-1) == l_long.argmax(-1)).float().mean())
        print(f"[serve] {arch}: prefill(T) + decode vs prefill(T+1): max abs "
              f"gap {gap!r} against max |logits| {scale!r} (limit "
              f"{GAP_REL} x); argmax agreement {agree!r}", flush=True)
        if not gap <= GAP_REL * scale:
            raise AssertionError(f"{arch}: self-consistency gap {gap!r} > "
                                 f"{GAP_REL} * {scale!r}")
        del st, l_step, l_long

        # the device's busy share: one prefill, then 8 decode steps
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, st = tfm.prefill(params, m, prompts,
                                     max_len=prompt_len + SERVE_GEN + 1)
            torch.cuda.synchronize()
            pre_wall = (time.perf_counter() - t0) * 1e3
        by_name = device_ms_by_name(prof)
        pre_busy = sum(by_name.values())
        pre_top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        tok = logits.argmax(-1)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(SERVE_PROFILE_STEPS):
                logits, st = tfm.decode_step(params, m, tok, st)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            dec_wall = (time.perf_counter() - t0) * 1e3
        dec_busy = sum(device_ms_by_name(prof).values())
        host = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:5]
        pre_top = "; ".join(f"{name[:60]} {ms!r}" for name, ms in pre_top)
        host = "; ".join(
            f"{e.key[:32]} {e.self_cpu_time_total / SERVE_PROFILE_STEPS / 1e3!r}"
            for e in host)
        print(f"[profile] serve {arch}: prefill wall ms {pre_wall!r} device "
              f"busy ms {pre_busy!r} idle share {1 - pre_busy / pre_wall!r} "
              f"(top device ms: {pre_top}); {SERVE_PROFILE_STEPS} decode "
              f"steps wall ms {dec_wall!r} busy ms {dec_busy!r} idle share "
              f"{1 - dec_busy / dec_wall!r}; decode host self time (ms/step): "
              f"{host}", flush=True)
        del params, res, st, logits
        torch.cuda.empty_cache()
    return launches, captured


def build_report(build):
    """Phase 1's look at the libraries: what ``-Xptxas -v`` logged for
    K10's, K4's, K5/K6's, K7's, K8/K9's and K11's, the wgmma kernel's dynamic
    shared memory, and
    its SASS's wgmma and TMA instructions (which must both be there, where
    ``cuobjdump`` is).  Returns the keyed K4's integer instructions by
    opcode (its float4 instance's SASS, 4 elements a thread), a diagnostic
    beside the bound, or None without ``cuobjdump``."""
    from repro_torch.kernels import flash_attention as fa

    for name in ("flash_attention_sm90", "flash_attention", "quantize",
                 "select_slots", "qr_pack", "pack_codes", "rglru_scan"):
        kernel = None
        for line in build.ptxas_log(name).splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and ("Used" in line or "spill" in line
                             or "C75" in line):
                print(f"[build] ptxas {name} {kernel[-60:]}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
    print("[build] wgmma K10 dynamic shared memory a block: " + ", ".join(
        f"Dh {dh} {fa.wgmma_smem_bytes(dh)} B" for dh in fa.HEAD_DIMS),
        flush=True)
    if build.cuobjdump_path() is None:
        print("[build] cuobjdump not in the toolkit: HGMMA/UTMALDG and the "
              "keyed K4's integer instructions not counted", flush=True)
        return None
    counts = build.sass_counts("flash_attention_sm90", ("HGMMA", "UTMALDG"))
    print(f"[build] flash_attention_sm90 SASS: {counts}", flush=True)
    if not (counts["HGMMA"] > 0 and counts["UTMALDG"] > 0):
        raise AssertionError(f"K10's bf16 library lacks wgmma or TMA: "
                             f"{counts}")
    ints = build.sass_counts("quantize", build.INT_OPCODES,
                             match=("qr_round", "ILb1ELb1E"))
    print(f"[build] keyed K4 (float4 instance, 4 elements a thread) SASS "
          f"integer instructions {ints}: {sum(ints.values()) / 4!r} an "
          f"element, {sum(v for op, v in ints.items() if op != 'IMAD') / 4!r}"
          f" off the IMAD pipe (diagnostic: the bound counts the "
          f"function's {threefry_pipe_ops()!r})", flush=True)
    return ints


# The least per-pipe integer work of one uniform (threefry.cuh): the 20
# rounds' rotates (SHF) and xors (LOP3), then hi ^ lo, >> 9 and
# | 0x3F800000, run only on the ALU pipe; the 31 adds (20 rounds, 5
# injections of two words, the counter word; the key schedule is once a
# thread) may issue there or as IMAD on the FMA pipe, 64 lanes an SM each.
THREEFRY_ALU_OPS = 20 + 20 + 3
THREEFRY_ADDS = 20 + 2 * 5 + 1


def threefry_pipe_ops() -> float:
    """Operations an element on the busier of the two integer pipes, with
    the adds spread as evenly as the ALU-only work allows."""
    return max(THREEFRY_ALU_OPS, (THREEFRY_ALU_OPS + THREEFRY_ADDS) / 2)


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def attention_pairs(tq: int, tk: int, causal: bool, window, q_offset: int):
    """Visible (query, key) pairs of one (batch, head): what K10's
    operation count depends on."""
    total = 0
    for i in range(tq):
        pos = q_offset + i
        hi = min(tk - 1, pos) if causal else tk - 1
        lo = max(0, pos - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def attention_bound(torch, q, k, kw) -> tuple:
    """K10's bound: each input read once and the output written once over
    the card's memory rate, against 4 * Dh operations a visible pair over
    the dense bf16 tensor-core peak (float32 peak for float32 inputs)."""
    b, hq, tq, dh = q.shape
    tk = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    pairs = attention_pairs(tq, tk, kw.get("causal", True), kw.get("window"),
                            kw.get("q_offset", 0))
    ops_ = 4 * b * hq * dh * pairs
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound_ms(nbytes, ops_, peak)


def attention_phase(torch, dev, rec, captured: dict) -> dict:
    """Phase 9: K10 against its plain version at the JAX package's flash
    cases and further shapes in both dtypes; then the main path,
    ``ops.mha_attention`` on the q/k/v the dense models' prefill computed,
    counted, and held against the plain version and the models' own
    ``chunked_attention``; then timed.  Returns {run label: launches}."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as attn

    gen = torch.Generator(device=dev).manual_seed(15)
    tol = {torch.float32: ATTN_F32_TOL, torch.bfloat16: ATTN_BF16_TOL}

    def inputs(b, hq, hkv, tq, tk, dh, dtype):
        q = torch.randn((b, hq, tq, dh), generator=gen, device=dev)
        k, v = (torch.randn((b, hkv, tk, dh), generator=gen, device=dev)
                for _ in range(2))
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def hold(label, got, want, dtype):
        """|got - want| <= tol * (1 + |want|), compared in the working
        type.  Returns max |d| and the largest gap in bf16 ulps of the
        output among outputs above the tolerance in magnitude (where the
        relative part of the bound governs)."""
        d = (got.float() - want.float()).abs()
        t = tol[dtype]
        big = want.float().abs() > t
        ulps = (float((d / bf16_ulp(torch, want))[big].max())
                if bool(big.any()) else 0.0)
        if bool((d > t + t * want.float().abs()).any()):
            raise AssertionError(f"K10 {label}: max |d| {float(d.max())!r} "
                                 f"({ulps!r} bf16 ulps) above rtol = atol = "
                                 f"{t}")
        return float(d.max()) if d.numel() else 0.0, ulps

    # the JAX package's flash cases (tests/test_kernels.py), then every head
    # size and group, a ragged length and a long decode
    cases = [(f"option {kw}", (2, 4, 2, 128, 128, 64), kw) for kw in (
        dict(causal=True), dict(causal=False), dict(causal=True, window=64),
        dict(causal=True, softcap=30.0),
        dict(causal=True, window=32, softcap=50.0))]
    cases += [(f"gqa {hq}:{hkv} dh {dh}", (1, hq, hkv, 128, 128, dh),
               dict(causal=True)) for hq, hkv, dh in ((8, 8, 32), (8, 1, 64),
                                                      (6, 2, 128))]
    cases.append(("decode offset 255", (2, 4, 2, 1, 256, 64),
                  dict(causal=True, q_offset=255)))
    cases += [(f"dh {dh} group {g}", (1, 2 * g, 2, 256, 256, dh),
               dict(causal=True, window=100, softcap=30.0) if g % 2 else
               dict(causal=True)) for dh in (32, 64, 128, 256)
              for g in (1, 2, 4, 7, 8)]
    cases.append(("ragged T=1000", (1, 8, 2, 1000, 1000, 128),
                  dict(causal=True, window=300, softcap=50.0)))
    cases.append(("decode Tk=4641", (4, 16, 8, 1, 4641, 256),
                  dict(causal=True, q_offset=4640, softcap=50.0)))
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape, kw in cases:
            q, k, v = inputs(*shape, dtype)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.mha_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"K10 {label}: {got.dtype} "
                                     f"{tuple(got.shape)}")
            err = hold(f"{label} {dtype}", got, want, dtype)
            worst[dtype] = tuple(map(max, worst[dtype], err))
            rec.err(got.float(), want.float())
    print(f"[attention] K10 within rtol = atol = {ATTN_F32_TOL} (float32) and "
          f"{ATTN_BF16_TOL} (bf16) of the plain version on {len(cases)} cases "
          f"in each dtype; max |d| (bf16 ulps of outputs above the "
          f"tolerance): float32 "
          f"{worst[torch.float32]!r}, bf16 {worst[torch.bfloat16]!r}",
          flush=True)
    del q, k, v, got, want
    torch.cuda.empty_cache()

    # the main path: ops.mha_attention on the served q/k/v, counted
    served = sorted(captured)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = [ops.mha_attention(*captured[key][:3], **captured[key][3])
            for key in served]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expect = {**{k: 0 for k in counts}, "flash_attention": len(served)}
    if counts != expect:
        raise AssertionError(f"attention main path: launch counts {counts} "
                             f"!= {expect}")
    vs_chunked = {}
    for key, got in zip(served, outs):
        q, k, v, kw = captured[key]
        want = ref.mha_attention(q, k, v, **kw)
        e_plain = hold(f"served {key} vs plain", got, want, q.dtype)
        rec.err(got.float(), want.float())
        del want
        chunked = attn.chunked_attention(q, k, v, **kw)
        e_chunk = hold(f"served {key} vs chunked_attention", got, chunked,
                       q.dtype)
        vs_chunked[key] = e_chunk
        print(f"[attention] served {key[0]} layer {key[1]} q {tuple(q.shape)} "
              f"k {tuple(k.shape)} {q.dtype} {kw}: max |d| (bf16 ulps of "
              f"outputs above the tolerance) vs "
              f"plain {e_plain!r}, vs chunked_attention {e_chunk!r}",
              flush=True)
        del chunked
    del outs
    torch.cuda.empty_cache()

    def library(q, k, v, kw):
        """One PyTorch call for the same function, where there is one: SDPA
        with GQA, a causal flag or a boolean window mask; none with a
        softcap.  Timed only; the port never calls it."""
        if kw.get("softcap") is not None:
            return None
        tq, tk = q.shape[2], k.shape[2]
        w = kw.get("window")
        if w is None or w >= tk:
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        qpos = torch.arange(tq, device=dev)[:, None]
        kpos = torch.arange(tk, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - w)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)

    def timed(tag, q, k, v, kw, iters):
        b_ms, b_by = attention_bound(torch, q, k, kw)
        lib = library(q, k, v, kw)
        row = {"shape": [list(q.shape), list(k.shape)], "kwargs": kw,
               "kernel_ms": time_ms(torch, lambda: fa.flash_attention(
                   q, k, v, **kw), iters, 1),
               "plain_ms": time_ms(torch, lambda: ref.mha_attention(
                   q, k, v, **kw), 1, 1),
               "chunked_ms": time_ms(torch, lambda: attn.chunked_attention(
                   q, k, v, **kw), iters, 1),
               "library_ms": time_ms(torch, lib, iters, 1) if lib else None,
               "bound_ms": b_ms, "bound_by": b_by}
        lib_err = None
        if lib is not None:
            lib_err = float((lib().float() - fa.flash_attention(
                q, k, v, **kw).float()).abs().max())
        print(f"[attention] K10 {tag} q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{kw}: kernel_ms={row['kernel_ms']!r} plain_ms="
              f"{row['plain_ms']!r} chunked_ms={row['chunked_ms']!r} "
              f"library_ms={row['library_ms']!r} "
              f"(max |SDPA - K10| {lib_err!r}) bound_ms={b_ms!r} ({b_by})",
              flush=True)
        torch.cuda.empty_cache()
        return row

    served_rows = {}
    for key in served:
        q, k, v, kw = captured[key]
        row = timed(f"served {key}", q, k, v, kw, 5)
        row["max_abs_vs_chunked"] = vs_chunked[key][0]
        served_rows[f"{key[0]} layer {key[1]}"] = row
    rec.timings["main"] = served_rows[f"{ATTN_MAIN[0]} layer {ATTN_MAIN[1]}"]
    rec.timings["served"] = served_rows
    prefill_question(served_rows)
    q, k, v = inputs(*ATTN_LARGE, torch.bfloat16)
    rec.timings["large"] = timed("large", q, k, v, dict(causal=True), 3)
    del q, k, v
    torch.cuda.empty_cache()
    return {"attention main path (served q/k/v)": counts["flash_attention"]}


def prefill_question(served_rows: dict) -> None:
    """What each dense prefill would save by calling K10 instead of
    ``chunked_attention``: every layer timed as the captured layer of its
    block type (swa or attn) at the serving shape, and the largest gap
    between the two routes' outputs on those layers."""
    from repro_torch.configs import get_spec

    by_kind = {}
    for arch, layer in ATTN_CAPTURE:
        m = get_spec(arch).model
        by_kind[(arch, m.block_type(layer))] = served_rows[
            f"{arch} layer {layer}"]
    for arch in DENSE_SHAPES:
        m = get_spec(arch).model
        rows = [by_kind[(arch, m.block_type(i))] for i in range(m.n_layers)]
        chunked = sum(r["chunked_ms"] for r in rows)
        kernel = sum(r["kernel_ms"] for r in rows)
        err = max(r["max_abs_vs_chunked"] for r in rows)
        print(f"[attention] prefill question: {arch}, {m.n_layers} layers at "
              f"batch {DENSE_SHAPES[arch][0]}, prompt {DENSE_SHAPES[arch][1]}:"
              f" chunked_attention {chunked!r} ms, K10 {kernel!r} ms; K10 "
              f"would save {chunked - kernel!r} ms a prefill; max |K10 - "
              f"chunked_attention| on its layers {err!r}", flush=True)


def cuda_vs_cpu_phase(torch, dev) -> None:
    """Phase 10: full width, reduced depth, float32: the card (kernels)
    against the CPU (plain versions) on the same weights."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_spec
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    for arch, n_layers in CPU_CHECK_LAYERS.items():
        m = dataclasses.replace(get_spec(arch).model, n_layers=n_layers,
                                dtype=torch.float32)
        params = tfm.init_params(m, torch.Generator(device=dev).manual_seed(1))
        cpu_params = tree_util.map(lambda t: t.cpu(), params)
        prompts = serve.prompts_for(m, 2, 128, dev)
        on_card = serve.serve(params, m, prompts, 4)
        on_cpu = serve.serve(cpu_params, m, prompts.cpu(), 4)
        worst = 0.0
        for g, c in zip([on_card.prefill_logits] + on_card.logits,
                        [on_cpu.prefill_logits] + on_cpu.logits):
            worst = max(worst, float(((g.cpu() - c).abs()
                                      / (1 + c.abs())).max()))
        same = torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
        print(f"[cuda-vs-cpu] {arch} ({n_layers} layers, d {m.d_model}, "
              f"float32): max |cuda - cpu| / (1 + |cpu|) over prefill and 4 "
              f"decode logits {worst!r} (limit {CPU_LOGIT_TOL}); greedy "
              f"tokens equal {same}", flush=True)
        if not (worst <= CPU_LOGIT_TOL and same):
            raise AssertionError(f"{arch}: CUDA and CPU serving differ")
        del params, cpu_params
        torch.cuda.empty_cache()


def cifar_setup(torch, dev):
    """The paper's FedCIFAR10 setup (``benchmarks/common.py`` ``cifar_setup``)
    from the port's own modules: ``make_cifar_like(6000, 1000, seed=1)``,
    Dirichlet(0.7) over 10 clients, the CNN; data on the card and on the
    CPU, eval on the card."""
    from repro_torch.core import fed_data, server
    from repro_torch.data import dirichlet, synthetic
    from repro_torch.models import small

    ds = synthetic.make_cifar_like(n_train=6000, n_test=1000, seed=1)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=10,
                                          alpha=0.7, seed=1)
    model = small.CNN(3, 10, 32)
    data = {d: fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                             device=d) for d in ("cuda", "cpu")}
    eval_fn = server.make_eval_fn(model.apply,
                                  torch.from_numpy(ds.x_test).to(dev),
                                  torch.from_numpy(ds.y_test).to(dev))
    return model, data, eval_fn


def finite_rounds(losses) -> int:
    """How many rounds from the first have a finite train loss."""
    return next((i for i, v in enumerate(losses) if not math.isfinite(v)),
                len(losses))


def replay_on_cpu(torch, prng, make, params0, rounds: int, label: str, exact,
                  close=()) -> None:
    """``rounds`` rounds of ``make("cuda")`` from ``params0``, each round
    replayed on the CPU (the plain versions) by ``make("cpu")`` from the
    card's state before it, with the same key: cohorts and the ``exact``
    metrics equal, the ``close`` ones within rtol ``CLOCK_RTOL``, the train
    loss within ``LOSS_RTOL``.  Starting every CPU round from the card's
    state keeps a TopK selection that float32 rounding flipped in one
    round out of the next round's loss: on the CNN with TopK(0.1), scaling
    the init by 1 + 1e-7 moves round 3's train loss by up to 1.8e-3
    (relative) on the CPU alone."""
    import numpy as np

    from repro_torch import tree as tree_util

    def to(state, device):
        return type(state)(*(tree_util.map(
            lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, f)
            for f in state))

    algs, cohorts = {}, {}
    for d in ("cuda", "cpu"):
        algs[d] = make(d)
        log = cohorts[d] = []
        sample = algs[d].sched.sample_cohort

        def recording(key_, s_, round_idx=0, _sample=sample, _log=log):
            clients, avail = _sample(key_, s_, round_idx)
            _log.append(clients.tolist())
            return clients, avail

        object.__setattr__(algs[d].sched, "sample_cohort", recording)
    state, key, losses = algs["cuda"].init(params0), prng.PRNGKey(1), []
    for r in range(rounds):
        key, sub = prng.split(key, 2)
        _, b = algs["cpu"].round(to(state, "cpu"), sub)
        state, a = algs["cuda"].round(state, sub)
        for key_ in exact:
            if np.asarray(a[key_]).tolist() != np.asarray(b[key_]).tolist():
                raise AssertionError(f"{label} round {r}: {key_} "
                                     f"{a[key_]!r} != {b[key_]!r}")
        for key_ in close:
            if not np.allclose(a[key_], b[key_], rtol=CLOCK_RTOL, atol=0):
                raise AssertionError(f"{label} round {r}: {key_} "
                                     f"{a[key_]!r} vs {b[key_]!r}")
        if abs(a["train_loss"] - b["train_loss"]) > LOSS_RTOL * abs(
                b["train_loss"]):
            raise AssertionError(f"{label} round {r}: train_loss "
                                 f"{a['train_loss']!r} vs "
                                 f"{b['train_loss']!r}")
        losses.append((a["train_loss"], b["train_loss"]))
    if cohorts["cuda"] != cohorts["cpu"]:
        raise AssertionError(f"{label}: cohorts differ {cohorts}")
    print(f"[replay] {label}: {rounds} rounds, each from the card's state, "
          f"CUDA == CPU on cohorts {cohorts['cuda']}, {', '.join(exact)}; "
          f"{', '.join(close) or 'nothing'} within rtol {CLOCK_RTOL}; "
          f"train_loss (card, CPU) within rtol {LOSS_RTOL}: {losses!r}",
          flush=True)


def fig9_phase(torch, dev, setup, launches: dict) -> dict:
    """Phase 4: the paper's Figure 9 (``benchmarks/fig9_baselines.py``) on
    the card: FedAvg, sparseFedAvg, Scaffold, FedDyn, FedComLoc-Com and
    Scaffnew on the CNN, each on both wires; returns the steady-round
    profiles by run."""
    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.compress import Identity, TopK
    from repro_torch.core import baselines, server
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.kernels import ops
    from repro_torch.models import small

    model, data, eval_fn = setup
    loss_fn = small.cross_entropy_loss(model.apply)
    params0 = model.init(prng.PRNGKey(0), device=dev)
    fed = baselines.FedConfig(gamma=0.1, local_steps=10, n_clients=10,
                              clients_per_round=5, batch_size=32)

    def fcl(variant):
        return FedComLocConfig(gamma=0.05, p=0.1, n_clients=10,
                               clients_per_round=5, batch_size=32,
                               variant=variant)

    # the TopK runs launch K1 + K2 as one launch a leaf on the account
    # wire, K1 and K5 on the packed wire (the topk codec); the rest none
    topk_used = {"account": (FUSED_K1_K2,),
                 "packed": ("topk_threshold_bits", "compact_slots")}
    algs = {
        "fedavg": (lambda d, w: baselines.FedAvg(loss_fn, d, fed, wire=w),
                   None),
        "sparse_fedavg_k10": (lambda d, w: baselines.SparseFedAvg(
            loss_fn, d, fed, density=0.1, wire=w), topk_used),
        "scaffold": (lambda d, w: baselines.Scaffold(loss_fn, d, fed, wire=w),
                     None),
        "feddyn": (lambda d, w: baselines.FedDyn(loss_fn, d, fed, wire=w),
                   None),
        "fedcomloc_com_k10": (lambda d, w: FedComLoc(
            loss_fn, d, fcl("com"), TopK(density=0.1), wire=w), topk_used),
        "scaffnew": (lambda d, w: FedComLoc(loss_fn, d, fcl("none"),
                                            Identity(), wire=w), None),
    }
    n_leaves = len(tree_util.leaves(params0))
    zero = {name: 0 for name in ops.launch_counts()}
    runs = {}
    for name, (make, used) in algs.items():
        for wire in ("account", "packed"):
            label = f"fig9 {name} {wire}"
            alg = make(data["cuda"], wire)
            per_round = []
            round_fn = alg.round

            def recording(state, key_, _round=round_fn, _log=per_round):
                state, metrics = _round(state, key_)
                _log.append(metrics)
                return state, metrics

            alg.round = recording
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.time()
            hist = server.run_federated(alg, params0, FIG9_ROUNDS,
                                        prng.PRNGKey(1), eval_fn=eval_fn,
                                        eval_every=max(1, FIG9_ROUNDS // 6))
            torch.cuda.synchronize()
            wall = time.time() - t0
            del alg.round
            counts = ops.launch_counts()
            kernels = used[wire] if used else ()
            expect = {**zero, **{k: FIG9_ROUNDS * n_leaves for k in kernels}}
            losses = [float(m["train_loss"]) for m in per_round]
            print(f"[fig9] {name} {wire}: best_acc {hist.best_acc!r} "
                  f"total_mbits {alg.meter.total_bits / 1e6!r} uplink_mbits "
                  f"{alg.meter.uplink_bits / 1e6!r} train loss by round "
                  f"{losses!r} ms/round (eval included) "
                  f"{wall / FIG9_ROUNDS * 1e3!r} launches "
                  f"{ {k: v for k, v in counts.items() if v} }", flush=True)
            if counts != expect:
                raise AssertionError(f"{label}: launch counts {counts} != "
                                     f"{expect}")
            finite = finite_rounds(losses)
            if name in FIG9_DIVERGING:
                # the JAX package's run goes to NaN as well: only its first
                # rounds are held
                if finite < 1:
                    raise AssertionError(f"{label}: round 1 not finite")
            elif not (finite == FIG9_ROUNDS and losses[-1] < losses[0]
                      and all(map(math.isfinite, hist.test_loss))):
                raise AssertionError(f"{label}: does not train: {losses}")
            for k in kernels:
                launches.setdefault(k, {})[label] = counts[k]
            runs[(name, wire)] = {"alg": alg, "hist": hist, "finite": finite}
    for name in algs:
        acc, pkd = runs[(name, "account")], runs[(name, "packed")]
        a_m, p_m = acc["alg"].meter, pkd["alg"].meter
        pa = tree_util.leaves(acc["hist"].final_params)
        pp = tree_util.leaves(pkd["hist"].final_params)
        if (p_m.uplink_bits, p_m.total_bits) != (a_m.uplink_bits,
                                                 a_m.total_bits):
            raise AssertionError(f"fig9 {name}: packed bits "
                                 f"{p_m.snapshot()} != account "
                                 f"{a_m.snapshot()}")
        if name in FIG9_DIVERGING:
            if acc["finite"] != pkd["finite"]:
                raise AssertionError(f"fig9 {name}: the wires diverge in "
                                     f"other rounds")
            print(f"[fig9] {name}: packed == account: uplink bits "
                  f"{p_m.uplink_bits!r}, total bits {p_m.total_bits!r}; both "
                  f"wires' losses finite through round {acc['finite']} of "
                  f"{FIG9_ROUNDS} (the JAX package's NaN from round 3); "
                  f"params not held",
                  flush=True)
            continue
        if not all(torch.allclose(b, a, rtol=PARAM_RTOL, atol=PARAM_ATOL)
                   for a, b in zip(pa, pp)):
            raise AssertionError(f"fig9 {name}: packed params differ from "
                                 f"account beyond rtol {PARAM_RTOL} atol "
                                 f"{PARAM_ATOL}")
        equal = all(torch.equal(a, b) for a, b in zip(pa, pp))
        print(f"[fig9] {name}: packed == account: uplink bits "
              f"{p_m.uplink_bits!r}, total bits {p_m.total_bits!r}; params "
              f"within rtol {PARAM_RTOL} atol {PARAM_ATOL} (bit-equal "
              f"{equal})", flush=True)
    profiles = {}
    for (name, wire), run in runs.items():
        label = f"fig9 {name} {wire}"
        p = profile_rounds(torch, prng, run["alg"], params0, label)
        profiles[label] = p
        idle = ("not measured" if p["busy_ms"] is None
                else repr(1.0 - p["busy_ms"] / p["wall_ms"]))
        print(f"[fig9] {name} {wire}: steady ms/round {p['wall_ms']!r}, device busy "
              f"ms/round {p['busy_ms']!r}, idle share {idle}, device "
              f"operations a round {p['device_ops']!r}", flush=True)
    exact = ["client_steps", "uplink_bits", "downlink_bits",
             "client_uplink_bits"]
    for name in ("sparse_fedavg_k10", "scaffold", "fedcomloc_com_k10"):
        replay_on_cpu(torch, prng,
                      lambda d, _m=algs[name][0]: _m(data[d], "account"),
                      params0, min(REPLAY_ROUNDS,
                                   runs[(name, "account")]["finite"]),
                      f"fig9 {name} account", exact)
    return profiles


def hetero_phase(torch, dev, setup, launches: dict) -> None:
    """Phase 5: the Figure 9 setup on lognormal client speeds and
    bandwidths, FedComLoc TopK(0.1), FedAvg and Scaffold under sync,
    semi_sync(3) and async_buffered(2, 0.5), and straggler deadlines."""
    import numpy as np

    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.compress import TopK
    from repro_torch.core import baselines
    from repro_torch.core.aggregation import AggregationPolicy
    from repro_torch.core.clients import ClientProfile, ClientSchedule
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.kernels import ops
    from repro_torch.models import small

    model, data, _ = setup
    loss_fn = small.cross_entropy_loss(model.apply)
    params0 = model.init(prng.PRNGKey(0), device=dev)
    n_leaves = len(tree_util.leaves(params0))
    s = HETERO_S
    fed = baselines.FedConfig(gamma=0.1, local_steps=10, n_clients=10,
                              clients_per_round=s, batch_size=32)
    fcl = FedComLocConfig(gamma=0.05, p=0.1, n_clients=10,
                          clients_per_round=s, batch_size=32, variant="com")
    policies = {"sync": None,
                "semi_sync(3)": AggregationPolicy.semi_sync(3),
                "async_buffered(2, 0.5)": AggregationPolicy.async_buffered(
                    2, 0.5)}
    makers = {
        "fedcomloc_k10": lambda d, pol, sch: FedComLoc(
            loss_fn, d, fcl, TopK(density=0.1), schedule=sch, policy=pol),
        "fedavg": lambda d, pol, sch: baselines.FedAvg(
            loss_fn, d, fed, schedule=sch, policy=pol),
        "scaffold": lambda d, pol, sch: baselines.Scaffold(
            loss_fn, d, fed, schedule=sch, policy=pol),
    }
    cases = [(name, pol, {}) for name in makers for pol in policies]
    # deadline 10 truncates the slow clients' 10 steps; at deadline 3 the
    # slowest (speed 0.28) completes none and drops
    cases += [("fedcomloc_k10", "sync",
               {"deadline": 10.0, "drop_stragglers": True}),
              ("scaffold", "semi_sync(3)",
               {"deadline": 3.0, "drop_stragglers": True})]
    zero = {name: 0 for name in ops.launch_counts()}
    nominal = fed.local_steps               # = fcl.steps_cap
    exact = ["client_steps", "uplink_bits", "downlink_bits",
             "client_uplink_bits", "client_staleness", "clients_aggregated"]
    for name, pol, kw in cases:
        label = f"hetero {name} {pol}" + (
            f" deadline {kw['deadline']}" if kw else "")

        def make(d, _name=name, _pol=pol, _kw=kw):
            profile = ClientProfile.lognormal(10, speed_sigma=1.0,
                                              bandwidth_sigma=0.7, seed=0)
            return makers[_name](data[d], policies[_pol],
                                 ClientSchedule(profile, bit_cost=1e-7, **_kw))

        alg = make("cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        _, m = alg.run_rounds(alg.init(params0), prng.PRNGKey(1), FIG9_ROUNDS)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        kernels = (FUSED_K1_K2,) if name == "fedcomloc_k10" else ()
        expect = {**zero, **{k: FIG9_ROUNDS * n_leaves for k in kernels}}
        if counts != expect:
            raise AssertionError(f"{label}: launch counts {counts} != "
                                 f"{expect}")
        for k in kernels:
            launches.setdefault(k, {})[label] = counts[k]
        dropped = truncated = 0
        for r in range(FIG9_ROUNDS):
            steps, finish = m["client_steps"][r], m["client_finish"][r]
            part = steps > 0 if kw else np.ones(s, bool)
            agg = m["clients_aggregated"][r]
            if pol == "semi_sync(3)" and agg != min(3, int(part.sum())):
                raise AssertionError(f"{label} round {r}: {agg} aggregated, "
                                     f"{int(part.sum())} participants")
            if pol == "sync" and agg != part.sum():
                raise AssertionError(f"{label} round {r}: {agg} aggregated")
            if pol.startswith("async"):
                order = np.argsort(np.where(part, finish, np.inf),
                                   kind="stable")
                rank = np.empty(s, np.int64)
                rank[order] = np.arange(s)
                want = (rank // 2) * part
                if not np.array_equal(m["client_staleness"][r], want):
                    raise AssertionError(f"{label} round {r}: staleness "
                                         f"{m['client_staleness'][r]} != "
                                         f"{want}")
            if kw:
                gone = ~part
                if (np.any(m["client_uplink_bits"][r][gone] != 0.0)
                        or np.any(finish[gone]
                                  != np.float32(kw["deadline"]))):
                    raise AssertionError(f"{label} round {r}: a dropped "
                                         f"client sent bits or finished off "
                                         f"the deadline")
                dropped += int(gone.sum())
                truncated += int(((steps > 0) & (steps < nominal)).sum())
        losses = m["train_loss"].tolist()
        finite = finite_rounds(losses)
        if finite < (1 if name in FIG9_DIVERGING else FIG9_ROUNDS):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        if kw.get("deadline") == 3.0 and not dropped:
            raise AssertionError(f"{label}: no client dropped")
        if kw.get("deadline") == 10.0 and not truncated:
            raise AssertionError(f"{label}: no client truncated")
        print(f"[hetero] {label}: sim_time {float(m['sim_time'].sum())!r} "
              f"over {FIG9_ROUNDS} rounds, uplink Mbit "
              f"{alg.meter.uplink_bits / 1e6!r}, clients aggregated "
              f"{m['clients_aggregated'].tolist()}, staleness levels seen "
              f"{sorted(set(m['client_staleness'].ravel().tolist()))}, "
              f"dropped {dropped}, truncated {truncated}, train loss "
              f"{losses[0]!r} -> {losses[-1]!r}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        replay_on_cpu(torch, prng, make, params0, min(REPLAY_ROUNDS, finite),
                      label, exact, close=("sim_time", "client_finish"))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.compress import Compose, Int8Sync, QuantQr, TopK, wire
    from repro_torch.core import fed_data, server
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.data import dirichlet, synthetic
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import pack_codes as pk
    from repro_torch.kernels import qr_pack as qp
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import select_slots as sk
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.models import small

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)

    # ---- 1. build ---------------------------------------------------------- #
    t0 = time.time()
    libs = build.build_all()
    print(f"[build] {len(libs)} libraries in {time.time() - t0:.1f} s: "
          + ", ".join(p.name for p in libs.values()), flush=True)
    ints = build_report(build)
    # The keyed K4's integer work an element, counted from the function,
    # not from the kernel's SASS (printed above only as a diagnostic).
    k4_int_ops = threefry_pipe_ops()
    # INT32 peak: 132 SMs x 64 lanes x the max SM clock, a pipe
    int_peak = 132 * 64 * max_sm_clock_mhz() * 1e6
    print(f"[build] INT32 peak {int_peak!r} operations/s a pipe (132 SMs x "
          f"64 lanes x max SM clock); keyed K4 bound by {k4_int_ops!r} "
          f"operations an element on the busier pipe", flush=True)

    # ---- 2. kernels --------------------------------------------------------- #
    csrc = "src/repro_torch/kernels/csrc/"
    tpu = "src/repro/kernels/"
    recs = {
        "K1": KernelRecord("topk_threshold_bits", csrc + "topk_compress.cu",
                           tpu + "topk_compress.py:94"),
        "K2": KernelRecord("topk_mask", csrc + "topk_compress.cu",
                           tpu + "topk_compress.py:149"),
        "K3": KernelRecord("l2_norm", csrc + "quantize.cu",
                           tpu + "quantize.py:68"),
        "K4": KernelRecord("quantize_qr", csrc + "quantize.cu",
                           tpu + "quantize.py:97"),
        "K5": KernelRecord("compact_slots", csrc + "select_slots.cu",
                           tpu + "select_slots.py:188"),
        "K6": KernelRecord("compact_code_slots", csrc + "select_slots.cu",
                           tpu + "select_slots.py:205"),
        "K7": KernelRecord("quantize_pack_with_uniforms", csrc + "qr_pack.cu",
                           tpu + "qr_pack.py:61"),
        "K8": KernelRecord("pack_codes", csrc + "pack_codes.cu",
                           tpu + "pack_codes.py:62"),
        "K9": KernelRecord("unpack_codes", csrc + "pack_codes.cu",
                           tpu + "pack_codes.py:87"),
        # bf16 (the served layers, main and large) runs the wgmma kernel;
        # float32 the SIMT kernel in flash_attention.cu
        "K10": KernelRecord("flash_attention", csrc + "flash_attention_sm90.cu",
                            tpu + "flash_attention.py:86"),
        "K11": KernelRecord("rglru_scan", csrc + "rglru_scan.cu",
                            tpu + "rglru_scan.py:60"),
        "K12": KernelRecord("wkv6_scan", csrc + "wkv6.cu", tpu + "wkv6.py:62"),
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    hidden = 64
    leaf_sizes = (784 * hidden, hidden, hidden * hidden, hidden,
                  hidden * 10, 10)
    topk = TopK(0.3)
    s = 5

    def randn(rows, n, dtype=torch.float32):
        return torch.randn(rows, n, generator=gen, device=dev).to(dtype)

    def rand_codes(rows, n, b):
        c = torch.randint(0, 1 << b, (rows, n), generator=gen, device=dev,
                          dtype=torch.int64)
        return ref.to_i32(c)

    def same_bits(a, b) -> bool:
        view = torch.int16 if a.element_size() == 2 else torch.int32
        return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))

    def wide_keys(rows, seed):
        """(rows, 2) key data on the host, as the compressors pass it; row
        0's words at and above 2^31, row 1's at 2^32 - 1."""
        keys = prng.split(prng.PRNGKey(seed), rows)
        keys[0] = torch.tensor([2 ** 31, 2 ** 31 + 12345])
        if rows > 1:
            keys[1] = torch.tensor([2 ** 32 - 1, 2 ** 32 - 1])
        return keys

    topk_cases = [(f"main n={n}", randn(s, n), topk._k(n)) for n in leaf_sizes]
    x = randn(3, 1000)
    x[1] = 0.5                                   # all-equal magnitudes
    x[1, ::2] = -0.5
    x[2, :10] = 0.0                              # zeros and -0.0
    x[2, 10:20] = -0.0
    for k in (1, 999, 1000, 5000, 0):            # k = 1, n-1, >= n, <= 0
        topk_cases.append((f"edge n=1000 k={k}", x, k))
    topk_cases.append(("odd n=777", randn(4, 777), 77))     # scalar mask path
    topk_cases.append(("bf16 n=4096", randn(s, 4096, torch.bfloat16), 1229))
    topk_cases.append(("large", randn(*LARGE), LARGE[1] // 10))
    # K1's one-launch cluster kernel: rows shorter than a cluster's CTAs,
    # n not a multiple of 4 at the 16-CTA size, per-row k of 0, 1, n-1, n
    # and beyond n, +-0 / subnormals / inf, and rows at and just past the
    # clusters' shared-memory capacity (the longer one is read from HBM
    # until its candidates fit)
    for n in (1, 3, 5, 7):
        topk_cases.append((f"n={n} below the CTAs", randn(3, n), max(1, n // 2)))
    topk_cases.append(("odd n=50177", randn(s, 50177), 15053))
    x = randn(5, 1000)
    topk_cases.append(("per-row k 0 1 n-1 n >n", x,
                       torch.tensor([0, 1, 999, 1000, 1500], device=dev)))
    x = randn(4, 4099)
    x[0, ::3] = 1e-40                            # subnormals
    x[0, 1::7] = -1e-45
    x[1, ::5] = float("inf")                     # inf beside finite values
    x[1, 1::11] = float("-inf")
    x[2, :2000] = 0.0                            # +0 and -0 ties
    x[2, 2000:] = -0.0
    x[2, 7] = 3.0
    x[3] = 0.25                                  # every magnitude equal
    for k in (1, 410, 4098):
        topk_cases.append((f"special values n=4099 k={k}", x, k))
    resident = tk.resident_max_n()
    for n in (resident, resident + 4):
        x = randn(2, n)
        x[1, ::2] = 2.0                          # half the row ties
        topk_cases.append((f"n={n} ({'at' if n == resident else 'past'} the "
                           f"shared-memory capacity)", x, n // 10))
    for label, xc, k in topk_cases:
        t = tk.threshold_bits(xc, k)
        t_ref = ref.topk_threshold_bits(xc, k)
        m = tk.mask_by_threshold(xc, t)
        m_ref = ref.mask_by_threshold(xc, t_ref)
        # K1 and K2 in one launch: the threshold and the float32 rows
        t_f, m_f = tk.threshold_mask(xc, k)
        torch.cuda.synchronize()
        if not torch.equal(t, t_ref):
            raise AssertionError(f"K1 {label}: kernel threshold differs")
        if not same_bits(m, m_ref):
            raise AssertionError(f"K2 {label}: kernel mask differs")
        if not (torch.equal(t_f, t_ref)
                and same_bits(m_f, m_ref.to(torch.float32))):
            raise AssertionError(f"K1+K2 {label}: threshold_mask differs")
        recs["K1"].err(t, t_ref)
        recs["K2"].err(m.float(), m_ref.float())
        recs["K2"].err(m_f, m_ref.float())
    print(f"[kernels] K1, K2 and threshold_mask (K1 + K2 in one launch) "
          f"bit-equal to the plain versions on {len(topk_cases)} cases",
          flush=True)
    for n in (10, leaf_sizes[0], LARGE[1]):
        xc = randn(s if n != LARGE[1] else LARGE[0], n)
        for what, fn in (("threshold_bits", tk.threshold_bits),
                         ("threshold_mask", tk.threshold_mask)):
            _, ops_a_call = device_per_call(
                torch, lambda: fn(xc, max(1, n // 3)), 5)
            want = 1.0 if what == "threshold_bits" or n <= resident else 2.0
            if ops_a_call != want:
                raise AssertionError(f"K1 n={n}: {ops_a_call} device "
                                     f"operations a {what} call, not {want}")
    print(f"[kernels] K1 one kernel a call under torch.profiler (n = 10, "
          f"{leaf_sizes[0]}, {LARGE[1]}), threshold_mask one up to n = "
          f"{resident} (rows that stay in shared memory), K1 then K2 past "
          f"it", flush=True)
    del xc

    qr_cases = [(f"main n={n}", randn(s, n), 8) for n in leaf_sizes]
    x = randn(3, 1001)
    x[0, :7] = 0.0
    x[0, 7] = -0.0
    x[1] = 0.0                                   # norm 0: output all zero
    for r in (1, 4, 8):
        qr_cases.append((f"edge n=1001 r={r}", x, r))
    qr_cases.append(("bf16 n=4096", randn(s, 4096, torch.bfloat16), 4))
    qr_cases.append(("large", randn(*LARGE), 8))
    # the keyed entry's own edges: n = 1, n past 2^24 and not a multiple of
    # 4, 40 rows (past the 32 whose key words ride in the launch)
    qr_cases.append(("n=1", randn(3, 1), 8))
    qr_cases.append(("n=2^24+3", randn(2, (1 << 24) + 3), 8))
    qr_cases.append(("40 rows", randn(40, 1000), 4))
    for i, (label, xc, r) in enumerate(qr_cases):
        u = torch.rand(xc.shape, generator=gen, device=dev)
        keys = wide_keys(xc.shape[0], i)
        norm = qk.l2_norm(xc)
        again = qk.l2_norm(xc)
        norm_ref = ref.l2_norm(xc)
        out = qk.quantize_qr_with_uniforms(xc, r, u, norm)
        out_ref = ref.quantize_qr_with_uniforms(xc, r, u, norm)
        keyed = qk.quantize_qr_keyed(xc, r, keys, norm)
        keyed_ref = ref.quantize_qr_with_uniforms(
            xc, r, prng.uniform(keys, xc.shape[1], device=dev), norm)
        torch.cuda.synchronize()
        if not torch.equal(norm, again):
            raise AssertionError(f"K3 {label}: two runs gave different norms")
        if not torch.allclose(norm, norm_ref, rtol=NORM_RTOL, atol=0.0):
            raise AssertionError(f"K3 {label}: norm off by more than "
                                 f"rtol {NORM_RTOL}")
        if not same_bits(out, out_ref):
            raise AssertionError(f"K4 {label}: kernel output differs")
        if not same_bits(keyed, keyed_ref):
            raise AssertionError(f"K4 keyed {label}: kernel output differs "
                                 f"from prng.uniform + the plain version")
        recs["K3"].err(norm, norm_ref)
        recs["K4"].err(out.float(), out_ref.float())
        recs["K4"].err(keyed.float(), keyed_ref.float())
    print(f"[kernels] K4 (both entries: reading u, and drawing it with "
          f"threefry against prng.uniform, key words >= 2^31) bit-equal and "
          f"K3 within rtol {NORM_RTOL} (and deterministic) on "
          f"{len(qr_cases)} cases", flush=True)
    for n in (10, leaf_sizes[0], LARGE[1]):
        rows = s if n != LARGE[1] else LARGE[0]
        xc, keys = randn(rows, n), wide_keys(rows, n)
        norm = qk.l2_norm(xc)
        _, ops_a_call = device_per_call(
            torch, lambda: qk.quantize_qr_keyed(xc, 8, keys, norm), 5)
        if ops_a_call != 1.0:
            raise AssertionError(f"K4 keyed n={n}: {ops_a_call} device "
                                 f"operations a call, not 1")
        _, ops_a_call = device_per_call(
            torch, lambda: ops.quantize_qr(xc, 8, keys), 5)
        if ops_a_call != 2.0:
            raise AssertionError(f"ops.quantize_qr n={n}: {ops_a_call} device "
                                 f"operations a call, not 2 (K3, K4)")
    print(f"[kernels] K4 keyed one kernel a call, ops.quantize_qr two (K3, K4) "
          f"under torch.profiler (n = 10, {leaf_sizes[0]}, {LARGE[1]})",
          flush=True)
    del xc

    # K5: (label, x, k, cap); the threshold comes from K1
    slot_cases = [(f"main n={n}", randn(s, n), topk._k(n), topk._k(n))
                  for n in leaf_sizes]
    x = randn(4, 1000)
    x[0, 40:] = 0.0                              # 40 survivors: cap > support
    x[1] = 0.5                                   # all-equal: tie overflow
    x[1, ::2] = -0.5
    x[2, :10] = 0.0                              # zeros and -0.0
    x[2, 10:20] = -0.0
    x[3] = 0.0                                   # no survivor at all
    for k, cap in ((100, 100), (100, 250), (1000, 1000), (1, 3)):
        slot_cases.append((f"edge n=1000 k={k} cap={cap}", x, k, cap))
    slot_cases.append(("odd n=777", randn(4, 777), 77, 77))
    slot_cases.append(("n=1", randn(3, 1), 1, 1))
    slot_cases.append(("bf16 n=4096", randn(s, 4096, torch.bfloat16), 1229,
                       1229))
    slot_cases.append(("large", randn(*LARGE), LARGE[1] // 10, LARGE[1] // 10))
    # the look-back's edges (tiles of 4096): cap inside the second and the
    # last tile, cap 0 and above nnz, an all-tie row past cap, a zero row,
    # n not a multiple of 4, 74 tiles a row (look-backs past 32 tiles), an
    # odd number of tiles
    x = randn(3, leaf_sizes[0])
    for cap in (1500, topk._k(leaf_sizes[0]) - 100, 0):
        slot_cases.append((f"n={leaf_sizes[0]} cap={cap}", x,
                           topk._k(leaf_sizes[0]), cap))
    x = randn(4, 50177)
    x[1] = 0.25                                  # all ties, past cap
    x[2] = 0.0                                   # a zero row
    x[3, 100:] = 0.0                             # 100 survivors, cap above
    slot_cases.append(("n=50177 ties, zero row, cap > nnz", x, 1000, 7000))
    slot_cases.append(("n=300000 (74 tiles)", randn(3, 300000), 90000, 90000))
    slot_cases.append(("n=12288 (3 tiles a row)", randn(5, 12288), 3686, 3686))
    for label, xc, k, cap in slot_cases:
        t = tk.threshold_bits(xc, k)
        idx_r, vals_r, nnz_r = ref.compact_slots(xc, t, cap)
        for _ in range(2):     # the second call reuses the tagged workspace
            idx, vals, nnz = sk.compact_slots(xc, t, cap)
            torch.cuda.synchronize()
            if not (torch.equal(idx, idx_r) and torch.equal(nnz, nnz_r)
                    and same_bits(vals, vals_r)):
                raise AssertionError(f"K5 {label}: kernel slots differ")
        recs["K5"].err(idx, idx_r)
        recs["K5"].err(vals.float(), vals_r.float())
    print(f"[kernels] K5 bit-equal to the plain version on "
          f"{len(slot_cases)} cases, each called twice", flush=True)
    for n in (10, leaf_sizes[0], LARGE[1]):
        rows = s if n != LARGE[1] else LARGE[0]
        xc = randn(rows, n)
        t = tk.threshold_bits(xc, max(1, n // 4))
        _, ops_a_call = device_per_call(
            torch, lambda: sk.compact_slots(xc, t, max(1, n // 4)), 5)
        if ops_a_call != 1.0:
            raise AssertionError(f"K5 n={n}: {ops_a_call} device operations "
                                 f"a call, not 1")
    print(f"[kernels] K5 one kernel a call under torch.profiler (n = 10, "
          f"{leaf_sizes[0]}, {LARGE[1]})", flush=True)
    del xc

    # K6: (label, x, k, cap, r); threshold from K1, masked norm from K3
    def masked_norm(xc, t):
        keep = ref.mag_bits(xc) >= t[:, None]
        return qk.l2_norm(torch.where(keep, xc.float(),
                                      torch.zeros((), device=dev)))

    k25, k50 = TopK(0.25), TopK(0.5)
    code_slot_cases = [(f"main n={n} r=4", randn(s, n), k25._k(n),
                        k25._k(n), 4) for n in leaf_sizes]
    code_slot_cases += [(f"main n={n} r=16", randn(s, n), k50._k(n),
                         k50._k(n), 16) for n in leaf_sizes]
    x = randn(5, 1000)
    x[0, 40:] = 0.0                              # 40 survivors: cap > support
    x[1] = 0.5                                   # all-equal: tie overflow
    x[1, ::2] = -0.5
    x[2, :10] = 0.0                              # zeros and -0.0
    x[2, 10:20] = -0.0
    x[3] = 0.0                                   # no survivor, norm 0
    x[4, 7] = 1e4                                # saturates the top level
    for k, cap, r in ((100, 100, 4), (100, 250, 8), (1000, 1000, 16),
                      (1, 3, 1)):
        code_slot_cases.append((f"edge n=1000 k={k} cap={cap} r={r}", x, k,
                                cap, r))
    code_slot_cases.append(("odd n=777", randn(4, 777), 77, 77, 8))
    code_slot_cases.append(("n=1", randn(3, 1), 1, 1, 4))   # saturates
    code_slot_cases.append(("bf16 n=4096", randn(s, 4096, torch.bfloat16),
                            1024, 1024, 4))
    # K6's one launch: cap inside the second and the last tile (tiles of
    # 4096; about 1024 survivors a tile at k = n/4), cap 0 and above nnz,
    # an all-tie row past cap, a zero row and n not a multiple of 4 (x
    # above), and 74 tiles a row (look-backs past 32 tiles)
    x = randn(3, leaf_sizes[0])
    for cap in (1500, k25._k(leaf_sizes[0]) - 100, 0):
        code_slot_cases.append((f"n={leaf_sizes[0]} cap={cap}", x,
                                k25._k(leaf_sizes[0]), cap, 4))
    x = randn(4, 50177)
    x[1] = 0.25                                  # all ties, past cap
    x[2] = 0.0                                   # a zero row
    x[3, 100:] = 0.0                             # 100 survivors, cap above
    code_slot_cases.append(("n=50177 ties, zero row, cap > nnz", x, 1000,
                            7000, 8))
    code_slot_cases.append(("n=300000 (74 tiles)", randn(3, 300000), 75000,
                            75000, 4))
    code_slot_cases.append(("large", randn(*LARGE), k25._k(LARGE[1]),
                            k25._k(LARGE[1]), 8))
    for label, xc, k, cap, r in code_slot_cases:
        u = torch.rand(xc.shape, generator=gen, device=dev)
        t = tk.threshold_bits(xc, k)
        norm = masked_norm(xc, t)
        idx_r, codes_r, nnz_r = ref.compact_code_slots(xc, u, norm, t, r, cap)
        for _ in range(2):     # the second call reuses the tagged workspace
            idx, codes, nnz = sk.compact_code_slots(xc, u, norm, t, r, cap)
            torch.cuda.synchronize()
            if not (torch.equal(idx, idx_r) and torch.equal(codes, codes_r)
                    and torch.equal(nnz, nnz_r)):
                raise AssertionError(f"K6 {label}: kernel coded slots differ")
        recs["K6"].err(idx, idx_r)
        recs["K6"].err(codes, codes_r)
        del u
    print(f"[kernels] K6 bit-equal to the plain version on "
          f"{len(code_slot_cases)} cases, each called twice", flush=True)
    for n in (10, leaf_sizes[0], LARGE[1]):
        rows = s if n != LARGE[1] else LARGE[0]
        xc, u = randn(rows, n), torch.rand(rows, n, generator=gen, device=dev)
        t = tk.threshold_bits(xc, max(1, n // 4))
        norm = masked_norm(xc, t)
        _, ops_a_call = device_per_call(torch, lambda: sk.compact_code_slots(
            xc, u, norm, t, 4, max(1, n // 4)), 5)
        if ops_a_call != 1.0:
            raise AssertionError(f"K6 n={n}: {ops_a_call} device operations "
                                 f"a call, not 1")
    print(f"[kernels] K6 one kernel a call under torch.profiler (n = 10, "
          f"{leaf_sizes[0]}, {LARGE[1]})", flush=True)
    del xc, u

    # K7: (label, x, r), norm from K3
    pack_qr_cases = [(f"main n={n}", randn(s, n), 8) for n in leaf_sizes]
    x = randn(3, 1001)
    x[0, :7] = 0.0
    x[0, 7] = -0.0
    x[1] = 0.0                                   # norm 0: every code 0
    x[2, 3] = 1e4                                # saturates the top level
    for r in (1, 8, 16):
        pack_qr_cases.append((f"edge n=1001 r={r}", x, r))
    pack_qr_cases.append(("n=1", randn(3, 1), 8))  # |x| = norm: saturates
    pack_qr_cases.append(("bf16 n=4096", randn(s, 4096, torch.bfloat16), 4))
    pack_qr_cases.append(("large", randn(*LARGE), 8))
    # the keyed entry's own edges: n past 2^24 and not a multiple of 4, 40
    # rows (past the 32 whose key words ride in the launch)
    pack_qr_cases.append(("n=2^24+3", randn(2, (1 << 24) + 3), 8))
    pack_qr_cases.append(("40 rows", randn(40, 1000), 4))
    for i, (label, xc, r) in enumerate(pack_qr_cases):
        u = torch.rand(xc.shape, generator=gen, device=dev)
        keys = wide_keys(xc.shape[0], 100 + i)
        norm = qk.l2_norm(xc)
        words = qp.quantize_pack_with_uniforms(xc, r, u, norm)
        words_ref = ref.quantize_pack_with_uniforms(xc, r, u, norm)
        keyed = qp.quantize_pack_keyed(xc, r, keys, norm)
        keyed_ref = ref.quantize_pack_with_uniforms(
            xc, r, prng.uniform(keys, xc.shape[1], device=dev), norm)
        torch.cuda.synchronize()
        if not torch.equal(words, words_ref):
            raise AssertionError(f"K7 {label}: kernel words differ")
        if not torch.equal(keyed, keyed_ref):
            raise AssertionError(f"K7 keyed {label}: kernel words differ "
                                 f"from prng.uniform + the plain version")
        recs["K7"].err(words, words_ref)
        recs["K7"].err(keyed, keyed_ref)
    print(f"[kernels] K7 (both entries: reading u, and drawing it with "
          f"threefry against prng.uniform, key words >= 2^31) bit-equal to "
          f"the plain version on {len(pack_qr_cases)} cases", flush=True)

    # K8 and K9: (label, codes, b); K9 must invert K8, and its values entry
    # (r = b - 1) must equal the plain chain, K9's plain version then
    # ref.qr_values, against positive norms, a zero and a NaN one
    code_cases = [(f"main n={n}", rand_codes(s, n, 9), 9) for n in leaf_sizes]
    for n, b in ((1, 1), (33, 32), (1000, 1), (1000, 32), (4095, 17),
                 (4096, 8), (50176, 1), (50176, 17), (50176, 32)):
        code_cases.append((f"edge n={n} b={b}", rand_codes(3, n, b), b))
    code_cases.append(("n=2083 b=5", rand_codes(3, 2083, 5), 5))
    # K8 ignores a code's bits at and above b (all 32 bits random here);
    # rows whose start is 1-3 codes past a 16-byte boundary (a contiguous
    # view at a storage offset), n % 4 != 0: K8's 4-byte loads
    for n, b in ((12545, 5), (1000, 8), (4097, 17), (50176, 9)):
        code_cases.append((f"bits above b n={n} b={b}",
                           rand_codes(3, n, 32), b))
    for off, n, b in ((1, 12545, 5), (2, 1003, 17), (3, 4099, 32),
                      (1, 50177, 9)):
        flat = rand_codes(1, 3 * n + off, 32 if off == 3 else b)[0]
        code_cases.append((f"offset {off} n={n} b={b}",
                           flat[off:].view(3, n), b))
    code_cases.append(("large", rand_codes(*LARGE, 9), 9))
    neg_zeros = 0
    for label, codes, b in code_cases:
        rows, n = codes.shape
        r = b - 1
        if b > 1:                  # sign bit over level 0 heads every row
            codes[:, 0] = -(1 << 31) if r == 31 else 1 << r
        words = pk.pack_codes(codes, b)
        words_ref = ref.pack_codes(codes, b)
        back = pk.unpack_codes(words, b, n)
        back_ref = ref.unpack_codes(words, b, n)
        torch.cuda.synchronize()
        if not torch.equal(words, words_ref):
            raise AssertionError(f"K8 {label}: kernel words differ")
        if not torch.equal(back, back_ref):
            raise AssertionError(f"K9 {label}: kernel codes differ")
        if not torch.equal(back, ref.to_i32(ref.as_u32(codes)
                                            & ((1 << b) - 1))):
            raise AssertionError(f"K9(K8(c)) != c at {label} (c's bits "
                                 f"below b)")
        recs["K8"].err(words, words_ref)
        recs["K9"].err(back, back_ref)
        if b == 1:                 # r = 0: no Q_r code
            continue
        norm = torch.rand(rows, generator=gen, device=dev) + 0.5
        norm[1] = 0.0              # zero and NaN norms: +0.0 throughout
        norm[2] = float("nan")
        vals = pk.unpack_qr_values(words, r, n, norm)
        vals_ref = ref.qr_values(back_ref, norm, r)
        torch.cuda.synchronize()
        if not same_bits(vals, vals_ref):
            raise AssertionError(f"K9 values {label}: kernel values differ "
                                 f"from the plain chain")
        if not (torch.signbit(vals[0, 0]) and vals[0, 0] == 0):
            raise AssertionError(f"K9 values {label}: sign over level 0 "
                                 f"is not -0.0")
        if torch.signbit(vals[1:3]).any() or vals[1:3].any():
            raise AssertionError(f"K9 values {label}: a zero or NaN norm's "
                                 f"row is not +0.0")
        neg_zeros += int((torch.signbit(vals) & (vals == 0)).sum())
        recs["K9"].err(vals, vals_ref)
    print(f"[kernels] K8/K9 bit-equal to the plain versions and K9(K8(c)) == "
          f"c on {len(code_cases)} cases (b = 1..32, bits above b, rows 1-3 "
          f"codes off a 16-byte boundary); K9's values entry bit-equal to "
          f"the plain chain on the {len(code_cases) - 3} with b > 1 "
          f"({neg_zeros} -0.0 values, +0.0 on zero- and NaN-norm rows)",
          flush=True)
    for n in (10, leaf_sizes[0], LARGE[1]):
        rows = s if n != LARGE[1] else LARGE[0]
        xc, keys = randn(rows, n), wide_keys(rows, n)
        norm = qk.l2_norm(xc)
        words = qp.quantize_pack_keyed(xc, 8, keys, norm)
        for what, fn, want in (
                ("keyed K7", lambda: qp.quantize_pack_keyed(xc, 8, keys, norm),
                 1.0),
                ("K9 unpack_codes", lambda: pk.unpack_codes(words, 9, n), 1.0),
                ("K9 unpack_qr_values",
                 lambda: pk.unpack_qr_values(words, 8, n, norm), 1.0),
                ("ops.quantize_pack (K3, K7)",
                 lambda: ops.quantize_pack(xc, 8, keys), 2.0)):
            _, ops_a_call = device_per_call(torch, fn, 5)
            if ops_a_call != want:
                raise AssertionError(f"{what} n={n}: {ops_a_call} device "
                                     f"operations a call, not {want}")
    print(f"[kernels] keyed K7 and both K9 entries one kernel a call, "
          f"ops.quantize_pack two (K3, K7) under torch.profiler (n = 10, "
          f"{leaf_sizes[0]}, {LARGE[1]})", flush=True)
    del xc, words
    del (topk_cases, qr_cases, slot_cases, code_slot_cases, pack_qr_cases,
         code_cases)
    torch.cuda.empty_cache()

    # timings: the largest main-path leaf (5 clients x 784*64) and LARGE
    for shape, iters in (((s, leaf_sizes[0]), 200), (LARGE, 10)):
        rows, n = shape
        xc = randn(rows, n)
        xa = xc.abs()
        u = torch.rand(shape, generator=gen, device=dev)
        keys = wide_keys(rows, n)
        k = topk._k(n)
        t = tk.threshold_bits(xc, k)
        norm = qk.l2_norm(xc)
        codes = ref.qr_codes_with_uniforms(xc, 8, u, norm)
        words = pk.pack_codes(codes, 9)
        nx = rows * n
        wbytes = 4 * rows * -(-n // 32) * 9      # 9-bit words
        # K6 at the k25 cap: r = 4 on the main path's leaf, r = 8 at LARGE
        cap6, r6 = k25._k(n), (4 if shape != LARGE else 8)
        t6 = tk.threshold_bits(xc, cap6)
        norm6 = masked_norm(xc, t6)
        plans = {
            "K1": (lambda: tk.threshold_bits(xc, k),
                   lambda: ref.topk_threshold_bits(xc, k),
                   lambda: torch.topk(xa, k, dim=1, sorted=False),
                   4 * nx + 12 * rows, 16 * nx),
            # the route the main path takes: K1 and K2 in one launch; reads
            # x, writes thr and the masked rows
            "K2": (lambda: tk.threshold_mask(xc, k),
                   lambda: ref.mask_by_threshold(
                       xc, ref.topk_threshold_bits(xc, k)), None,
                   8 * nx + 12 * rows, 18 * nx),
            "K3": (lambda: qk.l2_norm(xc), lambda: ref.l2_norm(xc),
                   lambda: torch.linalg.vector_norm(xc, dim=1),
                   4 * nx + 4 * rows, 2 * nx),
            # the main path's entry: draws u with threefry; reads x, norm
            # and the keys, writes out; bound by the bytes or by the
            # uniform's integer operations on the busier integer pipe
            "K4": (lambda: qk.quantize_qr_keyed(xc, 8, keys, norm),
                   lambda: ref.quantize_qr_with_uniforms(
                       xc, 8, prng.uniform(keys, n, device=dev), norm),
                   None, 8 * nx + 4 * rows + 8 * rows, k4_int_ops * nx),
            # reads x and thr, writes cap (idx, value) slots and nnz
            "K5": (lambda: sk.compact_slots(xc, t, k),
                   lambda: ref.compact_slots(xc, t, k), None,
                   4 * nx + 8 * rows + 8 * rows * k + 4 * rows, 3 * nx),
            # the main path's entry: draws u with threefry; reads x, norm
            # and the keys, writes the words; bound by the bytes or by the
            # uniform's integer operations on the busier integer pipe
            "K7": (lambda: qp.quantize_pack_keyed(xc, 8, keys, norm),
                   lambda: ref.quantize_pack_with_uniforms(
                       xc, 8, prng.uniform(keys, n, device=dev), norm),
                   None, 4 * nx + 4 * rows + 8 * rows + wbytes,
                   k4_int_ops * nx),
            "K8": (lambda: pk.pack_codes(codes, 9),
                   lambda: ref.pack_codes(codes, 9), None,
                   4 * nx + wbytes, 9 * nx),
            # the main path's entry: the words decoded to Q_r values; reads
            # the words and norm, writes the values
            "K9": (lambda: pk.unpack_qr_values(words, 8, n, norm),
                   lambda: ref.qr_values(ref.unpack_codes(words, 9, n), norm,
                                         8), None,
                   wbytes + 4 * rows + 4 * nx, 9 * nx),
            # reads x, u at the survivors, thr and norm; writes cap
            # (idx, code) slots and nnz
            "K6": (lambda: sk.compact_code_slots(xc, u, norm6, t6, r6, cap6),
                   lambda: ref.compact_code_slots(xc, u, norm6, t6, r6, cap6),
                   None,
                   4 * nx + 4 * rows * cap6 + 12 * rows + 8 * rows * cap6
                   + 4 * rows, 3 * nx + 10 * rows * cap6),
        }
        tag = "main" if shape != LARGE else "large"
        for key_, (kern, plain, lib, nbytes, nops) in plans.items():
            rec = recs[key_]
            b_ms, b_by = bound_ms(nbytes, nops, int_peak if key_ in (
                "K4", "K7") else F32_OPS_PER_S)
            row = {"shape": list(shape),
                   "kernel_ms": time_ms(torch, kern, iters),
                   "plain_ms": time_ms(torch, plain, max(2, iters // 10)),
                   "library_ms": (time_ms(torch, lib, max(2, iters // 10))
                                  if lib is not None else None),
                   "bound_ms": b_ms, "bound_by": b_by}
            rec.timings[tag] = row
            print(f"[kernels] {key_} {rec.name} {tag} {shape}: kernel_ms="
                  f"{row['kernel_ms']!r} plain_ms={row['plain_ms']!r} "
                  f"library_ms={row['library_ms']!r} bound_ms={b_ms!r} "
                  f"({b_by})", flush=True)
            if key_ in ("K1", "K3"):
                # at the main shape both calls are host-bound: their device
                # time, from the profiler, is what the kernel itself takes
                dev_k = device_per_call(torch, kern, 50)[0]
                dev_l = device_per_call(torch, lib, 50)[0]
                print(f"[kernels] {key_} {rec.name} {tag} {shape}: device ms a "
                      f"call (torch.profiler) kernel {dev_k!r}, "
                      f"{'topk' if key_ == 'K1' else 'vector_norm'} "
                      f"{dev_l!r}", flush=True)
            if key_ == "K4":
                # the memory entry (the JAX function's counterpart), and the
                # whole main-path call against the chain it replaces
                # (prng.uniform's torch ops, K3, K4 reading u), in turns
                mem = lambda: qk.quantize_qr_with_uniforms(xc, 8, u, norm)
                before = lambda: qk.quantize_qr_with_uniforms(
                    xc, 8, prng.uniform(keys, n, device=dev), qk.l2_norm(xc))
                after = lambda: ops.quantize_qr(xc, 8, keys)
                turns = {"keyed": [], "memory": [],
                         "ops.quantize_qr before": [],
                         "ops.quantize_qr after": []}
                fns = {"keyed": kern, "memory": mem,
                       "ops.quantize_qr before": before,
                       "ops.quantize_qr after": after}
                for name_ in list(turns) + list(turns)[::-1]:
                    its = (max(2, iters // 10)
                           if name_ == "ops.quantize_qr before" else iters)
                    turns[name_].append(time_ms(torch, fns[name_], its))
                t_bytes = (8 * nx + 12 * rows) / HBM_BYTES_PER_S * 1e3
                t_int = k4_int_ops * nx / int_peak * 1e3
                t_sass = (sum(ints.values()) / 4 * nx / int_peak * 1e3
                          if ints else None)
                m_ms, m_by = bound_ms(12 * nx + 4 * rows, 10 * nx)
                row["keyed_bound_terms_ms"] = {
                    "bytes": t_bytes, "integer_operations": t_int,
                    "sass_integer_instructions_one_pipe": t_sass}
                row["memory_ms"] = min(turns["memory"])
                row["memory_bound_ms"] = m_ms
                row["ops_quantize_qr_ms"] = {
                    "before": min(turns["ops.quantize_qr before"]),
                    "after": min(turns["ops.quantize_qr after"])}
                print(f"[kernels] K4 {tag} {shape}: ms in turns {turns!r}; "
                      f"keyed bound terms: bytes {t_bytes!r} ms, integer "
                      f"operations {t_int!r} ms ({k4_int_ops!r} an element on "
                      f"the busier pipe; diagnostic: the SASS's integer "
                      f"instructions all on one pipe {t_sass!r} ms); "
                      f"memory entry bound {m_ms!r} ms ({m_by})", flush=True)
            if key_ == "K7":
                # the memory entry (the JAX function's counterpart), and the
                # whole main-path call against the chain it replaces
                # (prng.uniform's torch ops, K3, K7 reading u), in turns
                mem = lambda: qp.quantize_pack_with_uniforms(xc, 8, u, norm)
                before = lambda: qp.quantize_pack_with_uniforms(
                    xc, 8, prng.uniform(keys, n, device=dev), qk.l2_norm(xc))
                after = lambda: ops.quantize_pack(xc, 8, keys)
                fns = {"keyed": kern, "memory": mem,
                       "ops.quantize_pack before": before,
                       "ops.quantize_pack after": after}
                turns = {name_: [] for name_ in fns}
                for name_ in list(turns) + list(turns)[::-1]:
                    its = (max(2, iters // 10)
                           if name_ == "ops.quantize_pack before" else iters)
                    turns[name_].append(time_ms(torch, fns[name_], its))
                t_bytes = (4 * nx + 12 * rows + wbytes) / HBM_BYTES_PER_S * 1e3
                t_int = k4_int_ops * nx / int_peak * 1e3
                m_ms, m_by = bound_ms(8 * nx + 4 * rows + wbytes, 17 * nx)
                dev_k = device_per_call(torch, kern, 50)[0]
                dev_m = device_per_call(torch, mem, 50)[0]
                row["keyed_bound_terms_ms"] = {
                    "bytes": t_bytes, "integer_operations": t_int}
                row["keyed_ms_in_turns"] = min(turns["keyed"])
                row["memory_ms"] = min(turns["memory"])
                row["memory_bound_ms"] = m_ms
                row["device_ms_a_call"] = {"keyed": dev_k, "memory": dev_m}
                row["ops_quantize_pack_ms"] = {
                    "before": min(turns["ops.quantize_pack before"]),
                    "after": min(turns["ops.quantize_pack after"])}
                print(f"[kernels] K7 {tag} {shape}: ms in turns {turns!r}; "
                      f"device ms a call (torch.profiler) keyed {dev_k!r}, "
                      f"memory {dev_m!r}; keyed bound terms: bytes "
                      f"{t_bytes!r} ms, integer operations {t_int!r} ms; "
                      f"memory entry bound {m_ms!r} ms ({m_by})", flush=True)
            if key_ == "K9":
                # the codes entry (the JAX function's counterpart), and the
                # values entry against the chain it replaces (K9's codes,
                # then the plain decode's torch ops), in turns
                codes_fn = lambda: pk.unpack_codes(words, 9, n)
                chain = lambda: ref.qr_values(pk.unpack_codes(words, 9, n),
                                              norm, 8)
                fns = {"values": kern, "codes": codes_fn,
                       "codes + qr_values": chain}
                turns = {name_: [] for name_ in fns}
                for name_ in list(turns) + list(turns)[::-1]:
                    turns[name_].append(time_ms(torch, fns[name_], iters))
                dev_v = device_per_call(torch, kern, 50)[0]
                dev_c = device_per_call(torch, codes_fn, 50)[0]
                row["values_ms_in_turns"] = min(turns["values"])
                row["codes_ms"] = min(turns["codes"])
                row["codes_bound_ms"] = bound_ms(wbytes + 4 * nx, 9 * nx)[0]
                row["chain_ms"] = min(turns["codes + qr_values"])
                row["device_ms_a_call"] = {"values": dev_v, "codes": dev_c}
                print(f"[kernels] K9 {tag} {shape}: ms in turns {turns!r}; "
                      f"device ms a call (torch.profiler) values {dev_v!r}, "
                      f"codes {dev_c!r}", flush=True)
            if key_ == "K2":
                # the fused launch against K2's standalone kernel and the
                # two launches it replaces, in turns
                two = lambda: tk.mask_by_threshold(xc, tk.threshold_bits(xc, k))
                alone = lambda: tk.mask_by_threshold(xc, t)
                turns = {"fused": [], "K1 then K2": [], "K2 alone": []}
                for name_ in ("fused", "K1 then K2", "K2 alone") * 2:
                    fn = {"fused": kern, "K1 then K2": two,
                          "K2 alone": alone}[name_]
                    turns[name_].append(time_ms(torch, fn, iters))
                row["standalone_ms"] = min(turns["K2 alone"])
                row["k1_then_k2_ms"] = min(turns["K1 then K2"])
                row["fused_ms"] = min(turns["fused"])
                dev_f, ops_f = device_per_call(torch, kern, 50)
                dev_2, ops_2 = device_per_call(torch, two, 50)
                print(f"[kernels] K2 {tag} {shape}: ms in turns {turns!r}; "
                      f"device ms a call (torch.profiler) threshold_mask "
                      f"{dev_f!r} in {ops_f!r} operations, K1 then K2 "
                      f"{dev_2!r} in {ops_2!r}", flush=True)
        del xc, xa, u, codes, words, t6, norm6
        torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 3. train ----------------------------------------------------------- #
    ds = synthetic.make_mnist_like(n_train=8000, n_test=1000)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=20,
                                          alpha=0.7, seed=0)
    model = small.MLP(784, hidden, 10)
    loss_fn = small.cross_entropy_loss(model.apply)
    data = {d: fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                             device=d) for d in ("cuda", "cpu")}
    eval_fn = server.make_eval_fn(model.apply,
                                  torch.from_numpy(ds.x_test).to(dev),
                                  torch.from_numpy(ds.y_test).to(dev))

    def config(**over):
        return FedComLocConfig(gamma=0.1, p=0.1, n_clients=20,
                               clients_per_round=5, batch_size=32,
                               variant="com", **over)

    params0 = model.init(prng.PRNGKey(0), device=dev)
    one_client = tree_util.map(lambda p: p.detach(), params0)
    per_run = ROUNDS * len(leaf_sizes)
    zero = {name: 0 for name in ops.launch_counts()}
    k1, _, k3, k4, k5, k6, _, k8, _ = (recs[f"K{i}"].name
                                       for i in range(1, 10))
    k1k2 = FUSED_K1_K2        # K1 and K2 in one launch
    k7, k9 = KEYED_K7, VALUES_K9   # the main path's K7 and K9 entries
    double = ("k25_q4", "k50_q16")
    diverging = ("k25_q4",)       # the JAX package diverges there as well
    # name -> (compressor, config overrides, {wire: kernels the run
    # launches once per leaf per round}); Int8Sync calls no kernel
    train_runs = {
        "TopK": (TopK(0.3), {}, {"account": (k1k2,), "packed": (k1, k5)}),
        "QuantQr": (QuantQr(8), {}, {"account": (k3, k4),
                                     "packed": (k3, k7, k9)}),
        "k25_q4": (Compose(TopK(0.25), QuantQr(4)), {},
                   {"account": (k1k2, k3, k4),
                    "packed": (k1k2, k3, k6, k8, k9)}),
        "k50_q16": (Compose(TopK(0.5), QuantQr(16)), {},
                    {"account": (k1k2, k3, k4),
                     "packed": (k1k2, k3, k6, k8, k9)}),
        "Int8Sync": (Int8Sync(), {}, {"account": (), "packed": ()}),
        "ef_mom": (TopK(0.1), {"error_feedback": True, "server_momentum": 0.6},
                   {"account": (k1k2,), "packed": (k1, k5)}),
        "qr8_geometric": (QuantQr(8), {"local_steps": "geometric"},
                          {"account": (k3, k4), "packed": (k3, k7, k9)}),
    }
    replayed = (("TopK", "account"), ("TopK", "packed"), ("QuantQr", "account"),
                ("QuantQr", "packed"), ("k25_q4", "packed"),
                ("ef_mom", "account"), ("ef_mom", "packed"))
    runs = {}        # (name, wire) -> what the run gave
    launches = {}    # kernel name -> {run: launches}

    def run_once(comp, cfg, mode, eval_every=5):
        """One 20-round ``run_federated`` on the card; returns the
        algorithm, its history and the per-round metrics."""
        alg = FedComLoc(loss_fn, data["cuda"], cfg, comp)
        per_round = []
        round_fn = alg.round

        def recording_round(state, key_, _round=round_fn, _log=per_round):
            state, metrics = _round(state, key_)
            _log.append(metrics)
            return state, metrics

        alg.round = recording_round
        hist = server.run_federated(alg, params0, ROUNDS, prng.PRNGKey(1),
                                    eval_fn=eval_fn, eval_every=eval_every,
                                    wire=mode)
        del alg.round
        return alg, hist, per_round

    # prng.uniform calls a run, and the bulk ones among them (n > 1: the
    # torch threefry over a leaf); geometric phases draw single uniforms for
    # their step counts
    bulk_draws, all_draws = [0], [0]
    orig_uniform = prng.uniform

    def counting_uniform(key_, n_, device=None):
        all_draws[0] += 1
        if int(n_) > 1:
            bulk_draws[0] += 1
        return orig_uniform(key_, n_, device)

    for name, (comp, over, used_by_wire) in train_runs.items():
        for mode, used in used_by_wire.items():
            label = f"{name} {mode}"
            expect = {**zero, **{k: per_run for k in used}}
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            bulk_draws[0] = all_draws[0] = 0
            prng.uniform = counting_uniform
            t0 = time.time()
            try:
                alg, hist, per_round = run_once(comp, config(**over), mode)
                torch.cuda.synchronize()
            finally:
                prng.uniform = orig_uniform
            wall = time.time() - t0
            counts = ops.launch_counts()
            payload = sum(m.get("uplink_payload_bytes", 0.0) for m in per_round)
            steps = [int(m["num_local_steps"]) for m in per_round]
            print(f"[train] {label}: best acc {hist.best_acc!r} final train "
                  f"loss {hist.train_loss[-1]!r} uplink Mbit "
                  f"{alg.meter.uplink_bits / 1e6!r} total Mbit "
                  f"{alg.meter.total_bits / 1e6!r} uplink payload bytes "
                  f"{payload!r} local steps {steps} ms/round (eval included) "
                  f"{wall / ROUNDS * 1e3!r} launches {counts}", flush=True)
            if counts != expect:
                raise AssertionError(f"{label}: launch counts {counts} != "
                                     f"{expect}")
            for keyed in (k4, k7):
                if keyed not in used:
                    continue
                # the Q_r runs but Compose's packed ones: K4 or K7 draws
                # its own uniforms; with fixed local phases nothing else
                # calls prng.uniform
                fixed = over.get("local_steps") != "geometric"
                if bulk_draws[0] or (fixed and all_draws[0]):
                    raise AssertionError(
                        f"{label}: {all_draws[0]} prng.uniform calls, "
                        f"{bulk_draws[0]} of them bulk; the keyed {keyed} "
                        f"draws its own")
                print(f"[train] {label}: {keyed} launched {counts[keyed]} "
                      f"times (keyed), {all_draws[0]} prng.uniform calls, "
                      f"none bulk", flush=True)
            for k in used:
                launches.setdefault(k, {})[label] = counts[k]
            finite = all(map(lambda v: v == v and abs(v) != float("inf"),
                             hist.train_loss + hist.test_loss + hist.test_acc))
            if name not in diverging and (not finite or hist.best_acc <= 0.2):
                raise AssertionError(f"{label}: training went wrong: {hist}")
            if over.get("local_steps") == "geometric" and len(set(steps)) < 2:
                raise AssertionError(f"{label}: local steps not drawn: {steps}")
            runs[(name, mode)] = {
                "alg": alg, "comp": comp, "cfg": config(**over), "hist": hist,
                "payload": payload, "uplink_bits": alg.meter.uplink_bits,
                "bits": [float(m["uplink_bits"]) for m in per_round],
                "losses": [float(m["train_loss"]) for m in per_round]}

    def max_abs_diff(xs, ys):
        """Largest |x - y| where both are finite."""
        return max(float(torch.where(torch.isfinite(a) & torch.isfinite(b),
                                     (a - b).abs(), torch.zeros_like(a)).max())
                   for a, b in zip(xs, ys))

    def codec_rounds(comp, cfg):
        """A packed run of ``comp`` in which every round holds the server's
        decode of the uplink against the account transform of the same
        uplink tree and keys, on the card.  They must be equal except where
        the wire saturates a code at the top level 2^r (the value drops
        from the masked leaf's norm to norm * (2^r - 1) / 2^r) or drops a
        tie beyond the cap (the value is 0); the bits must be equal.  A
        round whose uplink is not finite lies outside the codec's contract
        and is counted, not checked.  The run also launches the account
        path, so it lies outside every counted run."""
        stats = {"checked": 0, "nonfinite": 0, "saturated": 0, "overflow": 0}
        levels = float(2 ** comp.second.r)
        orig_encode = wire.encode

        def checking_encode(comp_, stacked, keys=None):
            payload, rep = orig_encode(comp_, stacked, keys)
            leaves_ = tree_util.leaves(stacked)
            if not all(bool(torch.isfinite(l).all()) for l in leaves_):
                stats["nonfinite"] += 1
                return payload, rep
            want, want_rep = comp_.compress(stacked, keys)
            if not torch.equal(rep.total_bits, want_rep.total_bits):
                raise AssertionError(f"codec round {stats['checked']}: bits "
                                     f"{rep.total_bits} != account "
                                     f"{want_rep.total_bits}")
            got = wire.decode(payload)
            for x_, o, g, bufs in zip(leaves_, tree_util.leaves(want),
                                      tree_util.leaves(got), payload.data):
                rows_ = x_.shape[0]
                flat, of = x_.reshape(rows_, -1), o.reshape(rows_, -1)
                n_ = flat.shape[1]
                nrm = qk.l2_norm(ops.topk_mask(
                    flat, comp.first._k(n_)))[:, None]
                top = (of.abs() == nrm) & (nrm > 0)
                shipped = torch.zeros((rows_, n_ + 1), dtype=torch.bool,
                                      device=dev)
                shipped = shipped.scatter_(1, bufs[0].long(), True)[:, :n_]
                expect = torch.where(
                    top, nrm * torch.sign(of) * ((levels - 1) / levels), of)
                expect = torch.where(shipped, expect, torch.zeros_like(of))
                stats["saturated"] += int((top & shipped).sum())
                stats["overflow"] += int(((of != 0) & ~shipped).sum())
                if not torch.equal(g.reshape(rows_, -1), expect):
                    raise AssertionError(f"codec round {stats['checked']}: "
                                         f"decode != account transform")
            stats["checked"] += 1
            return payload, rep

        wire.encode = checking_encode
        try:
            run_once(comp, cfg, "packed", eval_every=ROUNDS)
        finally:
            wire.encode = orig_encode
        return stats

    def first_difference(a, b):
        """1-based index of the first round whose values differ (NaN equal
        to NaN), or None."""
        for i, (x_, y_) in enumerate(zip(a, b)):
            if x_ != y_ and not (x_ != x_ and y_ != y_):
                return i + 1
        return None

    # the packed runs against the account runs on the card
    want_per_upload = {"k25_q4": 63712, "k50_q16": 168672, "Int8Sync": 55074}
    for name, (comp, over, used_by_wire) in train_runs.items():
        pkd = runs[(name, "packed")]
        per_upload = wire.payload_nbytes(comp, one_client)
        if per_upload != want_per_upload.get(name, per_upload):
            raise AssertionError(f"{name}: {per_upload} B an upload, not "
                                 f"{want_per_upload[name]}")
        want_bytes = float(ROUNDS * s * per_upload)
        if pkd["payload"] != want_bytes:
            raise AssertionError(f"{name}: packed payload {pkd['payload']!r} "
                                 f"B != {want_bytes!r} B")
        codec = None
        if name in double:
            codec = codec_rounds(comp, pkd["cfg"])
            print(f"[train] {name}: decode == account transform of the same "
                  f"uplink in {codec['checked']} of {ROUNDS} rounds "
                  f"({codec['nonfinite']} rounds with a non-finite uplink "
                  f"not checked), bits equal; {codec['saturated']} codes "
                  f"saturated at 2^r - 1 and {codec['overflow']} ties beyond "
                  f"the cap dropped, as the wire format says", flush=True)
            if codec["checked"] == 0:
                raise AssertionError(f"{name}: no round checked")
        acc = runs[(name, "account")]
        pa = tree_util.leaves(acc["hist"].final_params)
        pp = tree_util.leaves(pkd["hist"].final_params)
        equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(pa, pp))
        summary = (f"uplink bits {pkd['uplink_bits']!r} packed vs "
                   f"{acc['uplink_bits']!r} account; payload "
                   f"{pkd['payload']!r} B as the wire format implies "
                   f"({per_upload} B an upload); params bit-equal {equal} "
                   f"(max abs diff where finite {max_abs_diff(pa, pp)!r})")
        if name in diverging or (codec and (codec["saturated"]
                                            or codec["overflow"])):
            # the wire's documented differences part the two trajectories
            print(f"[train] {name}: {summary}; the runs' per-round bits "
                  f"first differ in round "
                  f"{first_difference(pkd['bits'], acc['bits'])}, their "
                  f"losses in round "
                  f"{first_difference(pkd['losses'], acc['losses'])} (None: "
                  f"never); not held run to run, the codec check above holds "
                  f"every round", flush=True)
            continue
        if pkd["uplink_bits"] != acc["uplink_bits"]:
            raise AssertionError(f"{name}: packed uplink bits "
                                 f"{pkd['uplink_bits']!r} != account "
                                 f"{acc['uplink_bits']!r}")
        if not all(torch.allclose(b, a, rtol=PARAM_RTOL, atol=PARAM_ATOL)
                   for a, b in zip(pa, pp)):
            raise AssertionError(f"{name}: packed params differ from account "
                                 f"by more than rtol {PARAM_RTOL} atol "
                                 f"{PARAM_ATOL}: {summary}")
        print(f"[train] {name}: packed == account: {summary}; within rtol "
              f"{PARAM_RTOL} atol {PARAM_ATOL}", flush=True)

    # saturated Q_r codes on the packed QuantQr trajectory (a second run of
    # it, counting; its launches are not part of the main path's count)
    saturated = [0, 0]
    orig_pack = ops.quantize_pack

    def counting_pack(xr, r, keys):
        words_, norm_ = orig_pack(xr, r, keys)
        u_ = prng.uniform(keys, xr.shape[-1], device=xr.device)
        y = xr.abs() / torch.where(norm_ > 0, norm_, 1.0)[:, None]
        scaled = float(2 ** r) * y
        lo = torch.floor(scaled)
        level = lo + (u_ < scaled - lo).to(torch.float32)
        saturated[0] += int((level >= 2 ** r).sum())
        saturated[1] += xr.numel()
        return words_, norm_

    ops.quantize_pack = counting_pack
    try:
        server.run_federated(FedComLoc(loss_fn, data["cuda"], config(),
                                       QuantQr(8)),
                             params0, ROUNDS, prng.PRNGKey(1), wire="packed")
    finally:
        ops.quantize_pack = orig_pack
    print(f"[train] QuantQr packed: {saturated[0]} of {saturated[1]} codes "
          f"saturated at 2^r - 1", flush=True)

    profiles = {}
    for (name, mode), run in runs.items():
        label = f"{name} {mode}"
        profiles[label] = profile_rounds(torch, prng, run["alg"], params0, label)
        if (name, mode) not in replayed:
            continue

        # replay the first rounds on the card and on the CPU (plain versions)
        replay = {}
        for d in ("cuda", "cpu"):
            alg_d = FedComLoc(loss_fn, data[d], run["cfg"], run["comp"],
                              wire=mode)
            cohorts = []
            sample = alg_d.sched.sample_cohort

            def recording(key_, s_, round_idx=0, _sample=sample, _log=cohorts):
                clients, avail = _sample(key_, s_, round_idx)
                _log.append(clients.tolist())
                return clients, avail

            object.__setattr__(alg_d.sched, "sample_cohort", recording)
            state = alg_d.init({k: {kk: vv.to(d) for kk, vv in v.items()}
                                for k, v in params0.items()})
            key_ = prng.PRNGKey(1)
            rows_ = []
            for _ in range(DIVERGING_REPLAY_ROUNDS if name in diverging
                           else REPLAY_ROUNDS):
                key_, sub = prng.split(key_, 2)
                state, metrics = alg_d.round(state, sub)
                rows_.append(metrics)
            replay[d] = (cohorts, rows_)
        (c_gpu, m_gpu), (c_cpu, m_cpu) = replay["cuda"], replay["cpu"]
        if c_gpu != c_cpu:
            raise AssertionError(f"{label}: cohorts differ {c_gpu} {c_cpu}")
        exact = ["uplink_bits", "downlink_bits", "client_steps",
                 "num_local_steps"]
        if mode == "packed":
            exact += ["uplink_payload_bytes", "client_payload_bytes"]
        for r, (a, b) in enumerate(zip(m_gpu, m_cpu)):
            for key_ in exact:
                if np.asarray(a[key_]).tolist() != np.asarray(b[key_]).tolist():
                    raise AssertionError(f"{label} round {r}: {key_} "
                                         f"{a[key_]!r} != {b[key_]!r}")
            if abs(a["train_loss"] - b["train_loss"]) > LOSS_RTOL * abs(
                    b["train_loss"]):
                raise AssertionError(f"{label} round {r}: train_loss "
                                     f"{a['train_loss']!r} vs "
                                     f"{b['train_loss']!r}")
        print(f"[train] {label}: first {len(m_gpu)} rounds CUDA == CPU on "
              f"cohorts {c_gpu}, {', '.join(exact)}; train_loss within rtol "
              f"{LOSS_RTOL}: {[m['train_loss'] for m in m_gpu]!r} vs "
              f"{[m['train_loss'] for m in m_cpu]!r}", flush=True)
        torch.cuda.synchronize()
    for name in ("TopK", "QuantQr", "k25_q4"):
        interleaved_rounds(torch, prng, {
            mode: runs[(name, mode)]["alg"] for mode in ("account", "packed")},
            params0, name)
        a, p = profiles[f"{name} account"], profiles[f"{name} packed"]
        busy = ("not measured" if a["busy_ms"] is None or p["busy_ms"] is None
                else f"device busy ms/round packed {p['busy_ms']!r} vs "
                     f"account {a['busy_ms']!r}")
        print(f"[profile] {name}: steady ms/round packed {p['wall_ms']!r} vs "
              f"account {a['wall_ms']!r}; {busy}", flush=True)

    # ---- 4. fig9, 5. hetero ------------------------------------------------ #
    cifar = cifar_setup(torch, dev)
    fig9_phase(torch, dev, cifar, launches)
    hetero_phase(torch, dev, cifar, launches)
    del cifar
    torch.cuda.empty_cache()

    # ---- 6. scans, 7.-8. serve, 9. attention, 10. CUDA against CPU --------- #
    check_scan_kernels(torch, dev, recs)
    launches.update(serve_phase(torch, dev, SERVE_SHAPES)[0])
    _, captured = serve_phase(torch, dev, DENSE_SHAPES, ATTN_CAPTURE)
    launches["flash_attention"] = attention_phase(torch, dev, recs["K10"],
                                                  captured)
    del captured
    torch.cuda.empty_cache()
    cuda_vs_cpu_phase(torch, dev)

    # kernel -> (the counter of its main-path entry, the tag of its runs)
    entries = {"topk_mask": (FUSED_K1_K2, "fused"),
               "quantize_pack_with_uniforms": (KEYED_K7, "keyed"),
               "unpack_codes": (VALUES_K9, "values")}
    kernels = []
    for rec in recs.values():
        main_t = rec.timings["main"]
        by_run = launches.get(rec.name, {})
        if rec.name in entries:
            # K2 runs inside K1's launch on the main path (threshold_mask),
            # K7 as its keyed entry, K9 as its values entry; the other
            # entry serves a caller that has the threshold, u or wants
            # the codes
            counter, tag = entries[rec.name]
            by_run = {**{f"{label} ({tag})": c for label, c in
                         launches.get(counter, {}).items()}, **by_run}
        if not sum(by_run.values()):
            raise AssertionError(f"{rec.name}: launched no time on the main "
                                 f"path")
        kernels.append({
            "name": rec.name, "route": "cuda", "source": rec.source,
            **({"float32_source": csrc + "flash_attention.cu"}
               if rec.name == "flash_attention" else {}),
            **({"routes": {
                "fused": "threshold_select with K2's epilogue "
                         "(topk_compress.threshold_mask), timed as ms",
                "standalone": "mask_vec4 / mask_scalar "
                              "(topk_compress.mask_by_threshold), timed as "
                              "standalone_ms"}}
               if rec.name == "topk_mask" else {}),
            **({"routes": {
                "keyed": "qr_pack_tiles<true, *> (qr_pack.quantize_pack_keyed, "
                         "ops.quantize_pack), the main path's, timed as ms",
                "memory": "qr_pack_tiles<false, *> "
                          "(qr_pack.quantize_pack_with_uniforms), timed as "
                          "memory_ms"}}
               if rec.name == "quantize_pack_with_uniforms" else {}),
            **({"routes": {
                "values": "unpack_tiles<true, *> (pack_codes.unpack_qr_values, "
                          "ops.unpack_qr_values), the main path's, timed as ms",
                "codes": "unpack_tiles<false, *> (pack_codes.unpack_codes), "
                         "timed as codes_ms"}}
               if rec.name == "unpack_codes" else {}),
            **({"routes": {
                "tiles": "pack_tiles<*> (1024-code tiles, the register pack "
                         "of csrc/bitplane.cuh shared with K7), every shape"}}
               if rec.name == "pack_codes" else {}),
            **({"routes": {
                "slabs": "rglru_slabs<1, 32> (a channel a lane, 32-step "
                         "batches: up to 12 warps an SM, main), "
                         "rglru_slabs<2, 8> (channel pairs, 8-step batches: "
                         "past it, large); two-warp blocks, every shape"}}
               if rec.name == "rglru_scan" else {}),
            "replaces": rec.replaces, "launches": sum(by_run.values()),
            "launches_by_run": by_run,
            "max_abs_err": rec.max_abs_err, "ms": main_t["kernel_ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"], "shape": main_t["shape"],
            "large": rec.timings["large"],
            **({"served": rec.timings["served"]} if "served" in rec.timings
               else {})})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
