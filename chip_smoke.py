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
2. kernels — holds each kernel (K1 TopK threshold, K1h K1's histogram
   pass alone, on one leaf and grouped over many, K2 TopK mask, K3 l2
   norm and its sum-of-squares entry, K4 Q_r rounding, K5 slot
   compaction, K6 coded slot compaction, K7 fused Q_r pack, K8 code pack,
   K9 code unpack) against its plain PyTorch
   version on the card, at the main path's shapes, edge cases and one
   large shape: all bit-equal except K3, which must be within
   ``NORM_RTOL`` (its sum of squares' root bit-equal to it); K9 must invert K8 (K8 on b = 1..32, codes with bits
   above b, rows 1-3 codes off a 16-byte boundary).  K1's cases also take
   rows shorter than a cluster's CTAs, n not a multiple of 4, per-row k of
   0, 1, n-1, n and beyond n, +-0 / subnormals / inf / ties, and rows at
   and just past
   its clusters' shared-memory capacity; ``threshold_mask`` (K1 and K2 in
   one launch) must give K1's and K2's plain outputs on every one of them.
   K4 and K7 are held by both entries: reading u, and drawing u itself
   with threefry (key words at and above 2^31, n = 1, n = 2^24 + 3, 40
   rows) against ``prng.uniform`` + the plain version; the keyed K4 also
   with one r a row (per-client overrides), on every case.  K9 by both
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
   from the uniform's own operations, the SASS's count beside it, and its
   per-row-levels entry beside the scalar keyed entry, in turns; K7's
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
6. downlink — ``benchmarks/downlink.py``'s four arms on the card at its
   settings (the quickstart data and MLP, 20 clients, 5 a round,
   ``DOWNLINK_ROUNDS`` rounds, evaluated every 10): FedComLoc TopK(0.1)
   with the dense downlink, with a packed QuantQr(8) downlink, LoCoDL
   (``lam = 0.9``) with TopK(0.1) on both links and with Compose(TopK(0.1),
   QuantQr(8)) on both links, packed.  Uplink, downlink and total Mbit
   must equal ``benchmarks/artifacts/downlink.json``'s at its two-decimal
   rounding (but locodl_double's downlink and total, which count TopK
   ties that follow float32 rounding, ``DOWNLINK_TIES``), every compressed
   broadcast's bits must equal ``s`` x its own support's (survivors counted
   with ``torch.topk``, ties included), each arm must reach ``DOWNLINK_TARGET`` (rounds to target
   printed beside the artifact's), LoCoDL must need fewer Mbit to target
   than FedComLoc, and each run launches exactly the kernels its links
   imply; steady rounds profiled.  Then ``REPLAY_ROUNDS`` rounds of each
   compressed-downlink arm with ``downlink="account"`` must be
   bit-identical to ``"packed"``, and 4 rounds of the packed broadcast's
   slack (bytes * 8 - bits) must equal the word padding exactly for
   QuantQr(4) and stay within ``s * sum(cap) * 64`` for TopK(0.1);
7. het_system — ``benchmarks/het_system.py``'s fast rows (lognormal
   speeds and bandwidths x uniform and bandwidth-proportional densities of
   mean 0.2, waiting for all; the bandwidth allocation with deadline 10 and
   drop-out), ``FIG9_ROUNDS`` rounds on the account wire: each client's
   uplink bits must be the sum over leaves of ``k_i(leaf) * 64`` from its
   own density (float32 ``round(d * n)``), K1 + K2 launch once a leaf a
   round with one k a row, and every round is replayed on the CPU from the
   card's state (bits exact, clocks within ``CLOCK_RTOL``, loss within
   ``LOSS_RTOL``); the bandwidth/wait row is profiled beside the same
   schedule without overrides;
8. scope — the quickstart MLP for ``SCOPE_ROUNDS`` rounds under
   ``TopK(0.1, scope="global")``, ``QuantQr(8, scope="global")`` and
   ``Compose(TopK(0.25, "global"), QuantQr(4, "global"))`` on both wires
   (one launch of each kernel a round: one global unit; packed equal to
   account bit for bit, ``uplink_payload_bytes`` equal to ``s x
   wire.payload_nbytes``) and ``TopK(0.1, impl="quantile")`` on the
   account wire (no kernel); then a QuantQr(8) round with a per-client r of
   4 or 8, whose every K4 launch (one r a row) must equal ``prng.uniform``
   + the plain version bit for bit;
8b. client_mesh — the client axis over ranks (DESIGN.md §6) under an
   NCCL group of world size 1: ``CLIENT_MESH_ROUNDS`` quickstart rounds of
   FedComLoc with TopK(0.3), QuantQr(8) and k25_q4 on both wires, FedAvg
   with TopK(0.5) and LoCoDL (packed TopK(0.1) up and down) under
   ``make_client_mesh(1)`` must equal the unsharded runs bit for bit
   (state, every metric, the meter) with the same launches by kernel;
   steady ms a round, sharded and unsharded in turns;
8c. model_mesh — the model axis (DESIGN.md §9) at qwen2-0.5b's published
   width, ``MODEL_MESH_LAYERS`` of its 24 layers, float32: K1h (K1's
   histogram pass, grouped) at the encode's real leaf set of sharded
   slices (m = 2 and 4): one grouped digit and the encode's threshold
   stage (identity reduce) in turns against the per-leaf route (K1h a
   leaf, ``torch.cat``, the walk in torch operations), both against the
   slices' byte bound, with the stage's device operations; and one digit
   at the sharded embedding's slice alone; under
   NCCL at world size 1 the (1, 1, 1) mesh's FedAvg TopK(0.1) packed
   rounds equal ``make_client_mesh(1)``'s bit for bit; then 4 gloo ranks
   spawned on the card (one spawn for 8c and 8d, before phase 1: they
   import while the kernels build, then start up while both phases'
   world-size-1 parts run) run ``MODEL_MESH_WAVES``: FedAvg TopK(0.1) on
   the meshes (1, 1, 2), (2, 1, 2) and (1, 1, 4) and
   FedComLoc QuantQr(8) with the packed QuantQr(8) downlink (the
   shard-local broadcast) on (1, 1, 4), each against the flat mesh of as
   many clients ranks: bits exact (past a round with ties beyond k or a
   shard's overflow, within rtol 1e-4), ``train_loss`` within rtol 2e-3,
   round 1's model apart only where the printed ties and overflows allow
   (the state bit-equal where there are none), each rank's buffers a
   client ``per_device_payload_nbytes`` (the broadcast's too, one a round
   on every rank), and K1's histogram pass, K3's sum of squares, K5, the
   keyed K7 and K9's values entry launched on every rank (in the TopK
   runs K1h four times an encode, one grouped launch a digit; in the Q_r
   run K3 and K7 once a leaf an encode, K9 once a leaf a shard a decode);
   FedAvg's steady rounds composed and flat in turns (the ranks time-share one
   card);
8d. pod_round — ``launch/fed_train.py``'s pod round (one client a rank of
   a ``("pod", "data", "model")`` mesh, the sync as collectives) on the
   same qwen2-0.5b, 2 clients of ``POD_ROWS`` rows, ``POD_STEPS`` local
   steps, ``POD_ROUNDS`` rounds, TopK(quantile, 0.1), Q_r(8) and the int8
   sync at r = 7: under NCCL at world size 1 the (1, 1, 1) pod round
   equals the stacked round of 1 client bit for bit; then the 4 gloo
   ranks of 8c run the meshes (2, 1, 1) and (2, 2, 1), each held
   to the stacked round of the 2 clients (``POD_LOSS_RTOL``, the state
   within ``POD_STATE_ULPS``/``POD_MOVE_ULPS`` but ``POD_FLIP_SHARE`` of
   the coordinates; Q_r's and int8's ``comm_bits`` exact and at their
   closed forms, TopK's exact at data 1 and within ``POD_BITS_RTOL`` at
   data 2), each rank's bytes a collective at their closed forms (the
   dense all-reduce 4n, the int8 gather n + 4 a tensor), K3 and the keyed
   K4 once a leaf a round on every rank in the Q_r run; TopK's pod round
   and the stacked round in turns (ms a round), peak memory a rank;
9. population — ``benchmarks/population_scale.py``'s configuration at
   ``POP_N`` = 10^6 clients, not cut: ``SyntheticFederatedData`` (2048,
   hetero 0.2, noise 0.01), a diurnal + churn availability trace with the
   tree sampler, two sync tiers over 8 edges (latency 0.5), 64 clients a
   round, batch 256, TopK(0.1), ``bit_cost`` 1e-9, a pipelined
   memory-mapped ``HostStore`` spooling under a temporary directory;
   FedComLoc-Com with error feedback and LoCoDL (lam 0.5), 12 rounds each
   from key 1.  Each must give ``POP_ARTIFACT``'s size-free fields
   (``POP_FIELDS`` at the benchmark's rounding, the store counters
   ``POP_STORE_FIELDS``), one K1 + K2 launch a round, and a held-out loss
   below its start; prints ms a round, the phase split (sample, gather,
   scatter, the worker's apply and prefetch, compute), peak device memory
   and host RSS.  Then 3 rounds at 10^5 and at 10^6 (peak device memory
   equal within ``POP_MEM_REL``, below ``POP_MEM_CAP``), 3 rounds on the
   plain store (bit-equal to the pipelined one), 3 rounds with the Gumbel
   sampler on the card (each draw timed beside the tree's), and a
   profiled steady round;
10. scans — holds K11 (RG-LRU) and K12 (WKV6) against their plain versions
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
11. serve — ``rwkv6-3b`` and ``recurrentgemma-2b`` at their published
   width and depth in bf16, weights from the port's own init on the card,
   through ``launch/serve.py``'s :func:`serve`: batch 8, prompt 2560
   (above recurrentgemma's window of 2048, so the ring cache runs), 32
   greedy decode steps.  The launch counters are set to 0 just before and
   read just after: one prefill launches K12 32 times (rwkv) or K11 18
   times (recurrentgemma), and the decode steps launch neither.  Logits
   must be finite, and prefill(T) + one decode step must agree with
   prefill(T + 1)'s last logits within ``GAP_REL`` of max |logits|.
   After a warm-up at the serving shape, prints the median of
   ``SERVE_TIMED`` prefills' ms (the counted run's among them) and of the
   per-step decode ms, tokens/s, the counted run's own times, peak memory
   (weights and serve, above what earlier phases hold), and the device's
   busy time and idle share under ``torch.profiler`` for one prefill and
   for 8 decode steps;
12. dense serve — ``qwen2-7b``, ``gemma2-9b`` and ``gemma3-4b`` the same
   way at batch 4, prompt 4608 (above gemma2's window of 4096 and
   gemma3's 1024: the ring branch of prefill and the ring decode run on
   their swa layers), each freed before the next.  Their prefill attends
   through ``chunked_attention``, as the JAX package's models do, so the
   counted run launches no kernel (K10 included).  The warm-up prefill
   hands over the q/k/v of the layers in ``ATTN_CAPTURE``;
13. attention — K10 (``ops.mha_attention``: bf16 on the wgmma kernel fed
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
14. CUDA against CPU — the five models at full width and reduced depth
   (``CPU_CHECK_LAYERS``: one block pattern each, gemma3's 6 layers
   included), float32 with TF32 off, batch 2, prompt 128, 4 decode steps,
   the same weights on the card and on the CPU: logits within
   ``CPU_LOGIT_TOL`` and greedy tokens equal; then (``CPU_CHECK_MM``)
   qwen2-vl-7b with 16 seeded prefix embeddings on a vision grid
   (``grid_positions3``: t, h and w ids that differ) and its decode steps
   continuing the text ids, and seamless-m4t-large-v2 on 128 seeded
   source frames with a target prefix of 4, held the same way;
15. train — (a) K11's backward (``csrc/rglru_scan.cu``) bit-equal to its
   plain version at recurrentgemma-2b's training shape (2, 4096, 2560) and
   on edges (a = 1's inf and NaN, ragged T, D % 64 != 0), and K12's
   backward (``csrc/wkv6_bwd.cu``) within ``K12_BWD_TOL`` of its plain
   version run in float64 at rwkv6-3b's (2, 40, 4096, 64) with r/k/v in
   bf16 and in f32, w held at 1e-7 and 1 - 1e-7, T = 1, 9, 65, the
   bf16 route's chunk edges T = 15, 16, 17 and 4095 with w exactly 0 on
   whole heads, dy contiguous and dy rows off 16-byte alignment (K11
   also at B = 1, D = 2560, its fewest warps); both timed
   beside their plain versions and bounds at that shape and at the scans'
   large one; (b) one rglru block's and one rwkv time-mix's gradients at
   full width, float32, T = ``BLOCK_T``, the card against the CPU within
   ``BLOCK_GRAD_TOL``; (c) rwkv6-3b and recurrentgemma-2b at full width and
   depth, bf16, through ``steps.build_train_step`` (Adam 1e-4), batch 2,
   seq 4096 (``train_4k``'s, batch cut from 256), ``TRAIN_STEPS`` steps on
   one fixed ``make_lm_tokens`` batch: every loss finite, the last below
   the first, and each step launching the forward kernels twice a layer
   (remat) and the backward kernels once (``TRAIN_SHAPES``); ms a step,
   tokens/s and peak memory printed; the same for seamless-m4t-large-v2
   at full width and depth (2048 seeded bf16 source frames + 2048 target
   tokens), and at full width with ``TRAIN_LAYERS`` of their layers
   qwen2-vl-7b (8 of 28; 256 seeded bf16 prefix embeddings + 3840 tokens)
   and mixtral-8x7b (2 of 32), none launching a kernel; (d)
   ``build_fed_round`` on rwkv6-3b at
   full width, ``FED_CLIENTS`` stacked clients, ``FED_LOCAL_STEPS`` local
   steps, one round each with TopK(quantile, 0.1), Q_r(8) and the int8
   sync (r = 7), then the Q_r(8) rounds of seamless-m4t-large-v2 (seq
   1024: 512 frames + 512 tokens a client) and of mixtral-8x7b (2 of 32
   layers): finite losses and ``comm_bits`` equal
   to the closed form
   (TopK: the payloads' nnz times 16 + 32 bits; Q_r: 9 bits a scalar and
   32 a tensor a client; int8: 8 and 32) within the float32 report's
   rounding (``FED_BITS_ULPS`` an addition), one K3 and one keyed K4 a
   leaf in each Q_r round (their launches join the ``kernels`` line); ms
   a round and peak memory printed;
16. multimodal serve — qwen2-vl-7b at full width and depth, bf16, batch 4:
   256 seeded prefix embeddings and 4352 tokens (4608 positions) through
   ``steps.build_prefill_step``, then 32 greedy decode steps; and
   seamless-m4t-large-v2 at full width and depth, batch 8, 4096 seeded
   source frames and a target prefix of 4, through :func:`serve`, 32
   greedy steps.  The counters set to 0 before the counted run and read
   after (no launch: attention is ``chunked_attention``); finite logits;
   the median of ``SERVE_TIMED`` warm prefills and of the per-step decode
   ms, tokens/s and peak memory printed;
17. MoE — mixtral-8x7b (16 of 32 layers) and llama4-maverick-400b-a17b
   (2 of 48 layers: a dense layer, then 128 experts top-1 and the shared
   expert) at full width, bf16, through phase 11's serve
   (``MOE_SERVE``, ``MOE_SERVE_LAYERS``: batch 4, prompt 4608, 32 greedy
   steps, no launch), whose prefill(T) + decode check holds an MoE row
   only where prefill(T + 1) dropped none of its last position's routes
   and routed its first T positions as prefill(T) did (``moe_gap_rows``;
   the counts are printed); then the card against the CPU in float32
   (``MOE_CPU_CHECK``: mixtral at full width and 1 layer, llama4
   reduced), every position's logits, the prefill and 4 decode steps,
   with every MoE call's routing recorded on both sides: a token routed
   otherwise is printed with its probability gap (an expert may change
   only at a near-tie, ``FLIP_GAP``) and the rows it can reach are left
   out; every other row within ``CPU_LOGIT_TOL``, greedy tokens equal.

Prints the card's name and power limit, one line per kernel and shape, a
``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
NORM_RTOL = 1e-5               # K3 vs torch.sum: float32 sums in other orders
LOSS_RTOL = 1e-4               # cuBLAS vs CPU matmuls in the replayed rounds
PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-7   # packed vs account rounds on the card
ROUNDS = 20
REPLAY_ROUNDS = 2             # CPU replays a run
DIVERGING_REPLAY_ROUNDS = 3   # ... k25_q4's
PROFILE_ROUNDS = 2            # steady and profiled windows
FIG9_ROUNDS = 12              # benchmarks/common.py FAST_ROUNDS
DOWNLINK_ROUNDS = 60          # benchmarks/common.py FULL_ROUNDS
CLIENT_MESH_ROUNDS = 3        # the client_mesh phase's rounds a run
CLIENT_MESH_WINDOW = 3        # ... and its timed windows' rounds
CLIENT_MESH_PROFILED = ("FedComLoc TopK account", "LoCoDL packed")
MODEL_MESH_ARCH = "qwen2-0.5b"
MODEL_MESH_LAYERS = 4         # of 24: every rank on the card holds a replica
MODEL_MESH_SEQ = 512
# 2 clients, 2 a round, batch 1: at 4 the ranks' stacks, control variates
# and decoded uplinks (17-20 GB a rank) overran the H100's 80 GB
MODEL_MESH_CLIENTS = 2
MODEL_MESH_ROUNDS = 2
MODEL_MESH_GAMMA = 0.01
#: the composed meshes (clients, data, model) and their ranks
MODEL_MESH_SHAPES = {(1, 1, 2): (0, 1), (2, 1, 2): (0, 1, 2, 3),
                     (1, 1, 4): (0, 1, 2, 3)}
#: each run's flat client meshes and their ranks: a composed stage is held,
#: on its flat mesh's first rank, to the flat run of as many clients ranks
MM_FEDAVG = "FedAvg TopK(0.1)"
MM_QR = "FedComLoc QuantQr(8), downlink QuantQr(8)"
MODEL_MESH_FLAT = {MM_FEDAVG: {(1,): (1,), (2,): (0, 2)}, MM_QR: {(1,): (3,)}}
#: the stages, in waves of stages on disjoint ranks (the flat runs at
#: once): FedAvg on all three composed meshes, FedComLoc's Q_r, up and
#: down (the packed downlink: the shard-local broadcast), at m = 4 on one
#: clients rank (a FedComLoc round gathers its dense control variates
#: through the host: ~3.4 s of 5.9 at (2, 1, 2), so its runs keep to the
#: flat (1,) mesh)
MODEL_MESH_WAVES = (
    ((MM_FEDAVG, (1,)), (MM_FEDAVG, (2,)), (MM_QR, (1,))),
    ((MM_FEDAVG, (1, 1, 2)),), ((MM_FEDAVG, (2, 1, 2)),),
    ((MM_FEDAVG, (1, 1, 4)),), ((MM_QR, (1, 1, 4)),))
MODEL_MESH_TIMED = ((2, 1, 2), (2,))  # the pair timed in turns
MODEL_MESH_WORLD = 4
MODEL_MESH_JOIN_S = 400.0
MODEL_MESH_LOSS_RTOL = 2e-3   # tests/test_big_model_mesh.py's composed round
MODEL_MESH_BITS_RTOL = 1e-4   # ... and its bits, past a round with ties
#: the kernels the shard-local wire launches, on every rank
MODEL_MESH_KERNELS = ("topk_radix_hist", "sum_squares", "compact_slots",
                      "quantize_pack_keyed", "unpack_qr_values")
#: the pod round (launch/fed_train.py with a ("pod", "data", "model")
#: mesh): qwen2-0.5b at MODEL_MESH_LAYERS of 24 layers, float32, seeded
#: init, a client's batch of POD_ROWS rows (so that data = 2 splits it)
POD_ROWS = 2
POD_ROUNDS = 2
POD_STEPS = 2
POD_RUNS = {"topk (quantile, 0.1)": dict(compressor="topk", density=0.1),
            "quant r=8": dict(compressor="quant", quant_bits=8),
            "quant r=7, int8 sync": dict(compressor="quant", quant_bits=7,
                                         sync_mode="int8")}
POD_MESHES = {(2, 1, 1): (0, 1), (2, 2, 1): (0, 1, 2, 3)}
POD_TIMED = (2, 1, 1)         # timed in turns with the stacked round
POD_JOIN_S = 400.0
#: against the stacked round of the same 2 clients (PERF.md §6): the
#: loss within rtol 1e-5 in round 1 (no sync yet) and 1e-3 after (a
#: flipped Q_r level of a leaf normed at ~233 moves a weight by ~0.45); a
#: coordinate of x agrees within 4 float32 steps of its leaf's largest
#: magnitude plus 128 of the leaf's largest move from the init (the data
#: axis sums each gradient over 512 tokens, not 1024: a sum's rounding
#: grows with sqrt(1024) = 32 x its terms' cancellation, and a bias that
#: starts at zero is all move), one of h within p / gamma x 2 x POD_ROUNDS
#: times that (h sums, round by round, p / gamma times a difference of two
#: iterates), and at most 1e-6 of the coordinates (flipped Q_r levels,
#: TopK ties) may not; TopK's bits at (2, 2, 1) within rtol 1e-4.
#: Without the move term (4 steps of max |x|) 286 coordinates of TopK's
#: (2, 2, 1) passed the bound on an H100, by up to 6.6x
POD_LOSS_RTOL = (1e-5, 1e-3)
POD_STATE_ULPS = 4 * 2.0 ** -23
POD_MOVE_ULPS = 128 * 2.0 ** -23
POD_FLIP_SHARE = 1e-6
POD_BITS_RTOL = 1e-4
DOWNLINK_TARGET = 0.9         # benchmarks/downlink.py TARGET_ACC
DOWNLINK_ARTIFACT = "benchmarks/artifacts/downlink.json"
# locodl_double's downlink bits count the ties of TopK(0.1) on the mean of
# Q_r(8)-coded messages: equal levels tie, and which do follows float32
# rounding and the threefry stream the artifact was written under, so its
# downlink and total Mbit are the run's own.  They are held round by round
# to each broadcast's own support instead of to the artifact.
DOWNLINK_TIES = ("locodl_double",)
SCOPE_ROUNDS = 5
# benchmarks/population_scale.py's settings, not cut: 10^6 clients,
# (2048,) rows, 64 a round over 8 edges, batch 256, 12 rounds from key 1
POP_ARTIFACT = "benchmarks/artifacts/population_scale.json"
POP_N, POP_N_SMALL, POP_DIM, POP_COHORT, POP_EDGES = (
    1_000_000, 100_000, 2048, 64, 8)
POP_BATCH, POP_ROUNDS, POP_CHECK_ROUNDS = 256, 12, 3
# the artifact's fields that do not depend on the population size, and
# the decimals the benchmark rounds each to
POP_FIELDS = {"uplink_mbits": 3, "host_spool_mb_per_round": 4,
              "clients_aggregated": 2, "edges_aggregated": 2, "sim_time": 2}
POP_STORE_FIELDS = ("rows_gathered", "rows_scattered", "bytes_gathered",
                    "bytes_scattered", "prefetch_hits", "prefetch_misses",
                    "raw_hazards")
POP_MEM_REL = 0.05            # peak device memory, 10^5 against 10^6
POP_MEM_CAP = 2.0e9           # a quarter of one stacked (10^6, 2048) slot
# the card against the CPU on the population path: y = x @ w_c is a float32
# product of length 2048 summed in another order (|err| <= POP_Y_RTOL *
# max |y|); round 0's model after the TopK(0.1) uplink within
# LOSS_RTOL * max |x| of the CPU's
POP_Y_RTOL = 1e-5
POP_SAMPLE_CLIENTS = (0, 1, 499_999, 999_999)
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
# warm prefills timed for the median (2 since the MoE phases came: the
# earlier 3 spread by <= 6%, PERF.md section 5)
SERVE_TIMED = 2
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
# qwen2-vl-7b (2 layers) with 16 prefix embeddings on a vision grid of two
# 2 x 4 frames, and seamless-m4t-large-v2 (2 + 2 layers, 128 source
# frames, a target prefix of 4), full width, float32, on the same check
CPU_CHECK_MM = {"qwen2-vl-7b": 2, "seamless-m4t-large-v2": 2}
CPU_CHECK_PREFIX = 16
# phase 17 (MoE).  Serve at full width, bf16, batch 4, prompt 4608 (above
# mixtral's window of 4096: the ring caches run), with the depth cut to
# fit the card: mixtral-8x7b 16 of 32 layers (~23.5 B parameters, ~47 GB;
# 32 layers take ~93 GB), llama4-maverick-400b-a17b 2 of 48 (a dense
# layer, then 128 experts top-1 + the shared expert: ~18.5 B, ~37 GB; 4
# layers would take ~70 GB).  No kernel on the path.
MOE_SERVE = {arch: (4, 4608, {})
             for arch in ("mixtral-8x7b", "llama4-maverick-400b-a17b")}
MOE_SERVE_LAYERS = {"mixtral-8x7b": 16, "llama4-maverick-400b-a17b": 2}
# the card against the CPU, float32: mixtral at full width and 1 layer
# (~6.8 GB on each side), llama4 on its reduced() config (None: one MoE
# layer at full width is 64 GB in float32 on the host); a token's expert
# may change between the two only at a near-tie of the router's
# probabilities: gap <= FLIP_GAP (float32 logits agree to ~1e-6)
MOE_CPU_CHECK = (("mixtral-8x7b", 1), ("llama4-maverick-400b-a17b", None))
FLIP_GAP = 1e-4
# phase 15 (train).  K12's backward against its plain version run in
# float64, per gradient: |d| <= K12_BWD_TOL * max |plain| (+ one bf16 ulp
# of plain where the gradient comes back in bf16, its own rounding): the
# kernel's float32 sums over 4096 steps run in FMAs, shuffles and another
# order than the plain einsums.  K11's backward must be bit-equal.
K12_BWD_TOL = 1e-4
# each recurrent block's gradients at full width, float32, T = 512, the
# card against the CPU: max |d| <= BLOCK_GRAD_TOL * max |cpu| per gradient
# (cuBLAS against CPU sums at d = 2560, as CPU_LOGIT_TOL)
BLOCK_GRAD_TOL = 1e-3
BLOCK_T = 512
# the backward kernels at the training shapes (train_4k's seq 4096, batch
# cut from 256 to 2) and at the scans' large shapes
BWD_MAIN = {"K11b": (2, 4096, 2560), "K12b": (2, 40, 4096, 64)}
BWD_LARGE = {"K11b": SCAN_LARGE["K11"], "K12b": SCAN_LARGE["K12"]}
# arch -> (batch, seq, launches of one Adam step at full depth): the
# forward kernels twice (the forward, then the recompute under per-layer
# remat), the backward kernels once; rwkv6-3b has 32 rwkv layers,
# recurrentgemma-2b 18 rglru layers
TRAIN_STEPS = 4
TRAIN_SHAPES = {
    "rwkv6-3b": (2, 4096, {"wkv6_scan": 64, "wkv6_scan_bwd": 32}),
    # mixtral-8x7b's experts are bmm and einsum products: no kernel
    "mixtral-8x7b": (2, 4096, {}),
    "recurrentgemma-2b": (2, 4096, {"rglru_scan": 36, "rglru_scan_bwd": 18}),
    # seq 4096 = 256 prefix embeddings + 3840 tokens; 2048 source frames +
    # 2048 target tokens.  Their attention is chunked_attention: no kernel
    "qwen2-vl-7b": (2, 4096, {}),
    "seamless-m4t-large-v2": (2, 4096, {})}
# qwen2-vl-7b trains at full width with 8 of its 28 layers: at full depth
# its ~7.6 B parameters in bf16, their bf16 gradients and Adam's float32 m
# and v take ~91 GB of the card's 80 (8 layers: ~3.0 B, ~36 GB)
# mixtral-8x7b (train and fed round) at 2 of 32 layers: ~3.17 B
# parameters, whose bf16 weights and gradients and Adam's float32 state
# take ~38 GB (a llama4 MoE layer alone would take ~193 GB)
TRAIN_LAYERS = {"qwen2-vl-7b": 8, "mixtral-8x7b": 2}
PREFIX_SCALE = 0.02           # seeded prefix embeddings at the embed's scale
# the one-card fed round on rwkv6-3b (and, Q_r(8) only, on
# seamless-m4t-large-v2): 2 stacked clients of batch 1
FED_SEQ, FED_CLIENTS, FED_LOCAL_STEPS = 1024, 2, 2
# comm_bits against the closed form: the report is float32, as the
# reference's is, and past 2^24 bits each of its additions (a leaf's bits
# into a client's sum, then the clients' and the buckets' sums) rounds
# once: |comm_bits - closed| <= (leaves + 3) * 2^-24 * closed
FED_BITS_ULPS = 2.0 ** -24


# phase 16 (multimodal serve): qwen2-vl-7b at batch 4 with 256 seeded
# prefix embeddings and 4352 text tokens (4608 positions, the dense serves'
# shape) through steps.build_prefill_step, built for 4608 + SERVE_GEN + 1
# positions so that the decode steps have cache room; seamless-m4t-large-v2
# at batch 8 on 4096 seeded source frames with a target prefix of 4
# through serve().  Neither path launches a kernel.
VLM_SERVE = (4, 256, 4352)            # batch, prefix embeddings, tokens
ENCDEC_SERVE = (8, 4096, 4)           # batch, source frames, target prefix


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
    """Phase 9: K11 and K12 against their plain versions, then timed."""
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


class RouteRecorder:
    """Inside ``with``: every ``moe.moe_apply`` call's routing of its real
    tokens, recomputed by ``moe.route`` on the call's own input and moved
    to the host: ``calls``, one ``(x's (B, T), topi (B T, k), keep (B T,
    k), probs (B T, E))`` a call, in call order (the layers' order)."""

    def __init__(self, torch):
        from repro_torch.models import moe

        self.torch, self.moe, self.calls = torch, moe, []

    def __enter__(self):
        torch, moe = self.torch, self.moe
        orig = self.orig = moe.moe_apply

        def recording(params, x, cfg, act="silu"):
            with torch.no_grad():
                xt, n = moe.group_tokens(x, cfg)
                r = moe.route(params, xt, cfg)
                k, e = cfg.topk, cfg.n_experts
                self.calls.append((tuple(x.shape[:2]),
                                   r.topi.reshape(-1, k)[:n].cpu(),
                                   r.keep.reshape(-1, k)[:n].cpu(),
                                   r.probs.reshape(-1, e)[:n].cpu()))
            return orig(params, x, cfg, act)

        moe.moe_apply = recording
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.orig


def moe_gap_rows(torch, calls_t, calls_t1, batch: int, t: int):
    """The rows of the prefill(T) + decode against prefill(T + 1) check
    that an MoE model is held to: those whose last position prefill(T + 1)
    routed with no dropped (layer, choice) route, and whose first T
    positions it routed as prefill(T) did (the two prefills group the
    flattened tokens at other offsets past row 0, so a row's earlier
    tokens can queue, and drop, otherwise).  Returns (rows, a note with
    the counts)."""
    last = torch.zeros(batch, dtype=torch.int64)
    moved = torch.zeros(batch, dtype=torch.int64)
    dropped = routes = 0
    for (_, ti0, k0, _), (_, ti1, k1, _) in zip(calls_t, calls_t1):
        k = ti0.shape[-1]
        ti0, k0 = ti0.reshape(batch, t, k), k0.reshape(batch, t, k)
        ti1, k1 = ti1.reshape(batch, t + 1, k), k1.reshape(batch, t + 1, k)
        last += (~k1[:, t]).sum(-1)
        moved += ((ti0 != ti1[:, :t]) | (k0 != k1[:, :t])).any(-1).sum(-1)
        dropped += int((~k1).sum())
        routes += k1.numel()
    rows = [b for b in range(batch) if last[b] == 0 and moved[b] == 0]
    n_routes = len(calls_t1) * (calls_t1[0][1].shape[-1] if calls_t1 else 0)
    note = (f"; MoE: prefill(T+1) dropped {last.tolist()} of each row's last "
            f"position's {n_routes} (layer, choice) routes and routed "
            f"{moved.tolist()} of each row's first T positions otherwise "
            f"than prefill(T) (held: rows with both 0); {dropped} of its "
            f"{routes} routes dropped")
    return rows, note


def serve_phase(torch, dev, shapes: dict, capture: tuple = (),
                depth: dict = None):
    """Phases 11, 12 and 17: each model of ``shapes`` ({arch: (batch,
    prompt, launches of one prefill)}) at full width, and at full depth
    unless ``depth`` gives its layers, through serve().
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

    depth = depth or {}
    launches, captured = {}, {}
    for arch, (batch, prompt_len, want) in shapes.items():
        t_model = time.time()
        m = get_spec(arch).model
        cut = "full depth"
        if arch in depth:
            cut = f"{depth[arch]} of {m.n_layers} layers"
            m = dataclasses.replace(m, n_layers=depth[arch])
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
        # (the counted run's, which followed the warm-up, and SERVE_TIMED
        # - 1 more) and of the per-step decode times (host clock,
        # synchronised)
        max_len = prompt_len + SERVE_GEN + 1
        pre_ms, step_ms = [res.prefill_s * 1e3], []
        for _ in range(SERVE_TIMED - 1):
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
        print(f"[serve] {arch} ({cut}): {n_params} params bf16, batch "
              f"{batch} prompt {prompt_len} gen {SERVE_GEN}: prefill ms median "
              f"{pre_med!r} of {pre_ms!r}; decode ms/step median {step_med!r}"
              f" (min {min(step_ms)!r}, max {max(step_ms)!r}; "
              f"{batch * 1e3 / step_med!r} tokens/s); the counted serve "
              f"run: prefill ms {res.prefill_s * 1e3!r}, decode ms/step "
              f"{res.decode_s / SERVE_GEN * 1e3!r}; peak memory {peak} B "
              f"(max_memory_allocated over what was allocated before the "
              f"weights); launches {counts} (decode steps: none); "
              f"tokens[0][:8] {res.tokens[0, :8].tolist()}", flush=True)
        del st, logits

        # prefill(T) + one decode step against prefill(T + 1); an MoE
        # model's rows are held only where the routes agree (moe_gap_rows)
        max_len = prompt_len + 2
        with RouteRecorder(torch) as rec_t:
            _, st = tfm.prefill(params, m, prompts, max_len=max_len)
        l_step, _ = tfm.decode_step(params, m, toks[:, prompt_len], st)
        with RouteRecorder(torch) as rec_t1:
            l_long, _ = tfm.prefill(params, m, toks, max_len=max_len)
        rows, note = list(range(batch)), ""
        if m.moe is not None:
            rows, note = moe_gap_rows(torch, rec_t.calls, rec_t1.calls,
                                      batch, prompt_len)
        scale = float(l_long.abs().max())
        gap = float((l_step - l_long)[rows].abs().max()) if rows else None
        agree = float((l_step.argmax(-1) == l_long.argmax(-1)).float().mean())
        print(f"[serve] {arch}: prefill(T) + decode vs prefill(T+1): max abs "
              f"gap {gap!r} over rows {rows} of {batch} against max |logits| "
              f"{scale!r} (limit {GAP_REL} x){note}; argmax agreement "
              f"{agree!r}", flush=True)
        if gap is not None and not gap <= GAP_REL * scale:
            raise AssertionError(f"{arch}: self-consistency gap {gap!r} > "
                                 f"{GAP_REL} * {scale!r}")
        del st, l_step, l_long, rec_t, rec_t1

        # the device's busy share: one prefill, then 8 decode steps
        # the prefill's trace records the device only: the host's operator
        # events of a full-depth prefill take the profiler longer to stop
        # and parse than the prefill itself runs
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
              f"{host}; the model's serve checks took "
              f"{time.time() - t_model:.1f} s", flush=True)
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
    """Phase 12: K10 against its plain version at the JAX package's flash
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


def grid_positions3(torch, b: int, npre: int, t_text: int, device,
                    frames: int = 2, width: int = 4):
    """(B, 3, npre + t_text) M-RoPE ids: ``npre`` prefix embeddings on
    ``frames`` temporal frames of an (npre / frames / width, width) grid,
    then the text at one past the grid's largest id on all three axes."""
    per = npre // frames
    tt = torch.arange(frames).repeat_interleave(per)
    hh = torch.arange(per // width).repeat_interleave(width).repeat(frames)
    ww = torch.arange(width).repeat(frames * (per // width))
    start = int(max(tt.max(), hh.max(), ww.max())) + 1
    text = start + torch.arange(t_text)
    pos = torch.stack([torch.cat([a, text]) for a in (tt, hh, ww)])
    return pos.expand(b, 3, npre + t_text).contiguous().to(device)


def cuda_vs_cpu_phase(torch, dev) -> None:
    """Phase 14: full width, reduced depth, float32: the card (kernels)
    against the CPU (plain versions) on the same weights; then
    qwen2-vl-7b with prefix embeddings and vision-grid M-RoPE ids, and
    seamless-m4t-large-v2 on seeded source frames."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_spec
    from repro_torch.launch import serve
    from repro_torch.launch.steps import init_params
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

    for arch, n_layers in CPU_CHECK_MM.items():
        spec = get_spec(arch)
        if spec.is_encdec:
            m = dataclasses.replace(spec.model, n_enc_layers=n_layers,
                                    n_dec_layers=n_layers,
                                    dtype=torch.float32)
        else:
            m = dataclasses.replace(spec.model, n_layers=n_layers,
                                    dtype=torch.float32)
        spec = dataclasses.replace(spec, model=m)
        gen = torch.Generator(device=dev).manual_seed(1)
        params = init_params(spec, gen)
        cpu_params = tree_util.map(lambda t: t.cpu(), params)
        prompts = serve.prompts_for(m, 2, 128, dev)
        places = (("cuda", dev, params), ("cpu", torch.device("cpu"),
                                          cpu_params))
        runs = {}
        if spec.is_encdec:
            src = torch.randn((2, 128, m.d_model), generator=gen, device=dev)
            what = "128 source frames, target prefix 4"
            for label, where, p_ in places:
                res = serve.serve(p_, m, prompts[:, :4].to(where), 4,
                                  src_embeds=src.to(where))
                runs[label] = ([res.prefill_logits] + res.logits, res.tokens)
        else:
            npre = CPU_CHECK_PREFIX
            pre = torch.randn((2, npre, m.d_model), generator=gen,
                              device=dev) * PREFIX_SCALE
            pos3 = grid_positions3(torch, 2, npre, 128, dev)
            what = f"{npre} prefix embeddings on a vision grid, 128 tokens"
            for label, where, p_ in places:
                logits, st = tfm.prefill(
                    p_, m, prompts.to(where), npre + 128 + 5,
                    prefix_embeds=pre.to(where), positions3=pos3.to(where))
                seen, toks = [logits], []
                for step in range(4):
                    tok = logits.argmax(-1)
                    toks.append(tok)
                    nxt = int(pos3[0, 0, -1]) + 1 + step
                    logits, st = tfm.decode_step(
                        p_, m, tok, st, positions3=torch.full(
                            (2, 3, 1), nxt, dtype=torch.int64, device=where))
                    seen.append(logits)
                runs[label] = (seen, torch.stack(toks, 1))
        worst = max(float(((g.cpu() - c).abs() / (1 + c.abs())).max())
                    for g, c in zip(runs["cuda"][0], runs["cpu"][0]))
        same = torch.equal(runs["cuda"][1].cpu(), runs["cpu"][1])
        depth = f"{n_layers} layers" + (" a side" if spec.is_encdec else "")
        print(f"[cuda-vs-cpu] {arch} ({depth}, "
              f"d {m.d_model}, float32, {what}): max |cuda - cpu| / (1 + "
              f"|cpu|) over prefill and 4 decode logits {worst!r} (limit "
              f"{CPU_LOGIT_TOL}); greedy tokens equal {same}", flush=True)
        if not (worst <= CPU_LOGIT_TOL and same):
            raise AssertionError(f"{arch}: CUDA and CPU serving differ")
        del params, cpu_params, runs
        torch.cuda.empty_cache()


def moe_cuda_vs_cpu_phase(torch, dev, cache_dtype=None) -> None:
    """Phase 17b: the MoE models, float32 (``MOE_CPU_CHECK``), the card
    against the CPU on the same weights: batch 2, prompt 128 (every
    position's logits from ``forward_hidden``, then prefill) and 4 decode
    steps, both sides fed the CPU's greedy tokens, with KV caches of
    ``cache_dtype`` (float32 by default: the bf16 caches' rounding is
    ROADMAP Queue C's; ``torch.bfloat16`` shows it, reduced llama4's
    decode rows then parting past ``CPU_LOGIT_TOL``).  Every MoE call's
    routing is recorded on both sides (``RouteRecorder``).  A token routed
    otherwise on the card (another expert, or another route kept) is
    printed with the CPU's probability gap at its top-k boundary (a change
    of expert must be a near-tie: gap <= ``FLIP_GAP``), and the rows it
    can reach are not held: its own position and the later ones of its
    sequence, and that sequence's decode rows from the step of the change
    (every one if the prompt's routes changed).  Every other row: logits
    within ``CPU_LOGIT_TOL`` and greedy tokens equal."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_spec, reduced
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    b_, t_, steps = 2, 128, 4
    cache_dtype = cache_dtype or torch.float32
    for arch, n_layers in MOE_CPU_CHECK:
        spec = get_spec(arch)
        if n_layers is None:
            m, what = reduced(spec).model, "reduced()"
        else:
            m = dataclasses.replace(spec.model, n_layers=n_layers,
                                    dtype=torch.float32)
            what = f"full width, {n_layers} of {spec.model.n_layers} layers"
        params = tfm.init_params(m, torch.Generator(device=dev).manual_seed(1))
        cpu_params = tree_util.map(lambda x: x.cpu(), params)
        prompts = serve.prompts_for(m, b_, t_, dev)
        runs, fed = {}, None
        for label, where, p_ in (("cpu", torch.device("cpu"), cpu_params),
                                 ("cuda", dev, params)):
            rows, picks = [], []
            with torch.no_grad(), RouteRecorder(torch) as rec:
                h, _ = tfm.forward_hidden(p_, m, prompts.to(where),
                                          remat=False)
                full = tfm._unembed(p_, m, h).cpu()          # (B, T, V)
                logits, st = tfm.prefill(p_, m, prompts.to(where),
                                         t_ + steps + 1, dtype=cache_dtype)
                for step in range(steps):
                    picks.append(logits.argmax(-1).cpu())
                    rows.append(logits.cpu())
                    tok = picks[-1] if fed is None else fed[step]
                    logits, st = tfm.decode_step(p_, m, tok.to(where), st)
                rows.append(logits.cpu())
            runs[label] = (full, rows, picks, rec.calls)
            if fed is None:
                fed = picks
        (f_cpu, r_cpu, p_cpu, c_cpu), (f_gpu, r_gpu, p_gpu, c_gpu) = (
            runs["cpu"], runs["cuda"])
        # first position of each sequence whose prompt routes changed, and
        # the first decode step whose routes changed
        first_t = [t_] * b_
        first_step = [steps + 1] * b_      # logit rows held: 0 .. first - 1
        changes = []
        n_moe = sum(m.is_moe_layer(i) for i in range(m.n_layers))
        if not len(c_cpu) == len(c_gpu) == n_moe * (2 + steps):
            raise AssertionError(f"{arch}: {len(c_cpu)} / {len(c_gpu)} MoE "
                                 f"calls recorded")
        for c, ((shp, ti0, k0, pr0), (_, ti1, k1, _)) in enumerate(
                zip(c_cpu, c_gpu)):
            diff = ((ti0 != ti1) | (k0 != k1)).any(-1).reshape(shp)
            for b, t in diff.nonzero().tolist():
                kk = ti0.shape[-1]
                top = torch.sort(pr0[b * shp[1] + t], descending=True)[0]
                gap = float(top[kk - 1] - top[kk])
                flip = bool((ti0 != ti1)[b * shp[1] + t].any())
                changes.append((c, b, t, gap, flip))
                if shp[1] == t_:
                    first_t[b] = min(first_t[b], t)
                else:       # decode step c // n_moe - 2 gives row step + 1
                    first_step[b] = min(first_step[b], c // n_moe - 1)
        for b in range(b_):
            if first_t[b] < t_:
                first_step[b] = 0
        def rel(g, c_):
            return float(((g - c_).abs() / (1 + c_.abs())).max())

        worst_t = worst_s = 0.0           # prompt positions; prefill + decode
        held, same = 0, True
        for b in range(b_):
            n = first_t[b]
            if n:
                worst_t = max(worst_t, rel(f_gpu[b, :n], f_cpu[b, :n]))
                held += n
            for s_ in range(min(first_step[b], steps + 1)):
                worst_s = max(worst_s, rel(r_gpu[s_][b], r_cpu[s_][b]))
                held += 1
                if s_ < steps:
                    same &= bool(p_gpu[s_][b] == p_cpu[s_][b])
        worst = max(worst_t, worst_s)
        report = "; ".join(
            f"call {c} row {b} position {t}: "
            f"{'expert changed' if flip else 'kept route changed'}, CPU "
            f"probability gap {gap!r}" for c, b, t, gap, flip in changes)
        print(f"[cuda-vs-cpu] {arch} ({what}, d {m.d_model}, float32, "
              f"{str(cache_dtype).split('.')[-1]} KV caches, batch {b_}, "
              f"prompt {t_}, {steps} decode steps fed the CPU's greedy "
              f"tokens): tokens routed otherwise on the card: "
              f"{len(changes)}{' (' + report + ')' if changes else ''}; held "
              f"{held} of {b_ * (t_ + steps + 1)} logit rows (positions "
              f"before the first change {first_t}, prefill and decode rows "
              f"before {first_step}): max |cuda - cpu| / (1 + |cpu|) {worst!r}"
              f" (every position {worst_t!r}, prefill and decode rows "
              f"{worst_s!r}; limit {CPU_LOGIT_TOL}); greedy tokens equal "
              f"{same}", flush=True)
        if any(flip and gap > FLIP_GAP for _, _, _, gap, flip in changes):
            raise AssertionError(f"{arch}: an expert changed past a near-tie")
        if not (held and worst <= CPU_LOGIT_TOL and same):
            raise AssertionError(f"{arch}: CUDA and CPU serving differ")
        del params, cpu_params, runs
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
                  close=(), x_rtol=None) -> None:
    """``rounds`` rounds of ``make("cuda")`` from ``params0``, each round
    replayed on the CPU (the plain versions) by ``make("cpu")`` from the
    card's state before it, with the same key: cohorts and the ``exact``
    metrics equal, the ``close`` ones within rtol ``CLOCK_RTOL``, the train
    loss within ``LOSS_RTOL``.  Starting every CPU round from the card's
    state keeps a TopK selection that float32 rounding flipped in one
    round out of the next round's loss: on the CNN with TopK(0.1), scaling
    the init by 1 + 1e-7 moves round 3's train loss by up to 1.8e-3
    (relative) on the CPU alone.  ``x_rtol`` also holds each round's
    model to the CPU's within ``x_rtol * max |x|``.  Both algorithms are
    initialised; with a host store each side keeps its own rows, so such
    a replay holds round 0 only."""
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

        def recording(key_, s_, round_idx=0, device=None, _sample=sample,
                      _log=log):
            clients, avail = _sample(key_, s_, round_idx, device=device)
            _log.append(clients.tolist())
            return clients, avail

        object.__setattr__(algs[d].sched, "sample_cohort", recording)
    algs["cpu"].init(tree_util.map(lambda t: t.cpu(), params0))
    state, key, losses = algs["cuda"].init(params0), prng.PRNGKey(1), []
    x_err = []
    for r in range(rounds):
        key, sub = prng.split(key, 2)
        cpu_state, b = algs["cpu"].round(to(state, "cpu"), sub)
        state, a = algs["cuda"].round(state, sub)
        if x_rtol is not None:
            for xa, xb in zip(tree_util.leaves(state.x),
                              tree_util.leaves(cpu_state.x)):
                err = float((xa.cpu() - xb).abs().max())
                lim = x_rtol * float(xb.abs().max())
                x_err.append(err)
                if not err <= lim:
                    raise AssertionError(f"{label} round {r}: x differs by "
                                         f"{err!r} (limit {lim!r})")
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
          f"train_loss (card, CPU) within rtol {LOSS_RTOL}: {losses!r}"
          + (f"; x within {x_rtol} * max |x|, max abs err {x_err!r}"
             if x_rtol is not None else ""), flush=True)


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


def counted(torch, ops, fn):
    """``fn()`` with every launch counter set to 0 just before and read
    just after: ``(fn's result, the non-zero counts)``."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in ops.launch_counts().items() if v}


def recording_rounds(alg):
    """Wrap ``alg.round`` so that each round's metrics land in the returned
    list; ``del alg.round`` restores it."""
    log = []
    round_fn = alg.round

    def recording(state, key_, _round=round_fn):
        state, metrics = _round(state, key_)
        log.append(metrics)
        return state, metrics

    alg.round = recording
    return log


def topk_qr_checking_encode(torch, wire, stats: dict):
    """A ``wire.encode`` that holds every ``topk_qr`` payload's decode to
    the account transform of the same input and keys: equal but where a
    survivor tied beyond the cap is dropped (0) or a code saturates at the
    top level (``norm (2^r - 1) / 2^r`` for ``norm``); counts both in
    ``stats``, with the payloads, and raises on any other difference or on
    bits that differ."""
    orig = wire.encode

    def encode(comp, stacked, keys=None):
        payload, rep = orig(comp, stacked, keys)
        want, want_rep = comp.compress(stacked, keys)
        if not torch.equal(rep.total_bits, want_rep.total_bits):
            raise AssertionError(f"topk_qr payload: bits {rep.total_bits} "
                                 f"!= account {want_rep.total_bits}")
        levels = float(2 ** comp.second.r)
        got = wire.decode(payload)
        from repro_torch import tree as tree_util
        for o, g, bufs in zip(tree_util.leaves(want), tree_util.leaves(got),
                              payload.data):
            rows, of = o.shape[0], o.reshape(o.shape[0], -1)
            n = of.shape[1]
            shipped = torch.zeros((rows, n + 1), dtype=torch.bool,
                                  device=of.device)
            shipped = shipped.scatter_(1, bufs[0].long(), True)[:, :n]
            nrm = bufs[2][:, None]
            top = (of.abs() == nrm) & (nrm > 0)
            expect = torch.where(
                top, nrm * torch.sign(of) * ((levels - 1) / levels), of)
            expect = torch.where(shipped, expect, torch.zeros_like(of))
            if not torch.equal(g.reshape(rows, -1), expect):
                raise AssertionError("topk_qr payload: decode != account "
                                     "transform beyond ties and saturation")
            stats["saturated"] += int((top & shipped).sum())
            stats["overflow"] += int(((of != 0) & ~shipped).sum())
        stats["payloads"] += 1
        return payload, rep

    return encode


def downlink_phase(torch, dev, mnist, launches: dict) -> None:
    """Phase 6: ``benchmarks/downlink.py``'s four arms on the card at its
    settings, held to ``benchmarks/artifacts/downlink.json``'s Mbit, then
    account == packed on the compressed downlinks and the broadcast's
    per-round reconcile."""
    import numpy as np

    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.compress import Compose, QuantQr, TopK, wire
    from repro_torch.core import clients as clients_mod
    from repro_torch.core import fedcomloc as fedcomloc_mod
    from repro_torch.core import locodl as locodl_mod
    from repro_torch.core import server
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.core.locodl import LoCoDL, LoCoDLConfig
    from repro_torch.kernels import ops

    orig_encode = wire.encode
    art = {row["name"].split("/", 1)[1]: row for row in json.loads(
        (ROOT / DOWNLINK_ARTIFACT).read_text())["rows"]}
    loss_fn, data, eval_fn = mnist["loss_fn"], mnist["data"], mnist["eval_fn"]
    params0 = mnist["params0"]
    n_leaves = len(tree_util.leaves(params0))
    s = 5

    def fedcomloc(d, **kw):
        cfg = FedComLocConfig(gamma=0.1, p=0.1, n_clients=20,
                              clients_per_round=s, batch_size=32,
                              variant="com")
        return FedComLoc(loss_fn, data[d], cfg, TopK(0.1), **kw)

    def locodl(d, comp, **kw):
        cfg = LoCoDLConfig(gamma=0.1, p=0.1, lam=0.9, n_clients=20,
                           clients_per_round=s, batch_size=32)
        return LoCoDL(loss_fn, data[d], cfg, comp, **kw)

    double = lambda: Compose(TopK(0.1), QuantQr(8))
    arms = {
        "fedcomloc": lambda d, dl="dense": fedcomloc(d),
        "fedcomloc_packed_down": lambda d, dl="packed": fedcomloc(
            d, downlink=dl, downlink_compressor=QuantQr(8)),
        "locodl": lambda d, dl="packed": locodl(
            d, TopK(0.1), wire="packed", downlink=dl,
            downlink_compressor=TopK(0.1)),
        "locodl_double": lambda d, dl="packed": locodl(
            d, double(), wire="packed", downlink=dl,
            downlink_compressor=double()),
    }
    per_round = DOWNLINK_ROUNDS * n_leaves
    # kernel -> launches a leaf a round: the uplink's and the downlink's
    expect = {
        "fedcomloc": {FUSED_K1_K2: 1},
        "fedcomloc_packed_down": {FUSED_K1_K2: 1, "l2_norm": 1,
                                  KEYED_K7: 1, VALUES_K9: 1},
        "locodl": {"topk_threshold_bits": 2, "compact_slots": 2},
        "locodl_double": {FUSED_K1_K2: 2, "l2_norm": 2,
                          "compact_code_slots": 2, "pack_codes": 2,
                          VALUES_K9: 2},
    }
    # every compressed broadcast's bits, against its own support: s x
    # (survivors x value and index bits + norms), the survivors counted
    # with torch.topk, ties at the k-th magnitude included
    checked = [0]
    seams = (fedcomloc_mod, locodl_mod)
    orig_seam = clients_mod.apply_downlink

    def checking_seam(mode, comp, ctx, ref, x_new, key, s_):
        y_new, bits, extras = orig_seam(mode, comp, ctx, ref, x_new, key, s_)
        delta = [a - b for a, b in zip(tree_util.leaves(x_new),
                                       tree_util.leaves(ref))]
        topk = comp.first if isinstance(comp, Compose) else comp
        want = 0
        for leaf in delta:
            flat = leaf.reshape(-1)
            if isinstance(topk, TopK):
                mag = flat.abs()
                kth = torch.topk(mag, topk._k(flat.numel())).values.min()
                kept = int(((mag >= kth) & (mag > 0)).sum())
            else:
                kept = flat.numel()
            width = 64 if isinstance(comp, TopK) else 1 + (
                comp.second.r if isinstance(comp, Compose) else comp.r) + (
                32 if isinstance(comp, Compose) else 0)
            want += kept * width + (0 if isinstance(comp, TopK) else 32)
        if float(bits) != float(s_ * want):
            raise AssertionError(f"downlink: a broadcast's bits {bits} != "
                                 f"{s_} x {want} from its own support")
        checked[0] += 1
        return y_new, bits, extras

    for mod in seams:
        mod.apply_downlink = checking_seam
    to_target = {}
    for name, make in arms.items():
        label = f"downlink {name}"
        alg = make("cuda")
        checked[0] = 0
        t0 = time.time()
        hist, counts = counted(torch, ops, lambda: server.run_federated(
            alg, params0, DOWNLINK_ROUNDS, prng.PRNGKey(1), eval_fn=eval_fn,
            eval_every=max(1, DOWNLINK_ROUNDS // 6)))
        wall = time.time() - t0
        want_counts = {k: c * per_round for k, c in expect[name].items()}
        if counts != want_counts:
            raise AssertionError(f"{label}: launch counts {counts} != "
                                 f"{want_counts}")
        for k, c in counts.items():
            launches.setdefault(k, {})[label] = c
        m = alg.meter
        got = {"uplink_mbits": round(m.uplink_bits / 1e6, 2),
               "downlink_mbits": round(m.downlink_bits / 1e6, 2),
               "total_mbits": round(m.total_bits / 1e6, 2)}
        want = {k: art[name][k] for k in got}
        if name in DOWNLINK_TIES:
            del want["downlink_mbits"], want["total_mbits"]
        hit = next(((b, r) for a, b, r in zip(hist.test_acc, hist.total_bits,
                                               hist.rounds)
                    if a >= DOWNLINK_TARGET), (None, None))
        to_target[name] = hit[0]
        print(f"[downlink] {name}: uplink/downlink/total Mbit {got} "
              f"(held to {want}; artifact "
              f"{ {k: art[name][k] for k in got} }); best_acc {hist.best_acc!r} (artifact "
              f"{art[name]['best_acc']}); rounds_to_target {hit[1]} "
              f"(artifact {art[name]['rounds_to_target']}); Mbit to target "
              f"{None if hit[0] is None else hit[0] / 1e6!r} (artifact "
              f"{art[name]['mbits_to_target']}); ms/round (eval included) "
              f"{wall / DOWNLINK_ROUNDS * 1e3!r}; launches {counts}",
              flush=True)
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"{label}: Mbit {got} != {want}")
        if checked[0] != (0 if name == "fedcomloc" else DOWNLINK_ROUNDS):
            raise AssertionError(f"{label}: {checked[0]} broadcasts checked")
        if hit[0] is None:
            raise AssertionError(f"{label}: never reached {DOWNLINK_TARGET}: "
                                 f"{hist.test_acc}")
        p = profile_rounds(torch, prng, alg, params0, label)
        print(f"[downlink] {name}: steady ms/round {p['wall_ms']!r}, device "
              f"busy ms/round {p['busy_ms']!r}, device operations a round "
              f"{p['device_ops']!r}", flush=True)
    for mod in seams:
        mod.apply_downlink = orig_seam
    if not to_target["locodl"] < to_target["fedcomloc"]:
        raise AssertionError(f"locodl needs {to_target['locodl']} bits to "
                             f"{DOWNLINK_TARGET}, not fewer than fedcomloc's "
                             f"{to_target['fedcomloc']}")

    # account == packed on the compressed downlinks, REPLAY_ROUNDS each.  The
    # topk_qr wire keeps the lowest-index cap of the survivors tied at the
    # threshold and saturates the top level at 2^r - 1 (its format), and
    # the mean of Q_r-coded messages that locodl_double broadcasts ties by
    # the thousand: there every payload's decode is held to the account
    # transform of the same input, but for those two, and the runs part
    for name in ("fedcomloc_packed_down", "locodl", "locodl_double"):
        stats = {"payloads": 0, "saturated": 0, "overflow": 0}
        res = {}
        for dl in ("account", "packed"):
            alg = arms[name]("cuda", dl)
            if dl == "packed" and name in DOWNLINK_TIES:
                wire.encode = topk_qr_checking_encode(torch, wire, stats)
            try:
                res[dl] = alg.run_rounds(alg.init(params0), prng.PRNGKey(1),
                                         REPLAY_ROUNDS)
            finally:
                wire.encode = orig_encode
        (sa, ma), (sp, mp) = res["account"], res["packed"]
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(tree_util.leaves(sa.x),
                                   tree_util.leaves(sp.x)))
        keys_ = ("downlink_bits", "uplink_bits", "client_uplink_bits")
        bits = all(np.array_equal(ma[k], mp[k]) for k in keys_)
        if name in DOWNLINK_TIES:
            first = all(np.array_equal(ma[k][0], mp[k][0]) for k in keys_)
            if not (first and stats["payloads"] == 2 * REPLAY_ROUNDS):
                raise AssertionError(f"downlink {name}: round 1's bits "
                                     f"{first}, {stats}")
            print(f"[downlink] {name}: {stats['payloads']} packed payloads "
                  f"(uplink and downlink, {REPLAY_ROUNDS} rounds) decode to "
                  f"the account transform of the same input but for "
                  f"{stats['overflow']} ties beyond the cap and "
                  f"{stats['saturated']} saturated codes; round 1's bits "
                  f"equal; params bit-equal after {REPLAY_ROUNDS} rounds "
                  f"{same}, bits {bits}", flush=True)
            continue
        if not (same and bits):
            raise AssertionError(f"downlink {name}: account != packed "
                                 f"(params {same}, bits {bits})")
        print(f"[downlink] {name}: {REPLAY_ROUNDS} rounds with "
              f"downlink=\"account\" bit-identical to \"packed\": params and "
              f"bits {mp['downlink_bits'].tolist()}", flush=True)

    # the packed broadcast's slack, every round: exactly the word padding
    # for qr_r4, within s * sum(cap) * 64 for topk_d0.1
    sizes = [p.numel() for p in tree_util.leaves(params0)]
    for label, comp in (("topk_d0.1", TopK(0.1)), ("qr_r4", QuantQr(4))):
        alg = fedcomloc("cuda", downlink="packed", downlink_compressor=comp)
        _, m = alg.run_rounds(alg.init(params0), prng.PRNGKey(9), 4)
        slack = m["downlink_payload_bytes"] * 8.0 - m["downlink_bits"]
        if label == "qr_r4":
            pad = float(sum((32 * -(-n // 32) - n) * 5 for n in sizes))
            ok = bool(np.all(slack == s * pad))
        else:
            pad = float(sum(comp._k(n) * 64 for n in sizes))
            ok = bool(np.all((slack >= 0) & (slack <= s * pad)))
        print(f"[downlink] reconcile {label}: slack bits {slack.tolist()} "
              f"against {s * pad!r} ({'equal' if label == 'qr_r4' else 'bound'}"
              f"; artifact {art['reconcile_' + label]['expected_slack_bits']})",
              flush=True)
        if not ok:
            raise AssertionError(f"downlink reconcile {label}: {slack} vs "
                                 f"{s * pad}")


def het_system_phase(torch, dev, mnist, launches: dict) -> None:
    """Phase 7: ``benchmarks/het_system.py``'s fast rows on the card,
    account wire: lognormal speeds and bandwidths x uniform and
    bandwidth-proportional densities waiting for every client, and the
    bandwidth allocation with a deadline that drops stragglers."""
    import numpy as np

    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.compress import TopK
    from repro_torch.compress.compressors import override_k
    from repro_torch.core import server
    from repro_torch.core.clients import ClientProfile, ClientSchedule
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.kernels import ops

    loss_fn, data, eval_fn = mnist["loss_fn"], mnist["data"], mnist["eval_fn"]
    params0 = mnist["params0"]
    sizes = [p.numel() for p in tree_util.leaves(params0)]
    s = 5
    cfg = FedComLocConfig(gamma=0.1, p=0.1, n_clients=20, clients_per_round=s,
                          batch_size=32, variant="com")
    rows = (("uniform", "wait"), ("bandwidth", "wait"), ("bandwidth", "drop"))
    exact = ["client_steps", "uplink_bits", "downlink_bits",
             "client_uplink_bits", "clients_aggregated"]
    for alloc, policy in rows:
        label = f"het_system lognormal_{alloc}_{policy}"
        profile = ClientProfile.lognormal(
            20, speed_sigma=1.0, bandwidth_sigma=0.7,
            seed=0).with_density_allocation(0.2, mode=alloc)
        dens = profile.comp_params["density"]
        if abs(float(dens.double().mean()) - 0.2) > 1e-6:
            raise AssertionError(f"{label}: mean density {dens.mean()}")
        kw = ({"deadline": 10.0, "drop_stragglers": True}
              if policy == "drop" else {})

        def make(d, _profile=profile, _kw=kw):
            return FedComLoc(loss_fn, data[d], cfg, TopK(density=0.2),
                             schedule=ClientSchedule(_profile, bit_cost=1e-7,
                                                     **_kw))

        alg = make("cuda")
        # each round's uplink rows and per-client densities, as the
        # compressor receives them
        uploads = []
        compress_fn = alg.comp.compress

        def recording(stacked, keys=None, _compress=compress_fn, **ov):
            uploads.append((tree_util.map(lambda t: t.detach().clone(),
                                          stacked), ov["density"]))
            return _compress(stacked, keys, **ov)

        object.__setattr__(alg.comp, "compress", recording)
        per_round = recording_rounds(alg)
        hist, counts = counted(torch, ops, lambda: server.run_federated(
            alg, params0, FIG9_ROUNDS, prng.PRNGKey(1), eval_fn=eval_fn,
            eval_every=max(1, FIG9_ROUNDS // 6)))
        del alg.round
        # K1 + K2 in one launch a leaf a round, with one k a client's row
        want_counts = {FUSED_K1_K2: FIG9_ROUNDS * len(sizes)}
        if counts != want_counts:
            raise AssertionError(f"{label}: launch counts {counts} != "
                                 f"{want_counts}")
        launches.setdefault(FUSED_K1_K2, {})[label + " (per-row k)"] = \
            counts[FUSED_K1_K2]
        # each client's bits: 64 a survivor of its own k_i(leaf) =
        # round(float32(d_i) * float32(n)) clipped to [1, n] (more only
        # where magnitudes tie at the k-th, counted here with torch.topk)
        ties = 0
        for r, (m, (stacked, d)) in enumerate(zip(per_round, uploads)):
            k_sum = torch.zeros(s, dtype=torch.int64)
            kept = torch.zeros(s, dtype=torch.int64)
            for leaf in tree_util.leaves(stacked):
                rows_ = leaf.reshape(s, -1)
                n = rows_.shape[1]
                k = torch.clamp(override_k(d, n), 1, n)
                k_sum += k
                for i in range(s):
                    mag = rows_[i].abs()
                    kth = torch.topk(mag, int(k[i])).values.min()
                    kept[i] += int(((mag >= kth) & (mag > 0)).sum())
            want = (kept.to(torch.float32) * 64.0).numpy()
            part = m["client_steps"] > 0
            ties += int((kept - k_sum)[torch.from_numpy(part)].sum())
            got = m["client_uplink_bits"]
            if not (np.array_equal(got[part], want[part])
                    and np.all(got[~part] == 0)):
                raise AssertionError(f"{label} round {r}: client bits "
                                     f"{got} != {want} (participating "
                                     f"{part})")
        sim = sum(float(m["sim_time"]) for m in per_round)
        print(f"[het_system] {label}: best_acc {hist.best_acc!r} total Mbit "
              f"{alg.meter.total_bits / 1e6!r} summed sim_time {sim!r}; "
              f"densities {sorted(set(dens.tolist()))[:3]}... mean "
              f"{float(dens.double().mean())!r}; each client's bits = "
              f"sum of k_i(leaf) * 64 in all {FIG9_ROUNDS} rounds, plus 64 "
              f"for each of {ties} survivors tied at a k-th magnitude; "
              f"launches {counts}", flush=True)
        replay_on_cpu(torch, prng, make, params0, FIG9_ROUNDS, label, exact,
                      close=("sim_time", "client_finish"))
        if (alloc, policy) == ("bandwidth", "wait"):
            # the override round against its parent: the same schedule with
            # no per-client density (TopK(0.2) for every client)
            plain_sched = ClientSchedule(ClientProfile.lognormal(
                20, speed_sigma=1.0, bandwidth_sigma=0.7, seed=0),
                bit_cost=1e-7)
            parent = FedComLoc(loss_fn, data["cuda"], cfg, TopK(density=0.2),
                               schedule=plain_sched)
            for tag, a in (("overrides", alg), ("no overrides", parent)):
                p = profile_rounds(torch, prng, a, params0,
                                   f"{label} {tag}")
                print(f"[het_system] {label} {tag}: steady ms/round "
                      f"{p['wall_ms']!r}, device busy ms/round "
                      f"{p['busy_ms']!r}, device operations a round "
                      f"{p['device_ops']!r}", flush=True)
            interleaved_rounds(torch, prng, {"overrides": alg,
                                             "no overrides": parent},
                               params0, label)


def scope_phase(torch, dev, mnist, launches: dict) -> None:
    """Phase 8: the quickstart MLP under global-scope TopK, QuantQr and
    Compose on both wires and a quantile TopK, then a QuantQr(8) round
    with a per-client r of 4 or 8."""
    import numpy as np

    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.compress import Compose, QuantQr, TopK, wire
    from repro_torch.core.clients import ClientProfile, ClientSchedule
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quantize as qk

    loss_fn, data, params0 = mnist["loss_fn"], mnist["data"], mnist["params0"]
    one_client = tree_util.map(lambda p: p.detach(), params0)
    s = 5
    cfg = FedComLocConfig(gamma=0.1, p=0.1, n_clients=20, clients_per_round=s,
                          batch_size=32, variant="com")
    k1k2, k3, k4 = FUSED_K1_K2, "l2_norm", "quantize_qr"
    # name -> (compressor, {wire: kernels launched once a round: one
    # global unit})
    runs = {
        "topk_global": (TopK(0.1, scope="global"),
                        {"account": (k1k2,), "packed": (k1k2, "compact_slots")}),
        "qr_global": (QuantQr(8, scope="global"),
                      {"account": (k3, k4), "packed": (k3, KEYED_K7, VALUES_K9)}),
        "compose_global": (Compose(TopK(0.25, "global"), QuantQr(4, "global")),
                           {"account": (k1k2, k3, k4),
                            "packed": (k1k2, k3, "compact_code_slots",
                                       "pack_codes", VALUES_K9)}),
        "topk_quantile": (TopK(0.1, impl="quantile"), {"account": ()}),
    }
    for name, (comp, by_wire) in runs.items():
        res = {}
        for mode, used in by_wire.items():
            label = f"scope {name} {mode}"
            alg = FedComLoc(loss_fn, data["cuda"], cfg, comp, wire=mode)
            (state, m), counts = counted(torch, ops, lambda: alg.run_rounds(
                alg.init(params0), prng.PRNGKey(1), SCOPE_ROUNDS))
            want_counts = {k: SCOPE_ROUNDS for k in used}
            if counts != want_counts:
                raise AssertionError(f"{label}: launch counts {counts} != "
                                     f"{want_counts}")
            for k, c in counts.items():
                launches.setdefault(k, {})[label] = c
            losses = m["train_loss"].tolist()
            if not all(map(math.isfinite, losses)):
                raise AssertionError(f"{label}: losses {losses}")
            res[mode] = (state, m)
            print(f"[scope] {label}: train loss {losses!r}, uplink Mbit "
                  f"{float(m['uplink_bits'].sum()) / 1e6!r}; launches "
                  f"{counts}", flush=True)
        if "packed" not in res:
            continue
        (sa, ma), (sp, mp) = res["account"], res["packed"]
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(tree_util.leaves(sa.x),
                                   tree_util.leaves(sp.x)))
        bits = all(np.array_equal(ma[k], mp[k]) for k in (
            "uplink_bits", "client_uplink_bits", "train_loss"))
        nbytes = wire.payload_nbytes(comp, one_client)
        payload = bool(np.all(mp["uplink_payload_bytes"] == s * nbytes))
        if not (same and bits and payload):
            raise AssertionError(f"scope {name}: packed != account (params "
                                 f"{same}, bits {bits}, payload bytes "
                                 f"{mp['uplink_payload_bytes']} vs "
                                 f"{s} x {nbytes}: {payload})")
        print(f"[scope] {name}: packed == account bit for bit (params, bits, "
              f"losses); uplink_payload_bytes {s} x {nbytes} = "
              f"wire.payload_nbytes a round", flush=True)

    # QuantQr(8) with r = 4 or 8 a client: every leaf's K4 launch, with one
    # level count a row, against prng.uniform + the plain version
    r_of = torch.tensor([4, 8] * 10)
    sched = ClientSchedule(ClientProfile.homogeneous(20).with_comp_param(
        "r", r_of))
    alg = FedComLoc(loss_fn, data["cuda"], cfg, QuantQr(8), schedule=sched)
    checked = []
    orig = ops.quantize_qr

    def checking(x, r, keys):
        out = orig(x, r, keys)
        plain = ref.quantize_qr_with_uniforms(
            x, r, prng.uniform(keys, x.shape[-1], device=x.device),
            qk.l2_norm(x))
        if not (isinstance(r, torch.Tensor) and torch.equal(
                out.view(torch.int32), plain.view(torch.int32))):
            raise AssertionError(f"scope per-client r: K4 per-row output "
                                 f"differs from the plain version (r {r})")
        checked.append(r.tolist())
        return out

    ops.quantize_qr = checking
    try:
        (_, m), counts = counted(torch, ops, lambda: alg.run_rounds(
            alg.init(params0), prng.PRNGKey(1), 1))
    finally:
        ops.quantize_qr = orig
    n_total = sum(p.numel() for p in tree_util.leaves(params0))
    n_leaves = len(tree_util.leaves(params0))
    if counts.get(k4) != n_leaves or len(checked) != n_leaves:
        raise AssertionError(f"scope per-client r: launches {counts}, "
                             f"{len(checked)} checked")
    launches.setdefault(k4, {})["scope per-client r (per-row levels)"] = \
        counts[k4]
    want = {float(n_total * (1 + r) + n_leaves * 32) for r in (4, 8)}
    if not set(m["client_uplink_bits"][0].tolist()) <= want:
        raise AssertionError(f"scope per-client r: bits "
                             f"{m['client_uplink_bits']} not in {want}")
    print(f"[scope] QuantQr(8) with r of 4 and 8 a client: {len(checked)} "
          f"K4 per-row launches bit-equal to prng.uniform + the plain "
          f"version (rows' r {checked[0]}); client bits "
          f"{m['client_uplink_bits'][0].tolist()}", flush=True)


def collective_profile(torch, prng, alg, state, key, label: str):
    """``CLIENT_MESH_WINDOW`` rounds of ``alg`` under ``torch.profiler``:
    a round's device operations, its NCCL kernels and their device ms,
    and the host time of its collective calls; returns the carried
    ``(state, key)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(CLIENT_MESH_WINDOW):
            key, sub = prng.split(key, 2)
            state, _ = alg.round(state, sub)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) / CLIENT_MESH_WINDOW * 1e3
    n = CLIENT_MESH_WINDOW
    dev_ops, launch_calls = round_op_counts(prof)
    nccl = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and "nccl" in ev.name.lower()]
    nccl_ms = sum(ev.time_range.elapsed_us() for ev in nccl) / 1e3
    host = {e.key: e for e in prof.key_averages()
            if any(t in e.key.lower() for t in
                   ("c10d", "nccl", "all_reduce", "allreduce", "all_gather",
                    "allgather", "_allgather_base"))}
    print(f"[client_mesh] {label}: under the profiler {wall_ms!r} ms a "
          f"round, {dev_ops / n!r} device operations and {launch_calls / n!r}"
          f" cudaLaunchKernel calls a round; NCCL kernels {len(nccl) / n!r} a "
          f"round, {nccl_ms / n!r} device ms; host collective calls (calls, "
          f"host ms a round): " + ("; ".join(
              f"{k[:48]} {e.count / n!r} {e.cpu_time_total / n / 1e3!r}"
              for k, e in sorted(host.items())) or "none"), flush=True)
    return state, key


def client_mesh_phase(torch, dev, mnist, launches: dict) -> None:
    """Phase 8b (``client_mesh``): the client axis over ranks (DESIGN.md §6)
    on the card, an NCCL group of world size 1 from a ``FileStore`` under
    a temporary directory, so every collective of the sharded round is a
    real NCCL call.  On the quickstart setup, CLIENT_MESH_ROUNDS rounds of
    FedComLoc with TopK(0.3), QuantQr(8) and k25_q4 on both wires, FedAvg
    with TopK(0.5) and LoCoDL (packed TopK(0.1) both ways) run under
    ``make_client_mesh(1)`` and unsharded: the state and every metric bit
    for bit, the launch counts by kernel equal; then steady ms a round,
    sharded and unsharded in turns.  The group is destroyed at the end."""
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.compress import Compose, QuantQr, TopK
    from repro_torch.core.baselines import FedAvg, FedConfig
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.core.locodl import LoCoDL, LoCoDLConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_client_mesh

    loss_fn, data, params0 = mnist["loss_fn"], mnist["data"]["cuda"], \
        mnist["params0"]
    s = 5
    com = FedComLocConfig(gamma=0.1, p=0.1, n_clients=20, clients_per_round=s,
                          batch_size=32, variant="com")
    runs = {
        **{f"FedComLoc {name} {w}": (lambda comp=comp, w=w: FedComLoc(
            loss_fn, data, com, comp(), wire=w))
           for name, comp in (("TopK", lambda: TopK(0.3)),
                              ("QuantQr", lambda: QuantQr(8)),
                              ("k25_q4", lambda: Compose(TopK(0.25),
                                                         QuantQr(4))))
           for w in ("account", "packed")},
        "FedAvg TopK(0.5)": lambda: FedAvg(
            loss_fn, data, FedConfig(gamma=0.1, local_steps=10, n_clients=20,
                                     clients_per_round=s, batch_size=32),
            TopK(0.5)),
        "LoCoDL packed": lambda: LoCoDL(
            loss_fn, data, LoCoDLConfig(gamma=0.1, p=0.1, lam=0.9,
                                        n_clients=20, clients_per_round=s,
                                        batch_size=32),
            TopK(0.1), wire="packed", downlink="packed",
            downlink_compressor=TopK(0.1)),
    }

    def bits(t):
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
        return np.ascontiguousarray(a).view(np.uint8)

    def state_leaves(state):
        return [t for v in state if isinstance(v, (dict, tuple)) and v != ()
                for t in tree_util.leaves(v)]

    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1),
                            rank=0, world_size=1)
    try:
        mesh = make_client_mesh(1)
        print(f"[client_mesh] NCCL group of world size "
              f"{dist.get_world_size()}, mesh {mesh}", flush=True)
        for label, make in runs.items():
            out = {}
            for mode in ("unsharded", "sharded"):
                alg = make()
                if mode == "sharded":
                    alg.use_mesh(mesh)
                (state, metrics), counts = counted(
                    torch, ops, lambda: alg.run_rounds(
                        alg.init(params0), prng.PRNGKey(1),
                        CLIENT_MESH_ROUNDS))
                out[mode] = (alg, state, metrics, counts)
            (ua, us, um, uc), (sa, ss, sm, sc) = out["unsharded"], \
                out["sharded"]
            if sc != uc:
                raise AssertionError(f"client_mesh {label}: launches {sc} "
                                     f"sharded != {uc} unsharded")
            for k, c in sc.items():
                launches.setdefault(k, {})[f"client_mesh {label}"] = c
            ul, sl = state_leaves(us), state_leaves(ss)
            if len(ul) != len(sl) or not all(
                    np.array_equal(bits(a), bits(b)) for a, b in zip(ul, sl)):
                raise AssertionError(f"client_mesh {label}: the sharded "
                                     f"state is not the unsharded bit for bit")
            if set(sm) != set(um) or not all(
                    np.array_equal(bits(sm[k]), bits(um[k])) for k in um):
                raise AssertionError(f"client_mesh {label}: metrics differ")
            if sa.meter.snapshot() != ua.meter.snapshot():
                raise AssertionError(f"client_mesh {label}: meters differ")
            # steady ms a round, unsharded and sharded in turns
            times = {"unsharded": [], "sharded": []}
            chains = {}
            for mode, (alg, *_rest) in out.items():
                state, key = alg.init(params0), prng.PRNGKey(2)
                for _ in range(2):                        # warm up
                    key, sub = prng.split(key, 2)
                    state, _ = alg.round(state, sub)
                chains[mode] = (state, key)
            for mode in ("unsharded", "sharded", "sharded", "unsharded"):
                alg = out[mode][0]
                state, key = chains[mode]
                torch.cuda.synchronize()
                t0 = time.time()
                for _ in range(CLIENT_MESH_WINDOW):
                    key, sub = prng.split(key, 2)
                    state, _ = alg.round(state, sub)
                torch.cuda.synchronize()
                times[mode].append((time.time() - t0) / CLIENT_MESH_WINDOW
                                   * 1e3)
                chains[mode] = (state, key)
            if label in CLIENT_MESH_PROFILED:
                for mode in ("unsharded", "sharded"):
                    chains[mode] = collective_profile(
                        torch, prng, out[mode][0], *chains[mode],
                        f"{label} {mode}")
            print(f"[client_mesh] {label}: state, {len(um)} metrics and the "
                  f"meter bit-equal over {CLIENT_MESH_ROUNDS} rounds; "
                  f"launches {sc} (unsharded {uc}); steady ms/round in turns "
                  f"(windows of {CLIENT_MESH_WINDOW}) sharded "
                  f"{times['sharded']!r} (median "
                  f"{statistics.median(times['sharded'])!r}) vs unsharded "
                  f"{times['unsharded']!r} (median "
                  f"{statistics.median(times['unsharded'])!r}); train_loss "
                  f"{[float(v) for v in sm['train_loss']]!r}", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[client_mesh] card: {card_line()}", flush=True)


def model_mesh_config(torch, reduced: bool = False):
    """qwen2-0.5b at its published width, float32, MODEL_MESH_LAYERS of its
    24 layers (``reduced``: the family's smoke-test size, for a dry run of
    the phase on the CPU)."""
    from repro_torch import configs
    spec = configs.get_spec(MODEL_MESH_ARCH)
    if reduced:
        spec = configs.reduced(spec)
    return dataclasses.replace(spec.model,
                               n_layers=2 if reduced else MODEL_MESH_LAYERS,
                               dtype=torch.float32)


def model_mesh_runs(torch, cfg, seq: int, dev):
    """``({label: (codec, make)}, seeded weights)``: the phase's two runs
    on seeded tokens (two sequences a client, batch 1), the loss over
    stacked clients a per-client loop over ``transformer.loss``."""
    import numpy as np

    from repro_torch import tree as tree_util
    from repro_torch.compress import QuantQr, TopK
    from repro_torch.core import fed_data
    from repro_torch.core.baselines import FedAvg, FedConfig
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.models import transformer as tfm

    c = MODEL_MESH_CLIENTS
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.vocab, (2 * c, seq)).astype(np.int32)
    data = fed_data.from_numpy_partition(
        x, np.zeros((2 * c,), np.float32),
        [np.arange(2 * i, 2 * i + 2) for i in range(c)], device=dev)

    def loss_fn(params, xb, yb):
        return torch.stack([
            tfm.loss(tree_util.map(lambda t: t[i], params), cfg, xb[i],
                     loss_chunk=seq)
            for i in range(xb.shape[0])])

    fed = FedConfig(gamma=MODEL_MESH_GAMMA, local_steps=2, n_clients=c,
                    clients_per_round=c, batch_size=1)
    com = FedComLocConfig(gamma=MODEL_MESH_GAMMA, p=0.5, n_clients=c,
                          clients_per_round=c, batch_size=1, variant="com")
    runs = {
        "FedAvg TopK(0.1)": ("topk", lambda: FedAvg(
            loss_fn, data, fed, TopK(0.1), wire="packed")),
        "FedComLoc QuantQr(8), downlink QuantQr(8)": (
            "qr", lambda: FedComLoc(loss_fn, data, com, QuantQr(8),
                                    wire="packed", downlink="packed",
                                    downlink_compressor=QuantQr(8))),
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    return runs, tfm.init_params(cfg, gen)


def _mm_state(state) -> list:
    from repro_torch import tree as tree_util
    return [t for v in state if isinstance(v, (dict, tuple)) and v != ()
            for t in tree_util.leaves(v)]


def _mm_encode_stats(rec) -> dict:
    """One shard-local encode (the uplink's, or the broadcast's where
    ``rec["downlink"]``): the whole support beyond k on its sharded
    leaves (ties), this rank's survivors past its caps (overflow), its
    buffers' bytes a client against ``per_device_payload_nbytes``, and
    whether m x (the shard-specific part) + (the part every rank ships
    alike: replicated leaves, norms) is ``nbytes``."""
    from repro_torch.compress import wire
    spec, counts = rec["spec"], rec["counts"]
    ties = overflow = 0
    if spec.codec == "topk":
        for i, mdim in enumerate(spec.model_dims):
            if mdim is None:
                continue
            k = rec["comp"]._k(math.prod(spec.shapes[i]))
            ties += int((counts["nnz"][:, i] - k).clamp(min=0).sum())
            overflow += int((counts["nnz_local"][:, i]
                             - spec.caps[i]).clamp(min=0).sum())
    own = alike = ci = 0
    for n, dt, mdim in zip(wire._local_sizes(spec), spec.dtypes,
                           spec.model_dims):
        if spec.codec == "topk":
            b, side = spec.caps[ci] * (4 + dt.itemsize), 0
            ci += 1
        elif spec.codec == "qr":
            b, side = -(-n // 32) * (1 + spec.r) * 4, 4
        else:
            b, side = n * dt.itemsize, 0
        if mdim is None:
            alike += b + side
        else:
            own, alike = own + b, alike + side
    per_dev = wire.per_device_payload_nbytes(spec)
    return {"ties": ties, "overflow": overflow,
            "downlink": rec.get("downlink", False),
            "leaves": len(spec.shapes),
            "measured": rec["device_nbytes"], "per_device": per_dev,
            "nbytes": spec.nbytes,
            "conserved": (spec.model_shards * own + alike == spec.nbytes
                          and own + alike == per_dev)}


def _mm_capture_error(ctx, err: dict, tree_util) -> None:
    """Wraps ``ctx``'s uplink so that the first round's decode error of
    this rank's clients, leaf by leaf, lands in ``err["err"]``: the
    reference's contract for the sharded Q_r wire (its dither differs from
    the unsharded wire's by design) is an error within 1.5x the unsharded
    one."""
    encode, gather = ctx.encode_payload, ctx.gather_decoded_payload

    def encode_payload(comp, plan, stacked, keys=None):
        if "err" not in err:
            err["x"] = stacked
        return encode(comp, plan, stacked, keys)

    def gather_decoded_payload(payload, partf_full):
        dec = gather(payload, partf_full)
        if "x" in err:
            err["err"] = [float((a - b).norm()) for a, b in zip(
                tree_util.leaves(ctx.shard_tree(dec)),
                tree_util.leaves(err.pop("x")))]
        return dec

    ctx.encode_payload = encode_payload
    ctx.gather_decoded_payload = gather_decoded_payload


def _mm_mark_downlink(ctx) -> None:
    """Wraps ``ctx``'s broadcast encode so that its record says so."""
    encode = ctx.encode_broadcast

    def encode_broadcast(comp, tree, key=None):
        n0 = len(ctx.record or ())
        out = encode(comp, tree, key)
        for rec in (ctx.record or [])[n0:]:
            rec["downlink"] = True
        return out

    ctx.encode_broadcast = encode_broadcast


def _wait_for(path: str, parent: Optional[int]) -> None:
    """Sleeps until ``path`` exists; exits once the process ``parent``
    that spawned this one is gone (None: no such check)."""
    while not os.path.exists(path):
        if parent is not None and os.getppid() != parent:
            sys.exit(1)
        time.sleep(0.05)


def _mm_rank(rank: int, world: int, tmp: str, device: str,
             reduced: bool, parent: Optional[int] = None) -> None:
    """One gloo rank of the model_mesh phase, on ``device`` (every rank on
    the one card): its first forward and backward, then (once ``tmp/go``
    exists) the runs of ``model_mesh_runs`` on the flat and the composed
    meshes, wave by wave of MODEL_MESH_WAVES with a barrier between (a
    composed stage held to its flat run on that run's first rank); writes
    what it saw to ``tmp/rank<r>.pkl``."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.core import engine
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/ranks",
                                                         world),
                            rank=rank, world_size=world)
    out = {"stages": [], "times": {}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    try:
        names3 = ("clients", "data", "model")
        meshes = {(None, shape): DeviceMesh(
            "cpu", torch.tensor(ranks).view(shape), mesh_dim_names=names3)
            for shape, ranks in MODEL_MESH_SHAPES.items()}
        meshes.update({(label, shape): DeviceMesh(
            "cpu", torch.tensor(ranks).view(shape),
            mesh_dim_names=("clients",))
            for label, flats in MODEL_MESH_FLAT.items()
            for shape, ranks in flats.items()})
        cfg = model_mesh_config(torch, reduced)
        seq = 64 if reduced else MODEL_MESH_SEQ
        runs, params0 = model_mesh_runs(torch, cfg, seq, dev)
        # every rank's first forward and backward at once (a process's first
        # takes ~12 s on an H100, alone): one step of one client
        warm = runs[MM_FEDAVG][1]()
        t0 = time.time()
        engine.value_and_grad(warm.loss_fn, tree_util.map(
            lambda t: t.unsqueeze(0), params0), *warm.data.sample_batch(
                prng.split(prng.PRNGKey(0), 1),
                torch.zeros(1, dtype=torch.int64), 1))
        sync()
        out["warm_s"] = time.time() - t0
        out["t_warm"] = time.time()
        del warm
        _wait_for(f"{tmp}/go", parent)      # the parent's NCCL part
        timed = {}              # FedAvg's flat and composed (2,) runs, kept
        kept = {}   # each flat run's round-1 x and state, on its first rank
        for wave in MODEL_MESH_WAVES:
            dist.barrier()
            for label, shape in wave:
                composed = len(shape) == 3
                ranks = (MODEL_MESH_SHAPES[shape] if composed
                         else MODEL_MESH_FLAT[label][shape])
                if rank not in ranks:
                    continue
                keeper = MODEL_MESH_FLAT[label][(shape[0],)][0]
                codec, make = runs[label]
                alg = make().use_mesh(meshes[(None if composed else label,
                                              shape)])
                ctx = alg._sharded.ctx
                if composed:
                    ctx.record = []
                    _mm_mark_downlink(ctx)
                err = {}
                if codec == "qr":
                    _mm_capture_error(ctx, err, tree_util)
                sync()
                ops.reset_launch_counts()
                t0 = time.time()
                state, key = alg.init(params0), prng.PRNGKey(1)
                rounds, x1 = [], None
                for r in range(MODEL_MESH_ROUNDS):
                    key, sub = prng.split(key, 2)
                    n0 = len(ctx.record) if composed else 0
                    state, m = alg.round(state, sub)
                    encodes = ([_mm_encode_stats(rec)
                                for rec in ctx.record[n0:]]
                               if composed else [])
                    rounds.append({"metrics": m, "encodes": encodes})
                    if r == 0 and rank == keeper:
                        x1 = [t.detach().to("cpu", copy=True)
                              for t in tree_util.leaves(state.x)]
                sync()
                stage = {"run": label, "codec": codec, "shape": shape,
                         "rounds": rounds, "s": time.time() - t0,
                         "round1_error": err.get("err"),
                         "launches": {k: v for k, v in
                                      ops.launch_counts().items() if v}}
                if rank == keeper:
                    # the final state is held bit for bit only by a TopK
                    # run (a Q_r run's sharded dither differs by design)
                    final = ([t.detach().to("cpu", copy=True)
                              for t in _mm_state(state)]
                             if codec == "topk" else [])
                    if not composed:
                        kept[(label, shape)] = (x1, final)
                    else:
                        fx1, ffinal = kept[(label, (shape[0],))]
                        stage["round1_differ"] = int(sum(
                            int((a != b).sum()) for a, b in zip(x1, fx1)))
                        stage["state_equal"] = codec == "topk" and len(
                            final) == len(ffinal) and all(
                            torch.equal(a.view(torch.int32),
                                        b.view(torch.int32))
                            for a, b in zip(final, ffinal))
                        stage["finite"] = all(bool(torch.isfinite(a).all())
                                              for a in _mm_state(state))
                out["stages"].append(stage)
                if rank == ranks[0]:
                    print(f"[model_mesh] {label} {shape}: {stage['s']:.1f} s "
                          f"on rank {rank}", flush=True)
                if label == MM_FEDAVG and shape in MODEL_MESH_TIMED:
                    ctx.record = None
                    timed[shape] = (alg, state, key)
                del alg, state, ctx
                if dev.type == "cuda":     # idle ranks hand the memory back
                    torch.cuda.empty_cache()
        del kept
        # steady ms a round, composed and flat in turns (one round a turn,
        # each run past its two rounds above), FedAvg TopK
        times = {shape: [] for shape in MODEL_MESH_TIMED}
        for shape in (*MODEL_MESH_TIMED, *MODEL_MESH_TIMED[::-1]):
            sync()
            dist.barrier()
            t0 = time.time()
            if shape in timed:
                alg, state, key = timed[shape]
                key, sub = prng.split(key, 2)
                state, _ = alg.round(state, sub)
                timed[shape] = (alg, state, key)
                sync()
            dist.barrier()
            times[shape].append((time.time() - t0) * 1e3)
        del timed
        out["times"] = {str(k): v for k, v in times.items()}
        if dev.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["t_end"] = time.time()
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _mm_close(a, b, rtol) -> bool:
    import numpy as np
    return bool(np.allclose(np.asarray(a, np.float64),
                            np.asarray(b, np.float64), rtol=rtol, atol=0.0))


def model_mesh_check(torch, results: dict, launches: dict) -> None:
    """Hold the ranks' results (:func:`_mm_rank`) to the phase's contract
    and print them; adds the composed runs' launches by kernel to
    ``launches``."""
    import numpy as np

    stages = {}
    for r, res in results.items():
        for st in res["stages"]:
            stages.setdefault((st["run"], st["shape"]), {})[r] = st
    on_card = any("peak_bytes" in res for res in results.values())
    for (label, shape), by_rank in stages.items():
        if len(shape) != 3:
            continue
        # held on the flat mesh's first rank, which ran both
        keeper = MODEL_MESH_FLAT[label][(shape[0],)][0]
        st0 = by_rank[keeper]
        flat = stages[(label, (shape[0],))][keeper]
        m = shape[2]
        # ties on the whole support: counted on model rank 0 of each
        # clients rank; overflow on each rank's slice
        heads = [r for r in by_rank if r % m == 0]
        per_round = []
        for i in range(MODEL_MESH_ROUNDS):
            ties = sum(e["ties"] for r in heads
                       for e in by_rank[r]["rounds"][i]["encodes"])
            over = sum(e["overflow"] for r in by_rank
                       for e in by_rank[r]["rounds"][i]["encodes"])
            per_round.append((ties, over))
        # the packed downlink's run: one shard-local broadcast a round on
        # every rank; the others none
        n_down = 1 if "downlink" in label else 0
        for r, st in by_rank.items():
            for i, rnd in enumerate(st["rounds"]):
                for e in rnd["encodes"]:
                    if e["measured"] != e["per_device"] or not e["conserved"]:
                        raise AssertionError(
                            f"model_mesh {label} {shape} rank {r} round "
                            f"{i}: buffer bytes {e['measured']} a client, "
                            f"per_device_payload_nbytes {e['per_device']}, "
                            f"conserved {e['conserved']}")
                downs = sum(e["downlink"] for e in rnd["encodes"])
                if downs != n_down:
                    raise AssertionError(
                        f"model_mesh {label} {shape} rank {r} round {i}: "
                        f"{downs} shard-local broadcasts, not {n_down}")
            encs = [e for rnd in st["rounds"] for e in rnd["encodes"]]
            if on_card and st0["codec"] == "topk":
                # K1h: one grouped launch a digit an encode, whatever the
                # number of sharded leaves
                got = st["launches"].get("topk_radix_hist", 0)
                if got != 4 * len(encs):
                    raise AssertionError(
                        f"model_mesh {label} {shape} rank {r}: "
                        f"topk_radix_hist {got} != {4 * len(encs)} "
                        f"({len(encs)} encodes)")
            if on_card and st0["codec"] == "qr":
                # K3's sum of squares and the keyed K7 once a leaf an
                # encode, K9's values once a leaf a shard a decode
                per = len(encs) * encs[0]["leaves"]
                want = {"sum_squares": per, "quantize_pack_keyed": per,
                        "unpack_qr_values": per * m}
                got = {k: st["launches"].get(k, 0) for k in want}
                if got != want:
                    raise AssertionError(
                        f"model_mesh {label} {shape} rank {r}: launches "
                        f"{got} != {want} ({len(encs)} encodes)")
        exact = ("uplink_bits", "downlink_bits", "client_steps",
                 "num_local_steps", "client_uplink_bits")
        clean = True        # no tie or overflow in the rounds before this
        for i, (rc, rf) in enumerate(zip(st0["rounds"], flat["rounds"])):
            mc, mf = rc["metrics"], rf["metrics"]
            for k in exact:
                if k not in mf:
                    continue
                # the broadcast codes the server's new model, which this
                # round's uplink ties already moved
                held = clean and (k != "downlink_bits"
                                  or per_round[i] == (0, 0))
                same = np.array_equal(np.asarray(mc[k]), np.asarray(mf[k]))
                if not same and (held or not _mm_close(
                        mc[k], mf[k], MODEL_MESH_BITS_RTOL)):
                    raise AssertionError(
                        f"model_mesh {label} {shape} round {i}: {k} "
                        f"{mc[k]!r} != flat {mf[k]!r} (ties and overflows "
                        f"so far {per_round[:i + 1]})")
            if st0["codec"] == "qr" and not np.array_equal(
                    np.asarray(mc["uplink_payload_bytes"]),
                    np.asarray(mf["uplink_payload_bytes"])):
                raise AssertionError(f"model_mesh {label} {shape} round {i}: "
                                     f"payload bytes differ")
            # round 1 starts from the same state: the loss is the flat
            # run's bit for bit; past it a TopK run holds the reference's
            # rtol, while a Q_r run's sharded dither (the folded key, by
            # design) moves its loss by the quantizer's noise (the round-1
            # error below holds the quantizer instead)
            if i == 0 and mc["train_loss"] != mf["train_loss"]:
                raise AssertionError(
                    f"model_mesh {label} {shape}: round 1's train_loss "
                    f"{mc['train_loss']!r} != flat {mf['train_loss']!r}")
            if st0["codec"] == "topk" and not _mm_close(
                    mc["train_loss"], mf["train_loss"], MODEL_MESH_LOSS_RTOL):
                raise AssertionError(
                    f"model_mesh {label} {shape} round {i}: train_loss "
                    f"{mc['train_loss']!r} vs flat {mf['train_loss']!r}")
            clean = clean and per_round[i] == (0, 0)
        for r, st in by_rank.items():   # every rank reports the same
            for a, b in zip(st["rounds"], st0["rounds"]):
                if set(a["metrics"]) != set(b["metrics"]) or not all(
                        np.array_equal(np.asarray(a["metrics"][k]),
                                       np.asarray(b["metrics"][k]))
                        for k in b["metrics"]):
                    raise AssertionError(f"model_mesh {label} {shape}: rank "
                                         f"{r}'s metrics differ from rank 0's")
        if not st0["finite"]:
            raise AssertionError(f"model_mesh {label} {shape}: non-finite "
                                 f"state")
        if st0["codec"] == "qr":
            # each leaf's round-1 decode error of the keeper's clients
            # within 1.5x the flat run's (tests/test_big_model_mesh.py's qr
            # bound)
            for j, (e, ef) in enumerate(zip(st0["round1_error"],
                                            flat["round1_error"])):
                if not e <= 1.5 * ef + 1e-6:
                    raise AssertionError(f"model_mesh {label} {shape}: leaf "
                                         f"{j}'s Q_r error {e!r} > 1.5 x the "
                                         f"flat run's {ef!r}")
            ratio = max(e / ef for e, ef in zip(st0["round1_error"],
                                                flat["round1_error"]) if ef)
        r1 = sum(per_round[0])
        if st0["codec"] == "topk" and st0["round1_differ"] > r1:
            raise AssertionError(
                f"model_mesh {label} {shape}: round 1's model differs from "
                f"the flat run's at {st0['round1_differ']} coordinates, "
                f"more than its ties + overflows {per_round[0]}")
        if st0["codec"] == "topk" and clean and not st0["state_equal"]:
            raise AssertionError(f"model_mesh {label} {shape}: no tie or "
                                 f"overflow, yet the state differs")
        for r, st in by_rank.items():
            for k, c in st["launches"].items():
                launches.setdefault(k, {})
                launches[k][f"model_mesh {label} {shape}"] = \
                    launches[k].get(f"model_mesh {label} {shape}", 0) + c
        up = [e for e in st0["rounds"][0]["encodes"] if not e["downlink"]]
        nbytes = up[0]["nbytes"] if up else None
        per_dev = up[0]["per_device"] if up else None
        gaps = [abs(a["metrics"]["train_loss"] - b["metrics"]["train_loss"])
                / abs(b["metrics"]["train_loss"])
                for a, b in zip(st0["rounds"], flat["rounds"])]
        qr_note = (f"Q_r round-1 error at most {ratio!r} x the flat run's a "
                   f"leaf; " if st0["codec"] == "qr" else "")
        final = ("bit-equal" if st0["state_equal"] else "apart"
                 if st0["codec"] == "topk" else "not held (another dither)")
        print(f"[model_mesh] {label} {shape} (m = {m}) vs flat "
              f"({shape[0]},): bits "
              f"{'exact' if clean else 'exact up to the first tie or overflow, then within rtol %g' % MODEL_MESH_BITS_RTOL} over "
              f"{MODEL_MESH_ROUNDS} rounds; (ties beyond k, overflows) a "
              f"round {per_round}; round 1's model differs at "
              f"{st0['round1_differ']} coordinates; final state {final}; "
              f"uplink "
              f"bytes a client {nbytes} whole wire (flat "
              f"{flat['rounds'][0]['metrics'].get('uplink_payload_bytes', 0) / MODEL_MESH_CLIENTS!r}), "
              f"{per_dev} a rank (measured); {qr_note}relative train_loss "
              f"gap a round "
              f"{gaps!r}; train_loss "
              f"{[rd['metrics']['train_loss'] for rd in st0['rounds']]!r} vs "
              f"flat {[rd['metrics']['train_loss'] for rd in flat['rounds']]!r}"
              f"; uplink_bits "
              f"{[rd['metrics']['uplink_bits'] for rd in st0['rounds']]!r}; "
              f"{st0['s']:.1f} s", flush=True)
        down = [e for e in st0["rounds"][0]["encodes"] if e["downlink"]]
        if down:
            bits = [[rd["metrics"]["downlink_bits"] for rd in x["rounds"]]
                    for x in (st0, flat)]
            print(f"[model_mesh] {label} {shape}: the broadcast shard-local "
                  f"over m = {m} (one encode a round on every rank): bytes "
                  f"a rank {down[0]['measured']} (per_device_payload_nbytes "
                  f"{down[0]['per_device']}) of the whole broadcast's "
                  f"{down[0]['nbytes']}; downlink_bits {bits[0]!r} (flat "
                  f"{bits[1]!r}); launches on rank 0, uplink and downlink "
                  f"{st0['launches']}", flush=True)
    for r, res in results.items():
        seen = {}
        for st in res["stages"]:
            if len(st["shape"]) == 3:
                for k, c in st["launches"].items():
                    seen[k] = seen.get(k, 0) + c
        if on_card:
            missing = [k for k in MODEL_MESH_KERNELS if not seen.get(k)]
            if missing:
                raise AssertionError(f"model_mesh rank {r}: {missing} "
                                     f"launched no time ({seen})")
        print(f"[model_mesh] rank {r} launches over the composed runs: "
              f"{seen}; peak device bytes {res.get('peak_bytes')}; first "
              f"forward and backward {res['warm_s']:.1f} s; steady "
              f"ms/round in turns {res['times']}", flush=True)


def model_mesh_leaf_set(torch, cfg, m: int, dev) -> tuple:
    """The encode's K1h leaf set at ``m`` model ranks: ``(slices, ks,
    n_totals)``, a seeded (MODEL_MESH_CLIENTS, n / m) slice of every leaf
    the model axis shards (``specs.model_dim_index``), in tree order, with
    TopK(0.1)'s k and the whole leaf's n."""
    from repro_torch import tree as tree_util
    from repro_torch.compress import TopK
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import specs

    gen = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_params(cfg, gen)
    shapes = [(path, tuple(t.shape))
              for path, t in tree_util.leaves_with_paths(params)]
    del params
    xs, ks, ns = [], [], []
    for path, shp in shapes:
        if specs.model_dim_index(path, shp, m) is None:
            continue
        n = math.prod(shp)
        xs.append(torch.randn(MODEL_MESH_CLIENTS, n // m, generator=gen,
                              device=dev))
        ks.append(TopK(0.1)._k(n))
        ns.append(n)
    return xs, ks, ns


def model_mesh_k1h(torch, dev, rec=None, reduced: bool = False) -> None:
    """Phase 8c's first part: every kernel library built (the spawned ranks
    load them), then K1h at the encode's leaf set (m = 2 and 4): one
    grouped digit and the threshold stage (identity reduce) against the
    per-leaf route in turns, the slices' byte bound, the stage's device
    operations (at most 3 a digit and 2 more); then one digit at the
    sharded embedding's slice (m = 2).  ``rec`` (K1h's record) takes the
    m = 2 digit as its main timing and the embedding's as its large one."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import topk_compress as tk

    cfg = model_mesh_config(torch, reduced)
    build.build_all()
    R = MODEL_MESH_CLIENTS

    def ident(h):
        return h

    for m in (2, 4):
        xs, ks, ns = model_mesh_leaf_set(torch, cfg, m, dev)
        L, nx = len(xs), sum(x.numel() for x in xs)
        pre0 = torch.zeros(L * R, dtype=torch.int64, device=dev)

        def per_leaf_digit():
            return torch.cat([tk.radix_hist(x, pre0[i * R:(i + 1) * R], 24)
                              for i, x in enumerate(xs)])

        def per_leaf_stage():
            # the parent's threshold_bits_sharded: K1h a leaf, torch.cat,
            # the walk in torch operations
            k = torch.cat([ref._per_row(k_i, R, dev) for k_i in ks])
            n_total = torch.tensor(ns, device=dev).repeat_interleave(R)
            return list(ref.radix_walk(
                lambda p, s: torch.cat([tk.radix_hist(
                    x, p[i * R:(i + 1) * R], s) for i, x in enumerate(xs)]),
                k, R * L, n_total, dev, ident).split(R))

        grouped_digit = lambda: tk.radix_hist_grouped(xs, pre0, 24)
        stage = lambda: tk.threshold_bits_sharded(xs, ks, ns, ident)
        h = grouped_digit()
        if not torch.equal(h, per_leaf_digit()) or not torch.equal(
                h.long(), ref.radix_digit_hist_grouped(
                    [ref.mag_bits(x) for x in xs], pre0, 24)):
            raise AssertionError(f"K1h at the m = {m} leaf set: the grouped "
                                 f"digit differs from the per-leaf route or "
                                 f"the plain version")
        if not all(torch.equal(a, b) for a, b in zip(stage(),
                                                     per_leaf_stage())):
            raise AssertionError(f"K1h at the m = {m} leaf set: the grouped "
                                 f"thresholds differ from the per-leaf "
                                 f"route's")
        turns = {"digit per-leaf": [], "digit grouped": [],
                 "stage per-leaf": [], "stage grouped": []}
        for _ in range(2):
            for what, fn in (("per-leaf", per_leaf_digit),
                             ("grouped", grouped_digit),
                             ("grouped", grouped_digit),
                             ("per-leaf", per_leaf_digit)):
                turns[f"digit {what}"].append(time_ms(torch, fn, 10))
            for what, fn in (("per-leaf", per_leaf_stage),
                             ("grouped", stage), ("grouped", stage),
                             ("per-leaf", per_leaf_stage)):
                turns[f"stage {what}"].append(time_ms(torch, fn, 5))
        _, ops_a_call = device_per_call(torch, stage, 3)
        want_ops = 3 * len(ref.RADIX_SHIFTS) + 2
        if ops_a_call is not None and ops_a_call > want_ops:
            raise AssertionError(f"K1h at the m = {m} leaf set: "
                                 f"{ops_a_call} device operations a "
                                 f"threshold stage, more than {want_ops}")
        # reads every slice and the prefixes, writes the (L * R, 256) counts
        b_ms, b_by = bound_ms(4 * nx + 8 * L * R + 1024 * L * R, 5 * nx)
        med = {k: statistics.median(v) for k, v in turns.items()}
        print(f"[model_mesh] K1h at the encode's leaf set, m = {m}: {L} "
              f"slices of ({R}, n_i), {nx // R} floats a row; one digit "
              f"grouped {turns['digit grouped']!r} ms, per-leaf "
              f"{turns['digit per-leaf']!r} (in turns; medians "
              f"{med['digit grouped']!r} / {med['digit per-leaf']!r}) "
              f"against the byte bound {b_ms!r} ms ({b_by}); the threshold "
              f"stage grouped {turns['stage grouped']!r} ms, per-leaf "
              f"{turns['stage per-leaf']!r} (medians {med['stage grouped']!r}"
              f" / {med['stage per-leaf']!r}); device operations a stage "
              f"{ops_a_call!r} (at most {want_ops}); card: {card_line()}",
              flush=True)
        if m == 2 and rec is not None:
            plain = lambda: ref.radix_digit_hist_grouped(
                [ref.mag_bits(x) for x in xs], pre0, 24)
            rec.timings["main"] = {
                "shape": [R, nx // R], "leaves": L,
                "kernel_ms": med["digit grouped"],
                "plain_ms": time_ms(torch, plain, 2, warmup=1),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                "per_leaf_ms": med["digit per-leaf"],
                "stage_ms": med["stage grouped"],
                "stage_per_leaf_ms": med["stage per-leaf"]}
        del xs, h
        torch.cuda.empty_cache()
    n = cfg.vocab * cfg.d_model // 2
    xe = torch.randn(R, n, device=dev)
    pre = torch.zeros(R, dtype=torch.int64, device=dev)
    ms = time_ms(torch, lambda: tk.radix_hist(xe, pre, 24), 20)
    b_ms, b_by = bound_ms(4 * xe.numel() + 8 * R + 1024 * R, 5 * xe.numel())
    if rec is not None:
        rec.timings["large"] = {
            "shape": [R, n], "kernel_ms": ms,
            "plain_ms": time_ms(torch, lambda: ref.radix_digit_hist(
                ref.mag_bits(xe), pre, 24), 2, warmup=1),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    print(f"[model_mesh] K1h topk_radix_hist at the embedding's shard "
          f"({R}, {n}): {ms!r} ms against its byte bound {b_ms!r} ms "
          f"({b_by}); card: {card_line()}", flush=True)
    del xe
    torch.cuda.empty_cache()


def model_mesh_world1(torch, dev, tmp: str, reduced: bool = False) -> None:
    """Phase 8c's part in this process: under a group of world size 1
    (NCCL on the card, a ``FileStore`` in ``tmp``) the composed (1, 1, 1)
    mesh and ``make_client_mesh(1)`` give the same FedAvg TopK(0.1) packed
    rounds bit for bit (state, metrics, launches)."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_client_mesh

    cfg = model_mesh_config(torch, reduced)
    seq = 64 if reduced else MODEL_MESH_SEQ
    runs, params0 = model_mesh_runs(torch, cfg, seq, dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(f"{tmp}/store", 1),
                            rank=0, world_size=1)
    try:
        mesh_dev = "cuda" if dev.type == "cuda" else "cpu"
        flat = make_client_mesh(1, device=mesh_dev)
        composed = init_device_mesh(mesh_dev, (1, 1, 1), mesh_dim_names=(
            "clients", "data", "model"))
        label = "FedAvg TopK(0.1)"
        got = {}
        for name, mesh in (("flat", flat), ("(1, 1, 1)", composed)):
            alg = runs[label][1]().use_mesh(mesh)
            (state, metrics), counts = counted(
                torch, ops, lambda: alg.run_rounds(
                    alg.init(params0), prng.PRNGKey(1), MODEL_MESH_ROUNDS))
            got[name] = ([t.cpu() for t in _mm_state(state)], metrics,
                         counts)
            del alg, state
        (fs, fm, fc), (cs, cm, cc) = got["flat"], got["(1, 1, 1)"]
        if fc != cc or not all(torch.equal(a.view(torch.int32),
                                           b.view(torch.int32))
                               for a, b in zip(fs, cs)) or set(fm) != set(
                cm) or not all(np.array_equal(np.asarray(fm[k]),
                                              np.asarray(cm[k])) for k in fm):
            raise AssertionError("model_mesh: the (1, 1, 1) mesh's rounds "
                                 "differ from make_client_mesh(1)'s")
        print(f"[model_mesh] {backend} world size 1: the (1, 1, 1) mesh's "
              f"{MODEL_MESH_ROUNDS} {label} rounds bit-equal to "
              f"make_client_mesh(1)'s (state, {len(fm)} metrics, launches "
              f"{cc}); train_loss {list(map(float, fm['train_loss']))!r}",
              flush=True)
        del got, fs, cs
    finally:
        dist.destroy_process_group()
    del runs, params0
    if dev.type == "cuda":
        torch.cuda.empty_cache()



def pod_round_spec(torch, reduced: bool = False):
    """qwen2-0.5b's ``ArchSpec`` at ``model_mesh_config``'s width, depth
    and dtype (``reduced``: the family's smoke-test size, for a dry run of
    the phase on the CPU)."""
    from repro_torch import configs
    spec = configs.get_spec(MODEL_MESH_ARCH)
    if reduced:
        spec = configs.reduced(spec)
    return dataclasses.replace(spec, model=model_mesh_config(torch, reduced))


def pod_round_inputs(torch, spec, seq: int, dev):
    """``(one client's seeded weights, the 2 clients' (2, POD_ROWS, seq)
    tokens)``: uniform over the vocabulary, so that no token id repeats
    often enough for the embedding gradient's atomics to reorder a sum."""
    import numpy as np

    from repro_torch.launch import steps
    one = steps.init_params(spec, torch.Generator(device=dev).manual_seed(0))
    toks = np.random.default_rng(0).integers(0, spec.model.vocab,
                                             (2, POD_ROWS, seq))
    return one, torch.from_numpy(toks).to(dev)


def _pod_start(torch, tree_util, one, clients: int):
    """``clients`` stacked copies of ``one`` and zero control variates."""
    x = tree_util.map(lambda t: torch.stack([t] * clients), one)
    return x, tree_util.map(torch.zeros_like, x)


def _pod_rounds(prng, fn, x, h, batch, key, rounds: int = POD_ROUNDS):
    """``rounds`` rounds of ``fn`` from ``key``: ``(x, h, [(loss,
    comm_bits)], the next key)``."""
    out = []
    for _ in range(rounds):
        key, sub = prng.split(key, 2)
        x, h, loss, bits = fn(x, h, batch, sub)
        out.append((float(loss), float(bits)))
    return x, h, out, key


def _pod_sums(torch, tree_util, tree) -> list:
    """Each leaf's float32 bit patterns summed as integers: equal trees
    give equal lists."""
    return [int(t.view(torch.int32).sum(dtype=torch.int64))
            for t in tree_util.leaves(tree)]


def _pod_gaps(got: list, want: list, bounds: list) -> tuple:
    """``(coordinates past their leaf's bound, coordinates, the largest gap
    over its bound, that leaf's index)``."""
    bad = total = 0
    worst, at = 0.0, None
    for i, (a, b, bound) in enumerate(zip(got, want, bounds)):
        d = (a.to(b.device) - b).abs()
        bad += int((d > bound).sum())
        total += b.numel()
        if float(d.max()) / bound > worst:
            worst, at = float(d.max()) / bound, i
    return bad, total, worst, at


def _pr_rank(rank: int, world: int, tmp: str, device: str,
             reduced: bool, parent: Optional[int] = None) -> None:
    """One gloo rank of the pod_round phase on ``device`` (every rank on the
    one card).  For each of POD_RUNS: rank 0 runs the one-card stacked
    round of the 2 clients; then each mesh of POD_MESHES runs the pod
    round, and rank 0 holds its own client's state and (sent over the
    world group) pod 1's control variates against the stacked round's;
    after TopK, pod and stacked rounds in turns.  Writes what it saw to
    ``tmp/rank<r>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_train, steps
    from repro_torch.launch.mesh import make_pod_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()    # this phase's peak alone
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/ranks",
                                                         world),
                            rank=rank, world_size=world)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def counts():
        return {k: v for k, v in ops.launch_counts().items() if v}

    out = {"runs": {}, "times": {}}
    try:
        meshes = {shape: make_pod_mesh(shape[0], data=shape[1], device="cpu")
                  for shape in POD_MESHES}
        spec = pod_round_spec(torch, reduced)
        seq = 64 if reduced else MODEL_MESH_SEQ
        one, toks = pod_round_inputs(torch, spec, seq, dev)
        out["paths"] = ["/".join(map(str, p)) for p, _ in
                        tree_util.leaves_with_paths(one)]
        shape2 = InputShape("pod_round", seq, 2 * POD_ROWS, "train")
        # every rank's first forward and backward at once, one client's
        t0 = time.time()
        live = [t.detach().requires_grad_() for t in tree_util.leaves(one)]
        torch.autograd.grad(steps.loss_fn(spec, fed_train.LOSS_CHUNK)(
            tree_util.unflatten(one, live), {"tokens": toks[0]}), live)
        sync()
        out["warm_s"] = time.time() - t0
        del live
        _wait_for(f"{tmp}/go", parent)      # the parent's NCCL part
        for i, (label, kw) in enumerate(POD_RUNS.items()):
            fed = fed_train.FedTrainConfig(local_steps=POD_STEPS, **kw)
            ref = None
            if rank == 0:
                stacked = fed_train.build_fed_round(spec, shape2, fed)
                x, h = _pod_start(torch, tree_util, one, 2)
                sync()
                ops.reset_launch_counts()
                t0 = time.time()
                x, h, outs, key = _pod_rounds(prng, stacked.fn, x, h,
                                              {"tokens": toks},
                                              prng.PRNGKey(1))
                sync()
                ref = {"x": x, "h": h, "key": key}
                out["runs"][(label, "stacked")] = {
                    "outs": outs, "s": time.time() - t0,
                    "launches": counts()}
            kept = {}
            for shape, owners in POD_MESHES.items():
                dist.barrier()
                head = owners[shape[1]]         # pod 1's first rank
                if rank in owners:
                    bundle = fed_train.build_fed_round(spec, shape2, fed,
                                                       meshes[shape])
                    ctx = bundle.fn.ctx
                    ctx.record = []
                    x, h = _pod_start(torch, tree_util, one, 1)
                    batch = ctx.local_batch({"tokens": toks})
                    sync()
                    ops.reset_launch_counts()
                    t0 = time.time()
                    x, h, outs, key = _pod_rounds(prng, bundle.fn, x, h,
                                                  batch, prng.PRNGKey(1))
                    sync()
                    leaves = tree_util.leaves(x)
                    run = {"outs": outs, "s": time.time() - t0,
                           "record": ctx.record, "launches": counts(),
                           "n": sum(t[0].numel() for t in leaves),
                           "leaves": len(leaves),
                           "x_sums": _pod_sums(torch, tree_util, x),
                           "h_sums": _pod_sums(torch, tree_util, h),
                           "finite": all(bool(torch.isfinite(t).all())
                                         for t in tree_util.leaves((x, h)))}
                    ctx.record = None
                    # pod 1's control variates, through page-locked memory
                    pin = dev.type == "cuda"
                    if rank == head:
                        src = torch.cat([t.reshape(-1) for t in
                                         tree_util.leaves(h)])
                        dist.send(torch.empty(src.shape, dtype=src.dtype,
                                              pin_memory=pin).copy_(src), 0)
                        del src
                    if rank == 0:
                        flat = torch.empty(run["n"], dtype=torch.float32,
                                           pin_memory=pin)
                        dist.recv(flat, head)
                        h1 = [p.view(t.shape[1:]) for p, t in zip(
                            flat.split([t[0].numel() for t in leaves]),
                            tree_util.leaves(h))]
                        xb = [POD_STATE_ULPS * float(t.abs().max())
                              + POD_MOVE_ULPS * float((t[0] - t0).abs().max())
                              or 1.0 for t, t0 in zip(
                                  tree_util.leaves(ref["x"]),
                                  tree_util.leaves(one))]
                        hb = [fed.p / fed.gamma * 2 * POD_ROUNDS * b
                              for b in xb]
                        run["x_gap"] = _pod_gaps(
                            [t[0] for t in leaves],
                            [t[0] for t in tree_util.leaves(ref["x"])], xb)
                        run["h_gap"] = _pod_gaps(
                            [t[0] for t in tree_util.leaves(h)] + h1,
                            [t[0] for t in tree_util.leaves(ref["h"])]
                            + [t[1] for t in tree_util.leaves(ref["h"])],
                            hb + hb)
                        del flat, h1
                    out["runs"][(label, shape)] = run
                    if i == 0 and shape == POD_TIMED:
                        kept[shape] = (bundle, x, h, batch, key)
                    del bundle, x, h, leaves
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            if i == 0:
                # steady ms a round: the pod round and the stacked round
                # in turns, one round a turn, every rank at a barrier
                turns = (POD_TIMED, "stacked", "stacked", POD_TIMED)
                times = {str(t): [] for t in turns}
                for turn in turns:
                    sync()
                    dist.barrier()
                    t0 = time.time()
                    if turn in kept:
                        bundle, x, h, batch, key = kept[turn]
                        x, h, _, key = _pod_rounds(prng, bundle.fn, x, h,
                                                   batch, key, 1)
                        kept[turn] = (bundle, x, h, batch, key)
                    elif turn == "stacked" and ref is not None:
                        ref["x"], ref["h"], _, ref["key"] = _pod_rounds(
                            prng, stacked.fn, ref["x"], ref["h"],
                            {"tokens": toks}, ref["key"], 1)
                    sync()
                    dist.barrier()
                    times[str(turn)].append((time.time() - t0) * 1e3)
                out["times"] = times
            del ref, kept
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if dev.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _pod_record(kw: dict, shape: tuple, n: int, leaves: int) -> list:
    """A rank's collectives of POD_ROUNDS rounds, ``(axis, op, bytes)``:
    the data axis's mean loss and gradient a local step, the losses'
    gather, the dense all-reduce 4n or the int8 gather n + 4 leaves, the
    reports' gather."""
    rnd = [("data", "all_reduce", 4 * (1 + n))] * POD_STEPS \
        if shape[1] > 1 else []
    rnd.append(("pod", "all_gather", 4 * POD_STEPS))
    rnd.append(("pod", "all_gather", n + 4 * leaves)
               if kw.get("sync_mode") == "int8"
               else ("pod", "all_reduce", 4 * n))
    rnd.append(("pod", "all_gather", 12))
    return rnd * POD_ROUNDS


def _pod_closed_bits(kw: dict, n: int, leaves: int):
    """The 2 clients' bits a round where they have a closed form."""
    if kw.get("sync_mode") == "int8":
        return 2 * (8 * n + 32 * leaves)
    if kw["compressor"] == "quant":
        return 2 * ((1 + kw["quant_bits"]) * n + 32 * leaves)
    return None


def pod_round_check(results: dict, launches: dict) -> None:
    """Hold the ranks' results (:func:`_pr_rank`) to the phase's contract
    and print them; adds the pod runs' launches to ``launches``."""
    on_card = any("peak_bytes" in res for res in results.values())
    paths = results[0]["paths"]
    for label, kw in POD_RUNS.items():
        ref = results[0]["runs"][(label, "stacked")]
        for shape, owners in POD_MESHES.items():
            by_rank = {r: results[r]["runs"][(label, shape)] for r in owners}
            run0 = by_rank[0]
            n, leaves = run0["n"], run0["leaves"]
            where = f"pod_round {label} {shape}"
            for r, run in by_rank.items():
                idx = owners.index(r)
                pod_head = by_rank[owners[idx - idx % shape[1]]]
                if run["outs"] != run0["outs"]:
                    raise AssertionError(f"{where}: rank {r}'s loss and bits "
                                         f"{run['outs']} != rank 0's")
                if run["x_sums"] != run0["x_sums"] or \
                        run["h_sums"] != pod_head["h_sums"]:
                    raise AssertionError(f"{where}: rank {r}'s state differs "
                                         f"from its pod's first rank's")
                if not run["finite"]:
                    raise AssertionError(f"{where}: rank {r}: non-finite "
                                         f"state")
                want = _pod_record(kw, shape, n, leaves)
                if run["record"] != want:
                    raise AssertionError(f"{where}: rank {r}'s collectives "
                                         f"{run['record']} != {want}")
                k3, k4 = (run["launches"].get("l2_norm", 0),
                          run["launches"].get("quantize_qr", 0))
                if on_card and kw == POD_RUNS["quant r=8"] and not (
                        k3 == k4 == POD_ROUNDS * leaves):
                    raise AssertionError(
                        f"{where}: rank {r} launched K3 {k3} and K4 {k4} "
                        f"times, not one each a leaf a round "
                        f"({POD_ROUNDS} x {leaves})")
                for k, c in run["launches"].items():
                    launches.setdefault(k, {})
                    launches[k][where] = launches[k].get(where, 0) + c
            closed = _pod_closed_bits(kw, n, leaves)
            gaps = []
            for i, ((tl, tb), (sl, sb)) in enumerate(zip(run0["outs"],
                                                         ref["outs"])):
                rtol = POD_LOSS_RTOL[min(i, 1)]
                gap = abs(tl - sl) / abs(sl)
                gaps.append(gap)
                if not gap <= rtol:
                    raise AssertionError(f"{where} round {i + 1}: loss {tl!r} "
                                         f"vs stacked {sl!r}: {gap!r} > "
                                         f"{rtol}")
                # TopK at data > 1: the gradient sums in another order and
                # may move a quantile tie
                rtol_bits = 0.0 if closed is not None or shape[1] == 1 \
                    else POD_BITS_RTOL
                if not abs(tb - sb) <= rtol_bits * sb:
                    raise AssertionError(f"{where} round {i + 1}: comm_bits "
                                         f"{tb!r} vs stacked {sb!r}")
                if closed is not None and not abs(tb - closed) <= (
                        leaves + 3) * FED_BITS_ULPS * closed:
                    raise AssertionError(f"{where}: comm_bits {tb!r} against "
                                         f"the closed form {closed}")
            for part in ("x_gap", "h_gap"):
                bad, total, worst, _ = run0[part]
                if bad > POD_FLIP_SHARE * total:
                    raise AssertionError(
                        f"{where}: {bad} of {total} {part[0]} coordinates "
                        f"past their bound (at most "
                        f"{POD_FLIP_SHARE * total:.0f}); worst gap "
                        f"{worst!r} x its bound")
            per_round = run0["record"][:len(run0["record"]) // POD_ROUNDS]
            print(f"[pod_round] {label} {shape} vs the stacked round of 2 "
                  f"clients: loss {[t for t, _ in run0['outs']]!r} vs "
                  f"{[s for s, _ in ref['outs']]!r}, relative gaps "
                  f"{gaps!r} (bounds {POD_LOSS_RTOL}); comm_bits "
                  f"{[b for _, b in run0['outs']]!r} vs "
                  f"{[b for _, b in ref['outs']]!r}"
                  + (f" (closed form {closed})" if closed else "")
                  + f"; coordinates past their bound (x: 2^-23 x (4 max |x| "
                  f"+ 128 max |x - x0|) of the leaf; h: p / gamma x 2 x "
                  f"{POD_ROUNDS} times that) x {run0['x_gap'][0]} of "
                  f"{run0['x_gap'][1]}, h {run0['h_gap'][0]} of "
                  f"{run0['h_gap'][1]} (at most {POD_FLIP_SHARE:g} of them), "
                  f"the largest gap x {run0['x_gap'][2]!r} (leaf "
                  f"{paths[run0['x_gap'][3] or 0]}) and h "
                  f"{run0['h_gap'][2]!r} (leaf "
                  f"{paths[(run0['h_gap'][3] or 0) % len(paths)]}) times "
                  f"its bound; (axis, collective, bytes) a rank a round "
                  f"{per_round} ({n} parameters in {leaves} "
                  f"tensors: 4n = {4 * n}, n + 4 leaves = {n + 4 * leaves}); "
                  f"launches on rank 0 {run0['launches']}; "
                  f"{POD_ROUNDS} rounds {run0['s']:.1f} s on rank 0 "
                  f"(stacked {ref['s']:.1f} s)", flush=True)
    for r, res in results.items():
        print(f"[pod_round] rank {r}: peak device bytes "
              f"{res.get('peak_bytes')}; first forward and backward "
              f"{res['warm_s']:.1f} s; steady ms/round in turns (TopK) "
              f"{res['times']}", flush=True)


def pod_round_world1(torch, dev, tmp: str, launches: dict,
                     reduced: bool = False) -> None:
    """Phase 8d's part in this process: under a group of world size 1 (NCCL
    on the card, a ``FileStore`` in ``tmp``) the (1, 1, 1) pod round
    equals the one-card stacked round of 1 client bit for bit (params, h,
    loss, comm_bits, launches), for each of POD_RUNS."""
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch import prng
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_train
    from repro_torch.launch.mesh import make_pod_mesh

    spec = pod_round_spec(torch, reduced)
    seq = 64 if reduced else MODEL_MESH_SEQ
    one, toks = pod_round_inputs(torch, spec, seq, dev)
    shape1 = InputShape("pod_round", seq, POD_ROWS, "train")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(
        f"{tmp}/store", 1), rank=0, world_size=1)
    try:
        mesh = make_pod_mesh(1, device=dev.type)
        for label, kw in POD_RUNS.items():
            fed = fed_train.FedTrainConfig(local_steps=POD_STEPS, **kw)
            got = {}
            for name, m in (("pod", mesh), ("stacked", None)):
                bundle = fed_train.build_fed_round(spec, shape1, fed, m)
                x, h = _pod_start(torch, tree_util, one, 1)
                batch = {"tokens": toks[:1]}
                if m is not None:
                    batch = bundle.fn.ctx.local_batch(batch)
                (x, h, outs, _), c = counted(
                    torch, ops, lambda: _pod_rounds(
                        prng, bundle.fn, x, h, batch, prng.PRNGKey(1)))
                got[name] = (x, h, outs, c)
            (px, ph, po, pc), (sx, sh, so, sc) = got["pod"], got["stacked"]
            same = po == so and pc == sc and all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(tree_util.leaves((px, ph)),
                                tree_util.leaves((sx, sh))))
            if not same:
                raise AssertionError(
                    f"pod_round {backend} (1, 1, 1) {label}: not bit-equal "
                    f"to the stacked round of 1 client ({po} vs {so}, "
                    f"launches {pc} vs {sc})")
            for k, c in pc.items():
                launches.setdefault(k, {})[
                    f"pod_round (1, 1, 1) {label}"] = c
            print(f"[pod_round] {backend} world size 1: the (1, 1, 1) pod "
                  f"round's {POD_ROUNDS} rounds of {label} bit-equal to the "
                  f"stacked round of 1 client (params, h, loss and "
                  f"comm_bits {po!r}, launches {pc})", flush=True)
            del got, px, ph, sx, sh, x, h
    finally:
        dist.destroy_process_group()
    del one, toks
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _mesh_rank(rank: int, world: int, tmp: str, device: str,
               reduced: bool, parent: int) -> None:
    """One spawned rank of phases 8c and 8d.  First, with no CUDA context,
    the imports that a process's first checkpointed forward makes
    (``torch._dynamo``: most of a rank's first forward and backward
    otherwise, PERF.md); then, once ``tmp/start``
    exists, :func:`_mm_rank` in ``tmp/mm`` and :func:`_pr_rank` in
    ``tmp/pr``, each in a gloo group of its own.  Exits if ``parent`` is
    gone."""
    # four replicas and their round's stacks share the card: segments that
    # grow in place keep the ranks' caches from fragmenting it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    from torch.utils.checkpoint import checkpoint

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.engine  # noqa: F401
    import repro_torch.launch.fed_train  # noqa: F401
    checkpoint(torch.neg, torch.ones(1, requires_grad=True),
               use_reentrant=False)
    _wait_for(f"{tmp}/start", parent)
    _mm_rank(rank, world, f"{tmp}/mm", device, reduced, parent)
    _pr_rank(rank, world, f"{tmp}/pr", device, reduced, parent)


def mesh_spawn(device: str, reduced: bool = False) -> tuple:
    """Spawns the MODEL_MESH_WORLD ranks of phases 8c and 8d
    (:func:`_mesh_rank`, daemons) with a new temporary directory: ``(their
    context, the directory)``.  Spawned before the first phase, they take
    their imports while the kernels build, and wait with no CUDA context
    until :func:`mesh_phases`; :func:`mesh_stop` ends them."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp()
    for part in ("mm", "pr"):
        os.mkdir(f"{tmp}/{part}")
    ctx = mp.start_processes(_mesh_rank, args=(MODEL_MESH_WORLD, tmp, device,
                                               reduced, os.getpid()),
                             nprocs=MODEL_MESH_WORLD, join=False, daemon=True,
                             start_method="spawn")
    return ctx, tmp


def mesh_stop(ranks: tuple) -> None:
    """Kills whichever ranks of :func:`mesh_spawn` still run and removes
    their directory."""
    import shutil

    ctx, tmp = ranks
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join()
    shutil.rmtree(tmp, ignore_errors=True)


def _mesh_join(ctx, tmp: str) -> dict:
    """The ranks of :func:`_mesh_rank`, joined with a timeout (a failing
    rank fails the phases): ``{"mm": {rank: results}, "pr": {...}}``."""
    import pickle
    deadline = time.monotonic() + MODEL_MESH_JOIN_S + POD_JOIN_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            raise AssertionError(f"model_mesh and pod_round: the ranks did "
                                 f"not finish in "
                                 f"{MODEL_MESH_JOIN_S + POD_JOIN_S} s")
    out = {}
    for part in ("mm", "pr"):
        out[part] = {}
        for r in range(MODEL_MESH_WORLD):
            with open(f"{tmp}/{part}/rank{r}.pkl", "rb") as f:
                out[part][r] = pickle.load(f)   # written by the ranks
    return out


def mesh_phases(torch, dev, launches: dict, ranks: Optional[tuple] = None,
                reduced: bool = False, rec=None) -> None:
    """Phases 8c (``model_mesh``) and 8d (``pod_round``) on the
    MODEL_MESH_WORLD gloo ranks of :func:`mesh_spawn` (``ranks``; None:
    spawned here), on the card (a ``FileStore`` in their directory; the
    collectives go through the host, not NVLink; the ranks time-share one
    card, so their ms are not a four-card mesh's).  Here K1h is timed
    first (:func:`model_mesh_k1h`, into ``rec``); then the ranks take a CUDA context and their
    first forward and backward while this process runs both phases'
    world-size-1 parts (:func:`model_mesh_world1`,
    :func:`pod_round_world1`).  Then the ranks run model_mesh's stages:

    * FedAvg TopK(0.1) and FedComLoc Q_r(8) with the packed Q_r(8)
      downlink on the composed meshes of MODEL_MESH_WAVES against the same
      runs on the flat meshes of as many clients ranks (held by
      :func:`model_mesh_check`), then FedAvg's steady rounds in turns;

    and pod_round's, ``launch/fed_train.py``'s pod round (one client a
    rank of a ``("pod", "data", "model")`` mesh, the sync as collectives)
    with qwen2-0.5b at full width, MODEL_MESH_LAYERS of 24 layers,
    float32, seeded init, seq MODEL_MESH_SEQ, POD_STEPS local steps,
    POD_ROUNDS rounds, TopK(quantile, 0.1), Q_r(8) and the int8 sync at
    r = 7:

    * meshes (2, 1, 1) and (2, 2, 1), each held by :func:`pod_round_check`
      against the stacked round of the same 2 clients on rank 0, then
      TopK's pod round at POD_TIMED and the stacked round in turns.
    """
    t0 = time.time()
    if ranks is None:
        ranks = mesh_spawn(dev.type, reduced)
    ctx, tmp = ranks
    try:
        if dev.type == "cuda":
            model_mesh_k1h(torch, dev, rec, reduced)
        open(f"{tmp}/start", "w").close()
        model_mesh_world1(torch, dev, f"{tmp}/mm", reduced)
        pod_round_world1(torch, dev, f"{tmp}/pr", launches, reduced)
        t_go = time.time()
        for part in ("mm", "pr"):
            open(f"{tmp}/{part}/go", "w").close()
        results = _mesh_join(ctx, tmp)
    finally:
        mesh_stop(ranks)
    mm, pr = results["mm"], results["pr"]
    t_mm = max(r["t_end"] for r in mm.values())
    print(f"[model_mesh] this process (K1h, both world-size-1 parts): "
          f"{t_go - t0:.1f} s, the ranks starting meanwhile; the ranks' "
          f"model_mesh stages {t_mm - t_go:.1f} s (the last rank ready "
          f"{max(r['t_warm'] for r in mm.values()) - t_go:+.1f} s from "
          f"their start), pod_round meshes {time.time() - t_mm:.1f} s",
          flush=True)
    model_mesh_check(torch, mm, launches)
    print(f"[model_mesh] {MODEL_MESH_WORLD} gloo ranks time-share one card: "
          f"their ms are not a {MODEL_MESH_WORLD}-card mesh's; card: "
          f"{card_line()}", flush=True)
    pod_round_check(pr, launches)
    print(f"[pod_round] {MODEL_MESH_WORLD} gloo ranks time-share one card "
          f"and move their collectives through the host, not over NVLink; "
          f"card: {card_line()}", flush=True)


def population_phase(torch, dev, launches: dict) -> None:
    """Phase 9: ``benchmarks/population_scale.py`` through the port at
    10^6 clients: FedComLoc-Com with error feedback and LoCoDL (lam 0.5),
    TopK(0.1), on ``SyntheticFederatedData``, the diurnal + churn trace
    with the tree sampler, two sync tiers over 8 edges and a pipelined,
    memory-mapped ``HostStore``; each row held to the artifact's
    size-free fields.  Then device memory at 10^5 against 10^6, the plain
    store against the pipelined one, and the Gumbel sampler's time.  First
    the card is held to the CPU (the plain versions) at this path's
    shapes: a few clients' batches, and round 0 of ``fedcomloc_pop``
    from the card's batches on."""
    import resource
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import prng
    from repro_torch.compress import TopK
    from repro_torch.core.aggregation import (
        AggregationPolicy, HierarchicalPolicy)
    from repro_torch.core.client_store import HostStore
    from repro_torch.core.clients import (
        ClientAvailability, ClientProfile, ClientSchedule)
    from repro_torch.core.fed_data import SyntheticFederatedData
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.core.locodl import LoCoDL, LoCoDLConfig
    from repro_torch.kernels import ops

    art = {row["name"]: row for row in json.loads(
        (ROOT / POP_ARTIFACT).read_text())["rows"]}

    def loss_fn(p, xb, yb):
        pred = torch.bmm(xb, p["w"].unsqueeze(-1)).squeeze(-1)
        return 0.5 * ((pred - yb) ** 2).mean(-1)

    def build(name, n, store, sampler="tree", device=dev):
        avail = ClientAvailability.diurnal(
            n, period=24.0, amp=0.8, churn_rate=0.05, online_frac=0.7,
            seed=0)
        sched = ClientSchedule(profile=ClientProfile.homogeneous(n),
                               availability=avail, bit_cost=1e-9,
                               sampler=sampler)
        policy = HierarchicalPolicy(edge=AggregationPolicy.sync(),
                                    server=AggregationPolicy.sync(),
                                    n_edges=POP_EDGES, edge_latency=0.5)
        data = SyntheticFederatedData.create(n, POP_DIM, hetero=0.2,
                                             noise=0.01, seed=0,
                                             device=device)
        if name == "fedcomloc_pop":
            cfg = FedComLocConfig(gamma=0.1, p=0.2, n_clients=n,
                                  clients_per_round=POP_COHORT,
                                  batch_size=POP_BATCH, variant="com",
                                  error_feedback=True)
            return FedComLoc(loss_fn, data, cfg, TopK(density=0.1),
                             schedule=sched, policy=policy, store=store)
        cfg = LoCoDLConfig(gamma=0.1, p=0.2, lam=0.5, n_clients=n,
                           clients_per_round=POP_COHORT, batch_size=POP_BATCH)
        return LoCoDL(loss_fn, data, cfg, TopK(density=0.1), schedule=sched,
                      policy=policy, store=store)

    def eval_loss(data, params, n):
        """The benchmark's held-out loss: 512 fresh draws from each of 8
        spread-out clients."""
        tot = 0.0
        for c in range(8):
            xb, yb = data.sample_batch(prng.PRNGKey(10_000 + c),
                                       torch.tensor(c * (n // 8)), 512)
            tot += float(0.5 * ((xb @ params["w"] - yb) ** 2).mean())
        return tot / 8

    def timed_sampling(alg):
        """Wall seconds of each cohort draw, the card's work included: the
        round's ``sample_cohort`` calls, and the tree sampler's draws
        (memoised: the planner draws, the round reads the memo)."""
        sched, spent = alg.sched, []
        owner, attr = ((sched.tree_sampler, "draw") if sched.uses_host_sampler
                       else (sched, "sample_cohort"))
        draw = getattr(owner, attr)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = draw(*a, **kw)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            return out

        object.__setattr__(owner, attr, timed)
        return spent

    def run(name, n, rounds, prefetch=True, sampler="tree"):
        spool = tempfile.mkdtemp(prefix="popscale_")
        try:
            store = HostStore(mmap_dir=spool, prefetch=prefetch)
            alg = build(name, n, store, sampler)
            sampled = timed_sampling(alg)
            p0 = {"w": torch.zeros(POP_DIM, device=dev)}
            state = alg.init(p0)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (state, m), counts = counted(torch, ops, lambda: alg.run_rounds(
                state, prng.PRNGKey(1), rounds))
            store.flush()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            shutil.rmtree(spool, ignore_errors=True)
        return {"alg": alg, "state": state, "m": m, "counts": counts,
                "wall": wall, "peak": peak, "draws_ms": [
                    t * 1e3 for t in sampled if t > 1e-4],
                "tel": store.telemetry(), "p0": p0}

    # the card's procedural data against the CPU's: w_c and x bit for bit
    t_check = time.time()
    datas = {d: SyntheticFederatedData.create(
        POP_N, POP_DIM, hetero=0.2, noise=0.01, seed=0, device=d)
        for d in (dev, "cpu")}
    cl = torch.tensor(POP_SAMPLE_CLIENTS)
    keys = prng.split(prng.PRNGKey(7), len(POP_SAMPLE_CLIENTS))
    (xg, yg), (xc, yc) = (datas[d].sample_batch(keys, cl, POP_BATCH)
                          for d in (dev, "cpu"))
    wg, wc = (datas[d].client_weights(cl) for d in (dev, "cpu"))
    y_err = float((yg.cpu() - yc).abs().max())
    if not (torch.equal(wg.cpu(), wc) and torch.equal(xg.cpu(), xc)
            and y_err <= POP_Y_RTOL * float(yc.abs().max())):
        raise AssertionError(f"population: the card's batches differ from "
                             f"the CPU's (w_c equal "
                             f"{torch.equal(wg.cpu(), wc)}, x equal "
                             f"{torch.equal(xg.cpu(), xc)}, y err {y_err!r})")
    print(f"[population] SyntheticFederatedData on the card == CPU for "
          f"clients {list(POP_SAMPLE_CLIENTS)}: w_c and x {tuple(xg.shape)} "
          f"bit for bit, y within {POP_Y_RTOL} * max |y| (max abs err "
          f"{y_err!r})", flush=True)
    card_data = datas[dev]
    del datas, xg, yg, xc, yc

    class CardDraws:
        """The card's batches, handed to the CPU's algorithm: drawing 5 x
        64 x 256 x 2048 normals on the host takes minutes, and the draws
        were held to the CPU's just above."""
        device = torch.device("cpu")

        def sample_batch(self, keys, clients, batch):
            x, y = card_data.sample_batch(keys, clients, batch)
            return x.cpu(), y.cpu()

    def replayed(d):
        alg = build("fedcomloc_pop", POP_N, HostStore(), device=d)
        if d == "cpu":
            alg.data = CardDraws()
        return alg

    # round 0 of fedcomloc_pop on the card and on the CPU (everything
    # after the draws), each with a plain host store of its own
    replay_on_cpu(
        torch, prng, replayed, {"w": torch.zeros(POP_DIM, device=dev)}, 1,
        f"population fedcomloc_pop n={POP_N}",
        exact=("client_steps", "uplink_bits", "client_uplink_bits",
               "clients_aggregated", "edges_aggregated"),
        close=("sim_time",), x_rtol=LOSS_RTOL)
    print(f"[population] the card against the CPU took "
          f"{time.time() - t_check:.1f} s", flush=True)

    main_draws = {}
    for name in ("fedcomloc_pop", "locodl_pop"):
        r = run(name, POP_N, POP_ROUNDS)
        main_draws[name] = r["draws_ms"]
        m, tel, alg = r["m"], r["tel"], r["alg"]
        host_mb = (tel["bytes_gathered"] + tel["bytes_scattered"]) / 1e6
        row = {
            "uplink_mbits": float(np.sum(m["uplink_bits"])) / 1e6,
            "host_spool_mb_per_round": host_mb / POP_ROUNDS,
            "clients_aggregated": float(np.mean(m["clients_aggregated"])),
            "edges_aggregated": float(np.mean(m["edges_aggregated"])),
            "sim_time": float(np.sum(m["sim_time"])),
        }
        want = art[name]
        for field, digits in POP_FIELDS.items():
            if round(row[field], digits) != want[field]:
                raise AssertionError(f"population {name}: {field} "
                                     f"{row[field]!r} != artifact "
                                     f"{want[field]!r}")
        for field in POP_STORE_FIELDS:
            if tel[field] != want["store"][field]:
                raise AssertionError(f"population {name}: store {field} "
                                     f"{tel[field]} != artifact "
                                     f"{want['store'][field]}")
        ev0 = eval_loss(alg.data, r["p0"], POP_N)
        ev1 = eval_loss(alg.data, r["state"].x, POP_N)
        losses = m["train_loss"].tolist()
        if not (math.isfinite(ev1) and ev1 < ev0
                and all(map(math.isfinite, losses))):
            raise AssertionError(f"population {name}: eval loss {ev0!r} -> "
                                 f"{ev1!r}, train losses {losses}")
        want_counts = {FUSED_K1_K2: POP_ROUNDS}
        if r["counts"] != want_counts:
            raise AssertionError(f"population {name}: launch counts "
                                 f"{r['counts']} != {want_counts}")
        launches.setdefault(FUSED_K1_K2, {})[f"population {name}"] = \
            r["counts"][FUSED_K1_K2]
        sample_s = alg.sched.tree_sampler.sample_seconds
        critical = sample_s + tel["gather_seconds"] + tel["scatter_seconds"]
        phases = {"sample_s": sample_s, "gather_s": tel["gather_seconds"],
                  "scatter_s": tel["scatter_seconds"],
                  "apply_worker_s": tel["apply_seconds"],
                  "prefetch_worker_s": tel["prefetch_seconds"],
                  "compute_s": max(r["wall"] - critical, 0.0)}
        print(f"[population] {name} n={POP_N}: {POP_ROUNDS} rounds in "
              f"{r['wall']!r} s, ms/round {r['wall'] / POP_ROUNDS * 1e3!r}; "
              f"phases {phases}; store {{"
              + ", ".join(f"{k}: {tel[k]}" for k in POP_STORE_FIELDS
                          + ("flush_stalls",)) + "}", flush=True)
        print(f"[population] {name}: " + ", ".join(
            f"{k} {row[k]!r} (artifact {want[k]!r})" for k in POP_FIELDS)
            + f"; eval loss {ev0!r} -> {ev1!r} (artifact, JAX on a CPU with "
            f"an older key stream: {want['eval_loss_init']!r} -> "
            f"{want['eval_loss_final']!r}); train loss {losses[0]!r} -> "
            f"{losses[-1]!r}; K1 + K2 launches {r['counts']}; peak device "
            f"memory {r['peak'] / 1e6!r} MB above the state; peak host RSS "
            f"of the process {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0!r}"
            f" MB", flush=True)

    # device memory holds the cohort, not the population
    small = run("fedcomloc_pop", POP_N_SMALL, POP_CHECK_ROUNDS)
    full = run("fedcomloc_pop", POP_N, POP_CHECK_ROUNDS)
    hi, lo = max(small["peak"], full["peak"]), min(small["peak"], full["peak"])
    if not (hi - lo <= POP_MEM_REL * hi and hi < POP_MEM_CAP):
        raise AssertionError(f"population: peak device memory {small['peak']}"
                             f" B at n={POP_N_SMALL} vs {full['peak']} B at "
                             f"n={POP_N} (within {POP_MEM_REL}, below "
                             f"{POP_MEM_CAP})")
    print(f"[population] peak device memory over {POP_CHECK_ROUNDS} rounds: "
          f"{small['peak'] / 1e6!r} MB at n={POP_N_SMALL}, "
          f"{full['peak'] / 1e6!r} MB at n={POP_N} (one stacked slot: "
          f"{POP_N * POP_DIM * 4 / 1e6!r} MB)", flush=True)

    # the plain store gives the pipelined one's bits
    plain = run("fedcomloc_pop", POP_N, POP_CHECK_ROUNDS, prefetch=False)
    same_x = torch.equal(plain["state"].x["w"].view(torch.int32),
                         full["state"].x["w"].view(torch.int32))
    same_m = all(np.array_equal(plain["m"][k], full["m"][k])
                 for k in full["m"])
    if not (same_x and same_m and sorted(plain["m"]) == sorted(full["m"])):
        raise AssertionError(f"population: plain store != pipelined store "
                             f"(x {same_x}, metrics {same_m})")
    print(f"[population] plain HostStore == pipelined HostStore bit for bit "
          f"over {POP_CHECK_ROUNDS} rounds (x and every metric); plain "
          f"{plain['wall'] / POP_CHECK_ROUNDS * 1e3!r} ms/round, pipelined "
          f"{full['wall'] / POP_CHECK_ROUNDS * 1e3!r}", flush=True)

    # the O(n) Gumbel-top-k on the card against the tree sampler
    gum = run("fedcomloc_pop", POP_N, POP_CHECK_ROUNDS, sampler="gumbel")
    print(f"[population] cohort draws at n={POP_N}, ms each: gumbel on the "
          f"card {gum['draws_ms']!r} (its rounds "
          f"{gum['wall'] / POP_CHECK_ROUNDS * 1e3!r} ms each); tree on the "
          f"host {full['draws_ms']!r} (the first builds the segment tree; "
          f"the 12-round runs' draws: {main_draws!r})", flush=True)

    # where a population round's time goes
    spool = tempfile.mkdtemp(prefix="popscale_")
    try:
        alg = build("fedcomloc_pop", POP_N,
                    HostStore(mmap_dir=spool, prefetch=True))
        profile_rounds(torch, prng, alg,
                       {"w": torch.zeros(POP_DIM, device=dev)},
                       f"population fedcomloc_pop n={POP_N}")
        alg.store.flush()
    finally:
        shutil.rmtree(spool, ignore_errors=True)


def backward_kernels_phase(torch, dev, recs) -> None:
    """Phase 15a: K11's and K12's backward kernels against their plain
    versions on the card, then timed at the training and the large
    shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6
    from repro_torch.models import rwkv6

    gen = torch.Generator(device=dev).manual_seed(15)

    def same_bits(a, b):
        """Bit-equal, NaN where the other has NaN (0 * inf at a = 1)."""
        nan = torch.isnan(a)
        return (torch.equal(nan, torch.isnan(b)) and torch.equal(
            a[~nan].view(torch.int32), b[~nan].view(torch.int32)))

    def rglru_inputs(b, t, d):
        x = torch.randn((b, t, d), generator=gen, device=dev)
        a = torch.rand((b, t, d), generator=gen, device=dev)
        y, _ = rg.rglru_scan(x, a)
        return x, a, y, torch.randn((b, t, d), generator=gen, device=dev)

    edge = rglru_inputs(2, 333, 2560)
    edge[1][0, :, :64] = 1e-7
    edge[1][0, :, 64:128] = 1.0 - 1e-7
    edge[1][1, :, :8] = 1.0                     # on max's tie: -inf, NaN
    edge[0][1, :5, :8] = 0.0
    cases = [("main", rglru_inputs(*BWD_MAIN["K11b"])),
             ("edges (a = 1e-7, 1 - 1e-7, 1)", edge),
             ("T=1", rglru_inputs(2, 1, 2560)),
             ("T=37 D=2579 B=1", rglru_inputs(1, 37, 2579)),
             ("T=4097 D=40 B=3", rglru_inputs(3, 4097, 40)),
             ("B=1 D=2560 (fewest warps)", rglru_inputs(1, 4096, 2560))]
    for label, args in cases:
        got = rg.rglru_scan_bwd(*args)
        want = ref.rglru_scan_bwd(*args)
        torch.cuda.synchronize()
        if not all(same_bits(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K11 backward {label}: kernel differs from "
                                 f"the plain version")
        for g, w in zip(got, want):
            fin = torch.isfinite(w)
            recs["K11b"].err(g[fin], w[fin])
    print(f"[train] K11 backward bit-equal to its plain version on "
          f"{len(cases)} cases (a = 1's inf and NaN in place, ragged T, D % "
          f"64 != 0)", flush=True)
    del cases, edge

    def wkv6_inputs(b, h, t, dtype):
        """``rwkv6._heads`` views of (B, T, H*64) activations, as the
        forward takes them; dy a (B, H, T, 64) view of (B, T, H, 64), as
        y's gradient arrives."""
        shape = (b, t, h * 64)
        r, k, v = (0.5 * torch.randn(shape, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        w = torch.rand(shape, generator=gen, device=dev)
        u = 0.1 * torch.randn((h, 64), generator=gen, device=dev)
        dy = torch.randn((b, t, h, 64), generator=gen, device=dev).to(dtype)
        r, k, v, w = (rwkv6._heads(z, 64) for z in (r, k, v, w))
        return r, k, v, w, u, dy.transpose(1, 2)

    def k12_case(label, args):
        got = wkv6.wkv6_scan_bwd(*args)
        want = ref.wkv6_scan_bwd(*(z.double() for z in args),
                                 dtype=torch.float64)
        torch.cuda.synchronize()
        worst = 0.0
        for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
            tol = K12_BWD_TOL * float(w.abs().max())
            if g.dtype == torch.bfloat16:
                tol = tol + bf16_ulp(torch, w).double()
            d = (g.double() - w).abs()
            q = float((d / tol).max())
            if q > 1.0:
                raise AssertionError(f"K12 backward {label}: {name} off by "
                                     f"{float(d.max())!r} (|d| / tol {q!r})")
            worst = max(worst, q)
            recs["K12b"].err(g.double(), w)
        return worst

    b, h, t, _ = BWD_MAIN["K12b"]
    held = wkv6_inputs(2, 4, 333, torch.bfloat16)
    held[3][:, 0] = 1e-7
    held[3][:, 1] = 1.0 - 1e-7
    cases = [("main bf16", wkv6_inputs(b, h, t, torch.bfloat16)),
             ("main f32", wkv6_inputs(b, h, t, torch.float32)),
             ("w = 1e-7 and 1 - 1e-7 on whole heads", held)]
    cases += [(f"T={tt}", wkv6_inputs(1, 3, tt, torch.bfloat16))
              for tt in (1, 9, 65)]
    # the chunked route's 16-step chunk edges, w exactly 0 on whole heads,
    # dy as a (B, H, T, 64) tensor and as a view whose rows are not
    # 16-byte aligned (the wrapper copies it)
    forget = wkv6_inputs(2, 4, 4095, torch.bfloat16)
    forget[3][0, :2] = 0.0
    forget[3][1, 3] = 0.0
    dense_dy = wkv6_inputs(1, 3, 100, torch.bfloat16)
    odd = torch.randn((1, 3, 100, 65), generator=gen, device=dev).to(
        torch.bfloat16)[..., 1:]
    cases += [(f"T={tt}", wkv6_inputs(1, 3, tt, torch.bfloat16))
              for tt in (15, 16, 17)]
    cases += [("T=4095, w = 0 on whole heads", forget),
              ("dy (B, H, T, 64) contiguous",
               (*dense_dy[:5], dense_dy[5].contiguous())),
              ("dy rows off 16-byte alignment", (*dense_dy[:5], odd))]
    worst = max(k12_case(label, args) for label, args in cases)
    print(f"[train] K12 backward within {K12_BWD_TOL} max |plain in float64| "
          f"(+ one bf16 ulp for bf16 gradients) on {len(cases)} cases, r/k/v "
          f"in bf16 and f32; worst |d| / tolerance {worst!r}", flush=True)
    del cases, held, forget, dense_dy, odd
    torch.cuda.empty_cache()

    for tag, shapes, iters, plain_iters, warm in (
            ("main", BWD_MAIN, 10, 1, 1), ("large", BWD_LARGE, 3, 1, 0)):
        bb, tt, d = shapes["K11b"]
        args11 = rglru_inputs(bb, tt, d)
        n = bb * tt * d
        # reads x, a, y, dy and writes dx, da (24 bytes an element); about
        # 15 operations an element, far below the float32 peak
        plans = {"K11b": (lambda: rg.rglru_scan_bwd(*args11),
                          lambda: ref.rglru_scan_bwd(*args11),
                          24 * n, 15 * n, F32_OPS_PER_S)}
        bb, h, tt, _ = shapes["K12b"]
        args12 = wkv6_inputs(bb, h, tt, torch.bfloat16)
        n = bb * h * tt * 64
        # reads bf16 r, k, v, dy and f32 w (12 bytes an element), writes
        # bf16 dr, dk, dv and f32 dw (10), u and du; the least work a
        # (b, h, t) is 12 operations a state entry (S's recurrence, G's,
        # and an FMA each for dr, dk, dv and dw), on bf16 inputs at the
        # bf16 tensor-core peak (float32's printed beside it)
        ops12 = 12 * 64 * n
        plans["K12b"] = (lambda: wkv6.wkv6_scan_bwd(*args12),
                         lambda: ref.wkv6_scan_bwd(*args12),
                         22 * n + 8 * h * 64, ops12, BF16_OPS_PER_S)
        print(f"[train] K12 backward {tag}: bound against float32's 67 "
              f"TFLOP/s {bound_ms(22 * n, ops12)!r}", flush=True)
        for key_, (kern, plain, nbytes, nops, peak) in plans.items():
            rec = recs[key_]
            b_ms, b_by = bound_ms(nbytes, nops, peak)
            row = {"shape": list(shapes[key_]),
                   "kernel_ms": time_ms(torch, kern, iters),
                   "plain_ms": time_ms(torch, plain, plain_iters, warm),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            rec.timings[tag] = row
            print(f"[train] {key_} {rec.name} {tag} {shapes[key_]}: "
                  f"kernel_ms={row['kernel_ms']!r} plain_ms="
                  f"{row['plain_ms']!r} library_ms=None (no one PyTorch call "
                  f"computes it) bound_ms={b_ms!r} ({b_by})", flush=True)
        del args11, args12, plans
        torch.cuda.empty_cache()


def block_grads_phase(torch, dev) -> None:
    """Phase 15b: one rglru block's and one rwkv time-mix's gradients at
    full width, float32, T = BLOCK_T, the card against the CPU."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_spec
    from repro_torch.models import rglru, rwkv6

    cpu_gen = torch.Generator().manual_seed(21)
    d_rwkv = get_spec("rwkv6-3b").model
    d_rg = get_spec("recurrentgemma-2b").model.d_model
    blocks = {
        "rglru block": (rglru.rglru_block,
                        rglru.rglru_init(cpu_gen, d_rg, d_rg), d_rg),
        "rwkv time-mix": (rwkv6.time_mix,
                          rwkv6.rwkv6_init(cpu_gen, d_rwkv.d_model,
                                           d_rwkv.d_ff), d_rwkv.d_model)}
    for label, (fn, params, d) in blocks.items():
        x = torch.randn((1, BLOCK_T, d), generator=cpu_gen)
        dy = torch.randn((1, BLOCK_T, d), generator=cpu_gen)
        grads = {}
        for where in ("cpu", "cuda"):
            live = [t.detach().to(where).requires_grad_()
                    for t in [x] + tree_util.leaves(params)]
            y = fn(tree_util.unflatten(params, live[1:]), live[0])
            grads[where] = torch.autograd.grad(y, live, dy.to(where),
                                               allow_unused=True,
                                               materialize_grads=True)
        worst = 0.0
        for g, c in zip(grads["cuda"], grads["cpu"]):
            scale = float(c.abs().max())
            d_ = float((g.cpu() - c).abs().max())
            if d_ > BLOCK_GRAD_TOL * scale:
                raise AssertionError(f"{label}: the card's gradient differs "
                                     f"from the CPU's by {d_!r} (max |cpu| "
                                     f"{scale!r})")
            worst = max(worst, d_ / scale if scale else 0.0)
        print(f"[train] {label} at d {d}, T {BLOCK_T}, float32: "
              f"{len(grads['cpu'])} gradients (x and every parameter) on the "
              f"card within {BLOCK_GRAD_TOL} max |cpu| of the CPU's; worst "
              f"{worst!r}", flush=True)


def seeded_batch(torch, spec, batch: int, seq: int, dev, seed: int = 0):
    """One (batch, seq) step's inputs in ``steps.batch_struct``'s layout:
    ``make_lm_tokens`` rows, seeded bf16 source frames (encoder-decoder)
    or prefix embeddings at ``PREFIX_SCALE`` (qwen2-vl)."""
    from repro_torch.data import synthetic
    from repro_torch.launch import steps

    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.from_numpy(synthetic.make_lm_tokens(
        min(spec.model.vocab, 4096), batch, seq, seed=seed)).to(
            dev, torch.int64)
    out = {}
    for name, s_ in steps.batch_struct(spec, batch, seq).items():
        if s_.dtype == torch.int64:
            out[name] = toks[:, :s_.shape[1]]
        else:
            scale = 1.0 if name == "src_embeds" else PREFIX_SCALE
            out[name] = (torch.randn(s_.shape, generator=gen, device=dev)
                         * scale).to(s_.dtype)
    return out


def train_steps_phase(torch, dev, launches) -> None:
    """Phase 15c: rwkv6-3b and recurrentgemma-2b at full width and depth,
    seamless-m4t-large-v2 too and qwen2-vl-7b at full width with
    ``TRAIN_LAYERS`` layers, bf16, Adam (``_optimizer_for``), TRAIN_STEPS
    steps on one fixed batch through ``steps.build_train_step``; the
    counters set to 0 before each step and read after."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_spec
    from repro_torch.configs.base import SHAPES, InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers

    for arch, (batch, seq, want) in TRAIN_SHAPES.items():
        spec = get_spec(arch)
        depth = "full width and depth"
        if arch in TRAIN_LAYERS:
            spec = dataclasses.replace(spec, model=dataclasses.replace(
                spec.model, n_layers=TRAIN_LAYERS[arch]))
            depth = (f"full width, {TRAIN_LAYERS[arch]} of "
                     f"{get_spec(arch).model.n_layers} layers")
        shape = InputShape(f"{SHAPES['train_4k'].name}, batch {batch}", seq,
                           batch, "train")
        bundle = steps.build_train_step(spec, shape)
        params = steps.init_params(spec,
                                   torch.Generator(device=dev).manual_seed(0))
        opt_state = optimizers.make(*steps._optimizer_for(spec))[0](params)
        data = seeded_batch(torch, spec, batch, seq, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        for i in range(TRAIN_STEPS):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            params, opt_state, loss = bundle.fn(params, opt_state, data)
            losses.append(float(loss))             # synchronises
            secs.append(time.perf_counter() - t0)
            got = {k: v for k, v in ops.launch_counts().items() if v}
            if got != want:
                raise AssertionError(f"{arch} step {i}: launches {got}, "
                                     f"expected {want}")
            for k, v in got.items():
                launches.setdefault(k, {})
                launches[k][f"{arch} train"] = (
                    launches[k].get(f"{arch} train", 0) + v)
        peak = torch.cuda.max_memory_allocated()
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"{arch}: losses {losses} (finite, falling "
                                 f"from step 1 to {TRAIN_STEPS} expected)")
        steady = statistics.median(secs[1:]) * 1e3
        n_params = sum(x.numel() for x in tree_util.leaves(params))
        print(f"[train] {arch} ({depth}, {n_params} params, "
              f"{str(spec.model.dtype).split('.')[-1]}, Adam "
              f"{steps._optimizer_for(spec)[1]}, batch {batch}, seq {seq}, "
              f"inputs {list(data)}): "
              f"losses {losses!r}; ms a step {[x * 1e3 for x in secs]!r}, "
              f"steady (median of steps 2-{TRAIN_STEPS}) {steady!r}, "
              f"tokens/s {batch * seq / steady * 1e3!r}; peak memory {peak} "
              f"B; launches a step {want}", flush=True)
        del params, opt_state, bundle, data
        torch.cuda.empty_cache()


def fed_round_phase(torch, dev, launches, arch: str = "rwkv6-3b",
                    only=None) -> None:
    """Phase 15d: ``build_fed_round`` on ``arch`` at full width and depth:
    FED_CLIENTS stacked clients, FED_LOCAL_STEPS local steps, the default
    gamma and p, one round each with TopK(quantile, 0.1), Q_r(8) (K3 and
    the keyed K4 on every leaf) and the int8 sync (r = 7), or the runs
    named in ``only``.  Each run's launches join ``launches``."""
    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.compress.compressors import TopK
    from repro_torch.compress.report import INDEX_BITS
    from repro_torch.configs import get_spec
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import fed_train, steps

    spec = get_spec(arch)
    depth = "full width and depth"
    if arch in TRAIN_LAYERS:
        spec = dataclasses.replace(spec, model=dataclasses.replace(
            spec.model, n_layers=TRAIN_LAYERS[arch]))
        depth = (f"full width, {TRAIN_LAYERS[arch]} of "
                 f"{get_spec(arch).model.n_layers} layers")

    def stacked_init():
        """The clients' stacked weights (every run from the same seeded
        init, made anew: holding one copy of rwkv6-3b's 6.1 GB beside the
        round would take the int8 run to ~75 GB)."""
        one = steps.init_params(spec,
                                torch.Generator(device=dev).manual_seed(0))
        return tree_util.map(lambda x: torch.stack([x] * FED_CLIENTS), one)

    leaves = tree_util.leaves(stacked_init())
    n = sum(x[0].numel() for x in leaves)
    n_leaves = len(leaves)
    del leaves
    # each client's batch of 1 (the clients' rows differ)
    data = {name: x[:, None] for name, x in seeded_batch(
        torch, spec, FED_CLIENTS, FED_SEQ, dev).items()}
    sent = []                     # the TopK payloads' (value + index) bits
    orig_compress = TopK.compress

    def recording(self, stacked, keys=None, **kw):
        out, rep = orig_compress(self, stacked, keys, **kw)
        sent.append(sum(int((x != 0).sum()) * (x.element_size() * 8
                                               + INDEX_BITS)
                        for x in tree_util.leaves(out)))
        return out, rep

    runs = {"topk (quantile, 0.1)": (dict(compressor="topk", density=0.1),
                                     None),
            "quant r=8": (dict(compressor="quant", quant_bits=8),
                          FED_CLIENTS * (n * 9 + n_leaves * 32)),
            "quant r=7, int8 sync": (dict(compressor="quant", quant_bits=7,
                                          sync_mode="int8"),
                                     FED_CLIENTS * (n * 8 + n_leaves * 32))}
    for label, (kw, closed) in runs.items():
        if only is not None and label not in only:
            continue
        fed = fed_train.FedTrainConfig(local_steps=FED_LOCAL_STEPS, **kw)
        bundle = fed_train.build_fed_round(
            spec, InputShape("fed", FED_SEQ, FED_CLIENTS, "train"), fed)
        params = stacked_init()
        h = tree_util.map(torch.zeros_like, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        sent.clear()
        TopK.compress = recording
        t0 = time.perf_counter()
        try:
            params, h, loss, bits = bundle.fn(params, h, data,
                                              prng.PRNGKey(1))
            loss, bits = float(loss), float(bits)   # synchronise
        finally:
            TopK.compress = orig_compress
        ms = (time.perf_counter() - t0) * 1e3
        if closed is None:
            closed = sum(sent)
        if not (math.isfinite(loss) and abs(bits - closed)
                <= (n_leaves + 3) * FED_BITS_ULPS * closed):
            raise AssertionError(f"fed round {label}: loss {loss!r}, "
                                 f"comm_bits {bits!r} against the closed "
                                 f"form {closed}")
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        if kw["compressor"] == "quant" and "sync_mode" not in kw and not (
                counts.get("l2_norm") == counts.get("quantize_qr")
                == n_leaves):
            raise AssertionError(f"fed round {arch} {label}: launches "
                                 f"{counts}; one K3 and one K4 a leaf "
                                 f"({n_leaves}) expected")
        for k, v in counts.items():
            launches.setdefault(k, {})[f"fed round {arch} {label}"] = v
        print(f"[train] fed round {arch} ({depth}) {label}: {FED_CLIENTS} "
              f"clients, "
              f"{FED_LOCAL_STEPS} local steps, seq {FED_SEQ} (inputs "
              f"{list(data)}): loss {loss!r}, "
              f"comm_bits {bits!r} (closed form {closed}, {n} parameters in "
              f"{n_leaves} tensors), {ms!r} ms, peak memory "
              f"{torch.cuda.max_memory_allocated()} B, launches {counts}",
              flush=True)
        del params, h, bundle
        torch.cuda.empty_cache()


def mm_serve_phase(torch, dev) -> None:
    """Phase 16: qwen2-vl-7b and seamless-m4t-large-v2 served at full width
    and depth, bf16, seeded weights (``VLM_SERVE``, ``ENCDEC_SERVE``), 32
    greedy decode steps.  The counters are set to 0 just before the counted
    run and read just after: neither path launches a kernel.  Then the
    median of SERVE_TIMED warm prefills and of the per-step decode times,
    tokens/s and peak memory."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_spec
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm

    for arch in ("qwen2-vl-7b", "seamless-m4t-large-v2"):
        spec = get_spec(arch)
        m = spec.model
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        gen = torch.Generator(device=dev).manual_seed(0)
        params = steps.init_params(spec, gen)
        n_params = sum(x.numel() for x in tree_util.leaves(params))
        if spec.is_encdec:
            batch, frames, prefix = ENCDEC_SERVE
            src = torch.randn((batch, frames, m.d_model), generator=gen,
                              device=dev)
            prompts = serve.prompts_for(m, batch, prefix, dev)
            what = (f"{frames} source frames, target prefix {prefix}, "
                    f"through serve()")
            max_len = prefix + SERVE_GEN + 1

            def prefill():
                return encdec.prefill(params, m, src, prompts, max_len)

            def decode(tok, st):
                return encdec.decode_step(params, m, tok, st)

            def counted():
                res = serve.serve(params, m, prompts, SERVE_GEN,
                                  src_embeds=src)
                return res.prefill_logits, res.logits, res.tokens
        else:
            batch, npre, n_text = VLM_SERVE
            data = seeded_batch(torch, spec, batch, npre + n_text, dev)
            max_len = npre + n_text + SERVE_GEN + 1
            bundle = steps.build_prefill_step(
                spec, InputShape("vlm serve", max_len, batch, "prefill"))
            data["tokens"] = data["tokens"][:, :n_text]
            what = (f"{npre} prefix embeddings + {n_text} tokens, through "
                    f"steps.build_prefill_step (caches of {max_len})")

            def prefill():
                return bundle.fn(params, data)

            @torch.no_grad()
            def decode(tok, st):
                return tfm.decode_step(params, m, tok, st)

            def counted():
                logits, st = prefill()
                first, seen, out = logits, [], []
                tok = logits.argmax(-1)
                for _ in range(SERVE_GEN):
                    out.append(tok)
                    logits, st = decode(tok, st)
                    seen.append(logits)
                    tok = logits.argmax(-1)
                return first, seen, torch.stack(out, 1)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            first, seen, toks = counted()
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        if counts:
            raise AssertionError(f"{arch}: serve launched {counts}")
        finite = bool(torch.isfinite(first).all()) and all(
            bool(torch.isfinite(x).all()) for x in seen)
        if not finite or tuple(toks.shape) != (batch, SERVE_GEN):
            raise AssertionError(f"{arch}: non-finite logits or tokens of "
                                 f"shape {tuple(toks.shape)}")
        pre_ms, step_ms = [], []
        with torch.no_grad():
            for _ in range(SERVE_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, st = prefill()
                torch.cuda.synchronize()
                pre_ms.append((time.perf_counter() - t0) * 1e3)
            tok = logits.argmax(-1)
            for _ in range(SERVE_GEN):
                t0 = time.perf_counter()
                logits, st = decode(tok, st)
                tok = logits.argmax(-1)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - before
        step_med = statistics.median(step_ms)
        dt = str(m.dtype).split(".")[-1]
        print(f"[serve] {arch}: {n_params} params {dt}, batch {batch}, "
              f"{what}, gen {SERVE_GEN}: prefill ms median "
              f"{statistics.median(pre_ms)!r} of {pre_ms!r}; decode ms/step "
              f"median {step_med!r} (min {min(step_ms)!r}, max "
              f"{max(step_ms)!r}; {batch * 1e3 / step_med!r} tokens/s); the "
              f"counted run (prefill + {SERVE_GEN} decode steps) "
              f"{counted_s * 1e3!r} ms; peak memory {peak} B "
              f"(max_memory_allocated over what was allocated before the "
              f"weights); launches none; tokens[0][:8] "
              f"{toks[0, :8].tolist()}", flush=True)
        del params, st, logits, first, seen
        torch.cuda.empty_cache()


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
    t_start = time.time()
    t_lap = [t_start]

    def lap(what: str) -> None:
        now = time.time()
        print(f"[phases] {what} took {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    # the ranks of phases 8c and 8d import while the kernels build
    mesh_ranks = mesh_spawn(dev.type)
    atexit.register(mesh_stop, mesh_ranks)

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
        # K1's histogram pass alone: the model-sharded wire walks the
        # counts summed over the model ranks (the model_mesh phase)
        "K1h": KernelRecord("topk_radix_hist", csrc + "topk_compress.cu",
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
        # the backward kernels replace no Pallas kernel: the JAX package
        # differentiates its ref.py scans (the file:line of each)
        "K11b": KernelRecord("rglru_scan_bwd", csrc + "rglru_scan.cu",
                             tpu + "ref.py:430"),
        "K12b": KernelRecord("wkv6_scan_bwd", csrc + "wkv6_bwd.cu",
                             tpu + "ref.py:478"),
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
    # the population phase's cohort rows at TopK(0.1)
    topk_cases.append((f"population ({POP_COHORT}, {POP_DIM})",
                       randn(POP_COHORT, POP_DIM), 205))
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
    # K1's histogram pass alone, at every digit of the walk under each
    # row's decided prefix, and the walk it drives (one rank: the sum is
    # the counts themselves; two halves of each row: their counts summed)
    hist_cases = 0
    for label, xc, k in topk_cases:
        if isinstance(k, torch.Tensor) or not 0 < k < xc.shape[1]:
            continue
        bits = ref.mag_bits(xc)
        t = ref.topk_threshold_bits(xc, k)
        for shift in ref.RADIX_SHIFTS:
            high = ((ref.ALL_ONES << (shift + 8)) & ref.ALL_ONES
                    if shift + 8 < 32 else 0)
            h = tk.radix_hist(xc, t & high, shift)
            h_ref = ref.radix_digit_hist(bits, t & high, shift)
            torch.cuda.synchronize()
            if not torch.equal(h.long(), h_ref):
                raise AssertionError(f"K1h {label} shift {shift}: kernel "
                                     f"histogram differs")
            recs["K1h"].err(h, h_ref)
            hist_cases += 1
        walked = tk.threshold_bits_sharded([xc], [k], [xc.shape[1]],
                                           lambda h: h)[0]
        if not torch.equal(walked, t):
            raise AssertionError(f"K1h {label}: the walk's threshold differs")
        rows, n = xc.shape
        if n % 2 == 0:
            halves = xc.reshape(rows * 2, n // 2)
            summed = tk.threshold_bits_sharded(
                [halves], [k], [n], lambda h: h.reshape(rows, 2, -1).sum(
                    1, keepdim=True).expand(rows, 2, 256).reshape(h.shape))[0]
            if not torch.equal(summed.reshape(rows, 2),
                               t[:, None].expand(rows, 2)):
                raise AssertionError(f"K1h {label}: the halves' summed walk "
                                     f"differs from K1")
    # grouped: many leaves of the same rows in one launch a digit (an
    # unaligned slice, n % 4 != 0, one-element slices, ties, +-0,
    # subnormals), with k of 0 and n among them
    sizes = (1, 3, 32, 64, 4097, 50176, 50177, 5000, 1 << 20)
    gx = []
    for i, n in enumerate(sizes):
        xg = randn(s, n)
        xg[0, ::7] = 0.5
        xg[-1, : n // 3] = 0.0
        xg[-1, 1: n // 3: 5] = -0.0
        xg[0, 1::11] = 1e-40
        gx.append(xg)
    gx.append(randn(1, s * 777 + 1)[0, 1:].view(s, 777))   # unaligned
    gn = [x.shape[1] for x in gx]
    gk = [max(1, n // 10) for n in gn]
    gk[0], gk[1] = 0, gn[1]
    gbits = [ref.mag_bits(x) for x in gx]
    gt = [tk.threshold_bits(x, k) for x, k in zip(gx, gk)]
    for shift in ref.RADIX_SHIFTS:
        high = ((ref.ALL_ONES << (shift + 8)) & ref.ALL_ONES
                if shift + 8 < 32 else 0)
        prefix = torch.cat([ref.topk_threshold_bits(x, max(1, n // 10)) & high
                            for x, n in zip(gx, gn)])
        h = tk.radix_hist_grouped(gx, prefix, shift)
        h_ref = ref.radix_digit_hist_grouped(gbits, prefix, shift)
        torch.cuda.synchronize()
        if not torch.equal(h.long(), h_ref):
            raise AssertionError(f"K1h grouped shift {shift}: kernel "
                                 f"histograms differ")
        recs["K1h"].err(h, h_ref)
        hist_cases += 1
    walked = tk.threshold_bits_sharded(gx, gk, gn, lambda h: h)
    if not all(torch.equal(a, b) for a, b in zip(walked, gt)):
        raise AssertionError("K1h grouped: the walk's thresholds differ "
                             "from K1's")
    even = [i for i, n in enumerate(gn) if n % 2 == 0]
    summed = tk.threshold_bits_sharded(
        [gx[i].reshape(2 * s, -1).contiguous() for i in even],
        [gk[i] for i in even], [gn[i] for i in even],
        lambda h: h.reshape(-1, 2, 256).sum(1, keepdim=True).expand(
            -1, 2, 256).reshape(h.shape))
    if not all(torch.equal(a.reshape(s, 2), gt[i][:, None].expand(s, 2))
               for a, i in zip(summed, even)):
        raise AssertionError("K1h grouped: the halves' summed walk differs "
                             "from K1")
    del gx, gbits
    print(f"[kernels] K1h (K1's histogram pass alone) bit-equal to the plain "
          f"version on {hist_cases} (case, digit) pairs, K1's cases on one "
          f"leaf and {len(gn)} leaves grouped; its walk equal "
          f"to K1's threshold on one rank and over two halves summed",
          flush=True)
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
        # one r a row (per-client overrides): r, 4, 8, 1, 16 cycled
        r_rows = torch.tensor([(r, 4, 8, 1, 16)[j % 5]
                               for j in range(xc.shape[0])])
        rows_out = qk.quantize_qr_keyed(xc, r_rows, keys, norm)
        rows_ref = ref.quantize_qr_with_uniforms(
            xc, r_rows, prng.uniform(keys, xc.shape[1], device=dev), norm)
        torch.cuda.synchronize()
        if not torch.equal(norm, again):
            raise AssertionError(f"K3 {label}: two runs gave different norms")
        # K3's sum-of-squares entry: the value the norm is the root of
        if not same_bits(torch.sqrt(qk.sum_squares(xc)), norm):
            raise AssertionError(f"K3 sum_squares {label}: its root differs "
                                 f"from K3's norm")
        if not torch.allclose(norm, norm_ref, rtol=NORM_RTOL, atol=0.0):
            raise AssertionError(f"K3 {label}: norm off by more than "
                                 f"rtol {NORM_RTOL}")
        if not same_bits(out, out_ref):
            raise AssertionError(f"K4 {label}: kernel output differs")
        if not same_bits(keyed, keyed_ref):
            raise AssertionError(f"K4 keyed {label}: kernel output differs "
                                 f"from prng.uniform + the plain version")
        if not same_bits(rows_out, rows_ref):
            raise AssertionError(f"K4 per-row levels {label}: kernel output "
                                 f"differs from prng.uniform + the plain "
                                 f"version")
        recs["K4"].err(rows_out.float(), rows_ref.float())
        recs["K3"].err(norm, norm_ref)
        recs["K4"].err(out.float(), out_ref.float())
        recs["K4"].err(keyed.float(), keyed_ref.float())
    print(f"[kernels] K4 (both entries: reading u, and drawing it with "
          f"threefry against prng.uniform, key words >= 2^31, the keyed one "
          f"also with one r a row) bit-equal and "
          f"K3 within rtol {NORM_RTOL} (and deterministic; its sum-of-"
          f"squares entry's root bit-equal to it) on {len(qr_cases)} cases",
          flush=True)
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
                # the per-row-levels entry (per-client r: 4, 8, 1, 16, ...
                # cycled), timed beside the scalar keyed entry, in turns;
                # bit-equal to prng.uniform + the plain version at main
                # and large.  Its bound adds the levels' 4 bytes a row.
                r_rows = torch.tensor([(4, 8, 1, 16)[j % 4]
                                       for j in range(rows)])
                per_row = lambda: qk.quantize_qr_keyed(xc, r_rows, keys, norm)
                got = per_row()
                want = ref.quantize_qr_with_uniforms(
                    xc, r_rows, prng.uniform(keys, n, device=dev), norm)
                if not same_bits(got, want):
                    raise AssertionError(f"K4 per-row levels {tag}: differs "
                                         f"from its plain version")
                recs["K4"].err(got.float(), want.float())
                del got, want
                rt = {"per-row levels": [], "scalar keyed": []}
                for name_ in list(rt) * 2:
                    rt[name_].append(time_ms(torch, per_row if name_ ==
                                             "per-row levels" else kern,
                                             iters))
                pr_bound, pr_by = bound_ms(8 * nx + 16 * rows,
                                           k4_int_ops * nx, int_peak)
                _, pr_ops = device_per_call(torch, per_row, 5)
                row["per_row_levels"] = {
                    "ms": min(rt["per-row levels"]),
                    "scalar_keyed_ms_in_turns": min(rt["scalar keyed"]),
                    "bound_ms": pr_bound, "bound_by": pr_by,
                    "device_ops_a_call": pr_ops, "bit_equal": True}
                print(f"[kernels] K4 per-row levels {tag} {shape}: ms in "
                      f"turns {rt!r} (scalar keyed beside it); bound "
                      f"{pr_bound!r} ms ({pr_by}); {pr_ops!r} device "
                      f"operations a call (the levels' copy and K4); "
                      f"bit-equal to prng.uniform + the plain version",
                      flush=True)
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

    lap("build and kernels")

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

            def recording(key_, s_, round_idx=0, device=None,
                          _sample=sample, _log=cohorts):
                clients, avail = _sample(key_, s_, round_idx, device=device)
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

    lap("quickstart train")

    # ---- 4. fig9, 5. hetero ------------------------------------------------ #
    cifar = cifar_setup(torch, dev)
    fig9_phase(torch, dev, cifar, launches)
    hetero_phase(torch, dev, cifar, launches)
    del cifar
    torch.cuda.empty_cache()
    lap("fig9 and hetero")

    # ---- 6. downlink, 7. het_system, 8. scope ------------------------------ #
    mnist = {"loss_fn": loss_fn, "data": data, "eval_fn": eval_fn,
             "params0": params0}
    downlink_phase(torch, dev, mnist, launches)
    het_system_phase(torch, dev, mnist, launches)
    scope_phase(torch, dev, mnist, launches)
    lap("downlink, het_system and scope")
    client_mesh_phase(torch, dev, mnist, launches)
    lap("client_mesh")
    mesh_phases(torch, dev, launches, mesh_ranks, rec=recs["K1h"])
    lap("model_mesh and pod_round")
    del mnist, data
    torch.cuda.empty_cache()

    # ---- 9. population ----------------------------------------------------- #
    population_phase(torch, dev, launches)
    torch.cuda.empty_cache()
    lap("population")

    # ---- 10. scans, 11.-12. serve, 13. attention, 14. CUDA against CPU ----- #
    check_scan_kernels(torch, dev, recs)
    lap("scans")
    launches.update(serve_phase(torch, dev, SERVE_SHAPES)[0])
    lap("serve")
    _, captured = serve_phase(torch, dev, DENSE_SHAPES, ATTN_CAPTURE)
    lap("dense serve")
    launches["flash_attention"] = attention_phase(torch, dev, recs["K10"],
                                                  captured)
    del captured
    torch.cuda.empty_cache()
    lap("attention")
    cuda_vs_cpu_phase(torch, dev)
    lap("CUDA against CPU")

    # ---- 15. train --------------------------------------------------------- #
    backward_kernels_phase(torch, dev, recs)
    block_grads_phase(torch, dev)
    train_steps_phase(torch, dev, launches)
    fed_round_phase(torch, dev, launches)
    fed_round_phase(torch, dev, launches, "seamless-m4t-large-v2",
                    only=("quant r=8",))
    fed_round_phase(torch, dev, launches, "mixtral-8x7b",
                    only=("quant r=8",))
    lap("train")

    # ---- 16. multimodal serve ---------------------------------------------- #
    mm_serve_phase(torch, dev)
    lap("multimodal serve")

    # ---- 17. MoE ----------------------------------------------------------- #
    serve_phase(torch, dev, MOE_SERVE, depth=MOE_SERVE_LAYERS)
    lap("MoE serve")
    moe_cuda_vs_cpu_phase(torch, dev)
    lap("MoE CUDA against CPU")

    # kernel -> (the counter of its main-path entry, the tag of its runs)
    entries = {"topk_mask": (FUSED_K1_K2, "fused"),
               "quantize_pack_with_uniforms": (KEYED_K7, "keyed"),
               "unpack_codes": (VALUES_K9, "values"),
               "l2_norm": ("sum_squares", "sum of squares")}
    kernels = []
    for rec in recs.values():
        main_t = rec.timings["main"]
        by_run = launches.get(rec.name, {})
        if rec.name in entries:
            # K2 runs inside K1's launch on the main path (threshold_mask),
            # K7 as its keyed entry, K9 as its values entry; the other
            # entry serves a caller that has the threshold, u or wants
            # the codes.  K3's sum-of-squares entry is the model axis's
            # (model_mesh)
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
    print(f"[phases] all phases took {time.time() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
