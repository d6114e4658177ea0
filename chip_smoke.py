#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX and
nothing of the JAX package. Phases, each printing its own lines:

1. device — the card's name and power limit as nvidia-smi gives them.
2. build  — nvcc builds every kernel of the serving and training paths
   from ``src/repro_torch/kernels/csrc`` (seconds and ptxas' resource
   report).
3. kernel vs plain — ``paged_attention_ragged`` against its plain PyTorch
   version at the serving step's shapes (h2o-danube-1.8b attention: H=32,
   Hkv=8, D=80, fp32; pages of 128 and 16): (a) a mixed step of 4 prefill
   chunks and 60 decode rows, (b) 64 decode rows at context 2048, (c) step
   (a) with a 4096-token window and contexts past it. Max abs error ≤ 1e-4
   (fp32 sums over ≤ 8192 keys; online-softmax rescaling against a one-pass
   softmax). Times by CUDA events (median of 20 after warm-up, kernel,
   plain and library in turns); ``graph_ms`` times the kernel's device
   work alone (CUDA-graph replay; ``ms`` also counts the wrapper's host
   time before the first launch), and % of bound is taken against it;
   bound = max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s fp32) over what the
   step's data needs. The library yardstick is
   ``scaled_dot_product_attention``: one call over every decode row (keys
   padded, boolean mask) plus one call per prefill chunk. Also checks that
   K/V slots outside a sequence's visible range are never read (NaN there
   leaves the output bit-identical).
3b. batched kernel vs plain — ``paged_attention`` (B3) against
   ``paged_attention_ref``, same geometry and pages: (d) decode, 64
   sequences at Tq=1, contexts uniform in 128–4096; (e) verify, 16
   sequences at Tq=4 (γ=3), contexts 128–4096; (f) a sequential prefill
   chunk, 1 sequence at Tq=512 from a position ≤ 3584; (g) step (e) with a
   4096-token window and contexts up to 8192. Same gates, timing (with
   ``graph_ms``) and bound as phase 3; table columns past a context point
   at trash page 0. The library yardstick is one SDPA call over the padded
   batched view with a boolean mask.
3c. quantized kernel vs plain — ``paged_attention_ragged_quant`` (B2)
   against ``paged_attention_ragged_quant_ref`` on phase 3's steps (a), (b)
   and (c), pages of 128 and 16, with the pools quantized to int8 and to
   fp8-e4m3 (per-row f32 scales on scale pages at permuted ids). Gate:
   max abs error ≤ 1e-4 (both read the same dequantized values; only the
   fp32 summation order differs), and the error against the fp32 oracle
   on the unquantized K/V within the DESIGN.md §14 tolerance
   (tests/test_kernels.py::_quant_attention_tol). Poison: NaN in every
   scale slot a row may not read and 0x7F bytes (NaN in e4m3fn) in those
   value slots leave the output bit-identical. Timing as in phase 3; the
   bound counts 1 byte per K/V element plus 4 per row scale (q, output
   and tables f32 / int32); the library yardstick is phase 3's SDPA over
   the dequantized view, dequantized before timing. Then the split-KV
   decode tiles at their boundaries, pages of 128, both formats: 64
   decode rows at context (o) split - 1, (p) split and (q) split + 1 keys
   (``quant_plan``'s split of 512 for the 2048-key tables of step (b)),
   and (r) 64 rows at 2048 with a 300-key window, which starts inside a
   split. Every step also times B1 (``paged_attention_ragged``) on the
   step's fp32 pools in the same turns (``b1_ms``): the same work at 4
   bytes per element, on the same body's fp32 tiles. ``graph_ms`` and
   ``b1_graph_ms`` time each call's device work alone (CUDA-graph replay):
   a decode step's ~0.1 ms of host time before the first launch is in
   ``ms``, not in them.
3d. expert GEMM vs plain — ``moe_gmm`` (B4) against ``moe_gmm_ref`` and
   ``torch.bmm`` (fp32, TF32 off) at the capacity path's shapes, x and w
   ~ N(0, 0.3²): mixtral-8x7b (E=8, d=4096, f=14336) gate/up (K=4096,
   N=14336) and down (K=14336, N=4096) at the capacity of (h) a 64-token
   decode step (C=20), (i) a 512-token chunk (C=160) and (j) a 2048-token
   chunk (C=640); (k) kimi-k2's gate (E=384, C=4, K=7168, N=2048; w holds
   5.6e9 elements, 22.5 GB, freed before phase 4). Gate: max abs error
   < 2e-4·√K (tests/test_kernels.py) and a second launch bitwise equal;
   the error relative to max|plain| is reported. Timing as in phase 3;
   bound = max(bytes of x, w and the output / 3.35 TB/s, 2·E·C·K·N / 67
   TFLOP/s); ``graph_ms`` and ``library_graph_ms`` time B4's and bmm's
   device work alone (CUDA-graph replay). After phase 5d the same check
   runs at every capacity that phase's serving run launched B4 at (its
   decode and prefill buckets): the shapes of the main path.
3f. B4's backward vs plain — the ``MoeGmm`` Function's dx = dy · wᵀ and
   dw = xᵀ · dy (two more B4 calls, ``moe_gmm_backward``) against
   autograd through ``moe_gmm_ref``, at mixtral-8x7b's gate/up and down
   shapes at (s) C=8, (t) the capacity phase 6b trains at (C=640) and
   (u) C=960; x, w, dy ~ N(0, 0.3²). Gate: max abs error < 2e-4·√(the
   contraction: N for dx, C for dw), the same against fp64 on the first
   expert's first rows, a repeat bitwise equal. Timing as in 3d, of the
   pair with the transposes' copies; the library yardstick is two
   ``torch.bmm`` calls on the transposed views; bound = both GEMMs' bytes
   or 4·E·C·K·N FLOPs.
3e. SSD chunk scan vs plain — ``mamba_chunk_scan`` (B5) against
   ``mamba_chunk_scan_ref`` at mamba2-1.3b's heads (H=64, P=64, N=128),
   xdt, b, c ~ N(0, 0.3²), a = −|N(0, 1)|·0.1: (l) B=8 × 2048 tokens
   (NC=16 chunks of L=128) and (m) one 32768-token prompt (NC=256), the
   shapes of phase 5e; (n) a 100-token prompt at B=8 (L=100, a prompt
   shorter than the chunk); each from a zero initial state (as the
   model's prefill passes it) and from a state ~ N(0, 0.3²) (the TPU
   kernel has no initial state: an extension). Gate: max abs error ≤
   1e-4·max(1, max|plain|) on y and on the state (fp32 sums over ≤ 128
   steps and 128 state columns in another order), the same against fp64
   on the first sequence's first two heads, a second launch bitwise
   equal. Timing as in phase 3, no library time: no single PyTorch call
   computes the SSD scan; ``graph_ms`` is the call's device work alone
   (CUDA-graph replay), and an ``ssm_launches_ms`` line per step gives
   each of B5's four kernels' device ms a call (``torch.profiler`` over 5
   calls). An ``ssm_occupancy`` line first gives the blocks an SM the
   runtime grants each kernel (``mamba2_scan.occupancy``) and the warps
   that makes. Bound = max(bytes of xdt, a_dt, b, c, y and the
   states / 3.35 TB/s, FLOPs / 67 TFLOP/s), the FLOPs what the inputs
   need: CBᵀ on the L(L+1)/2 pairs j ≤ i once per batch and chunk (B and
   C are shared by the heads), per head and chunk the masked scores
   times X on the same pairs, the chunk's own state (L·N·P FMAs) and,
   where a nonzero state is carried in, C · state (L·N·P). Then (h) the
   same checks at zamba2-2.7b's heads (H=80, P=64, N=64), B=8 × 2048
   tokens: phase 5h's prefill shape.
3g. B5's backward vs plain — ``mamba_chunk_scan_backward`` (five more
   launches of B5's source, on the y and scratch a forward launch left)
   against ``mamba_chunk_scan_backward_ref`` in fp64 at 3e's (l) and (m)
   and 3e (h)'s shapes, 3e's inputs and dy ~ N(0, 1), a zero start and no
   final-state gradient (the training path's). Gate: every gradient
   (dxdt, da_dt, db, dc) within 1e-4 of its max |g|, a repeat bitwise
   equal. Timing as in 3e (``graph_ms``; ``ssm_backward_launches_ms``
   gives each of the five kernels' device ms); no library time: no
   single PyTorch call computes it. Bound = max(bytes of xdt, a_dt, b, c,
   dy and the four gradients / 3.35 TB/s, FLOPs / 67 TFLOP/s), the FLOPs
   dY Xᵀ and Mᵀ dY on the causal pairs and four L·N·P products per head
   and chunk, (Σ_h dG) C and (Σ_h dG) B on the causal pairs per chunk.
3h. bf16 kernels vs plain — every kernel on bf16 inputs, as its Pallas
   kernel takes them, at the main path's shapes (pages of 128): B1 at
   steps (a) and (b) (bf16 q and pools), B2 at (a) (int8 pools, bf16 q),
   B3 at (d) and (f), B4 at mixtral-8x7b's gate/up at C = 8 and 960 and
   its backward pair at C = 640, B5 at 3e (l) and 3e (h) and its backward
   at (l) (bf16 xdt, a_dt, b, c; the backward from a forward that wrote
   y in fp32, dy fp32). Each against its plain version's fp32 math on
   the same bf16 values. Gates: at most one bf16 rounding of the output,
   |Δ| ≤ 2⁻⁸·|plain| + 1e-4·max|plain| (B5's state, fp32: 1e-4 of
   max(1, max|plain|)); a repeat bitwise; poison unread (B1-B3). fp64 is
   reported for B4 (first expert's first rows) and B5. Timing as in 3;
   bound = max(bytes at 2 an element (B2's K/V 1 and its scales 4, B5's
   states and dY 4) / 3.35 TB/s, the products at 989 TFLOP/s, the bf16
   dense tensor rate); library: SDPA in bf16 (B1-B3), ``torch.bmm`` in
   bf16 (B4), none for B5.
4. serve parity — a 2-layer, full-width h2o-danube-1.8b with one set of
   random weights serves the same 6 requests on the card and on the CPU
   (plain path): greedy tokens equal, first-token logits within 1e-3.
4b. path parity — the same model and requests through ``mode="sequential"``
   (first-token logits within 1e-3), fused + ``commit_horizon=4``, and
   fused + ``speculate=2`` with a ``TruncatedSelfDraft(1)`` and with a
   1-layer ``SmallModelDraft``: tokens equal on card and CPU in each, and
   equal to the card's fused single-step tokens (the stream identity of
   DESIGN.md §12 and §18); ``execute_multi`` ran on the last three. On the
   card every committed horizon and speculative round runs under torch's
   sync debug mode set to raise: no device→host sync before its one copy.
4c. quantized parity — the same model and requests with ``kv_dtype="int8"``
   and ``"fp8_e4m3"``: fused tokens equal on card and CPU (first-token
   logits reported: an element within fp32 noise of a rounding boundary
   may quantize to the neighbouring step on one device); on the card the
   fused batched backend, ``mode="sequential"``, ``commit_horizon=4`` and
   γ=2 with a ``TruncatedSelfDraft(1)`` emit the card's fused single-step
   tokens of the same dtype (DESIGN.md §11/§12/§18 under §14), horizons
   under the sync check; B2 launches once per layer per attention pass,
   B1 and B3 never.
4d. MoE parity — mixtral-8x7b at full width, 1 layer (2 until 4n's
   multi-step and speculative cases needed the CPU runs' time), the port's
   own weights, phase 4's requests, the engine on the cost model's clock
   (``ModelTimedExecutor``), so that card and CPU make the same plans and
   so the same capacity drops: under both ``moe_impl="exact"`` and
   ``"capacity"`` card fused tokens = CPU fused tokens and first-token
   logits within 1e-3; on the card exact fused tokens = ``mode=
   "sequential"`` and ``commit_horizon=4`` tokens. B4 launches three times
   per layer and router chunk of every capacity forward pass and never
   under exact.
4e. SSM parity — mamba2-1.3b at full width with 2 layers, the port's own
   weights (seed 1), through ``DecoderLM.prefill`` (B=2 prompts of 300
   tokens: NC=3 with L=128, the last chunk padded) and 8 greedy
   ``decode_step``s on the card and on the CPU: tokens equal, first
   logits within 1e-3; B5 launched n_layers times in the prefill and
   never in decode, no other kernel.
4h. MoE speculation (ROADMAP A11) — mixtral-8x7b at every published
   width with 2 layers, the port's own weights (seed 1), 4 requests of
   8-64 prompt tokens and 8 new tokens on fixed plans (chunks of 16, then
   speculative dispatches of 2 rounds, γ=3, ``TruncatedSelfDraft(1)``),
   under ``moe_impl="exact"`` and ``"capacity"``, on the card and on the
   CPU. Gates: tokens and accept/draft counters equal on card and CPU;
   under exact the tokens equal the card's non-speculative run on the
   same plans (under capacity the verify pass packs B·(γ+1) rows, so the
   drops and the tokens may follow the packing: the share is reported);
   B3 launches 2 × (γ + n_layers) a speculative dispatch, B1 n_layers a
   fused step, B4 three per layer and router chunk of every forward pass
   under capacity and never under exact; every speculative dispatch runs
   under the sync check.
4i. DecoderLM families — each newly ported family at every published
   width, depth cut: zamba2-2.7b (6 layers: one shared-block application),
   gemma3-1b (6: five local layers, one global), pixtral-12b (1,
   ``embeds`` input), deepseek-67b (1), mixtral-8x7b (1, capacity and
   exact; these three 2 until 4n's multi-step and speculative cases needed
   the time) and stablelm-3b (2); one prompt of 1024 tokens (1536 for
   gemma3: past its 512-token window, into the banded path), the port's
   own weights (seed 1), ``DecoderLM.prefill`` plus 8 greedy
   ``decode_step``s on the card and on the CPU. Gates: first logits within
   1e-3, tokens equal, B5 once per Mamba2 block in the prefill and never
   in decode, B4 in prefill and decode under capacity only, no other
   kernel. Each record lists its depth cut under ``reduced``.
4f. prefix cache and preemption parity — phase 4's model at 1 layer (2
   until 4n's multi-step and speculative cases needed the CPU runs' time)
   and its weights serve the first 8 requests of
   ``make_scenario("shared-sysprompt", rps=8.0, duration=2.0, seed=0)``
   (tokens mod vocab, prompts cut at 640 tokens: the 512-token system
   prompt and up to 128 more, so the CPU's plain attention stays within
   seconds; 8 new tokens) through the fused executor with a 512-page
   ``PrefixCache`` attached (pages of 16), the engine on the cost model's
   clock so that card and CPU make the same plans, in fp32 and int8.
   Gates: card tokens = CPU tokens, first-token logits within 1e-3 in fp32
   (reported in int8, as in 4c), cached tokens > 0 and equal on card and
   CPU, a capacity-0 cache gives the no-cache tokens, the allocator's and
   the radix tree's invariants hold and no
   page leaks, B1 (fp32) or B2 (int8) launches n_layers per dispatch. Then
   tests/test_preemption.py's shared-prefix pair (a 64-token prefix, pages
   of 16): the victim forked onto the survivor's cached pages is evicted
   mid-decode (``Engine._preempt``) and recomputes its tail; at least one
   preemption, the survivor's table untouched and its stream equal to the
   run without preemption.
4g. migration parity — the same model and weights, two executors on the
   card sharing them, fixed plans (a teacher-forced chunk driver): four
   requests move to the second executor at decode counts 1, 3, 5 and 2,
   three by KV (``capture_kv`` → release → ``install_kv_pages``) and one
   by recompute; then two requests behind a shared 32-token prefix move
   into a destination whose cache holds the first one's prompt, their
   leading blocks by reference; fp32 and int8 (scale ids permuted on both
   sides). Gates: every stream equals the single-executor run's, every
   installed page and scale page equals the captured payload byte for
   byte, the referenced pages are the expected ones and the wire carries
   only the other pages (0 bytes for the leading blocks).
5. serve — the full 24-layer h2o-danube-1.8b (fp32 weights from a seed)
   serves 16 requests through ``Engine`` + the ``fairbatching`` scheduler +
   the fused ``PagedTransformerExecutor``; every request must finish with
   32 tokens in [0, vocab) and the attention kernel must have launched
   exactly n_layers times per dispatch.
5b. serving paths — the same model: (i) ``mode="sequential"`` on phase 5's
   requests; (ii) decode-16: 16 requests at time 0, prompts 256–3072, 64 new
   tokens, fused + ``commit_horizon=8``; (iii) decode-16 with
   ``speculate=3``, ``TruncatedSelfDraft(6)`` and ``commit_horizon=4``.
   Every request finishes with its tokens in [0, vocab); (ii) and (iii)
   ran multi-step / speculative dispatches; the batched kernel launched
   n_layers per sequential dispatch, n_layers × horizon per multi-step
   dispatch and rounds × (γ × draft layers + n_layers) per speculative
   one, the ragged kernel n_layers per fused dispatch. The share of tokens
   equal to a fused single-step run of the same requests is reported, not
   gated (at 24 random-weight layers a near-tie may flip a token).
5c. quantized serving — the same model: serve-16 with ``kv_dtype="int8"``
   and with ``"fp8_e4m3"``, and decode-16 with int8 and
   ``commit_horizon=8``. Every request finishes with its tokens in
   [0, vocab); B2 launched n_layers per fused dispatch and n_layers ×
   horizon per multi-step dispatch, B1 and B3 never. Reports the pools'
   bytes and the share of tokens equal to the fp32 run (not gated).
5d. MoE serving — phase 5's serve-16 requests on mixtral-8x7b at every
   published width with 8 of its 32 layers (47.5 GB of fp32 weights,
   seed 0), ``moe_impl="capacity"``, fused, fp32 KV, 512 pages of 128.
   Every request finishes with 32 tokens in [0, vocab); B4 launched what
   the forward passes imply, B1 n_layers per dispatch. Reports the
   serving numbers (host step medians; device time by kernel class is
   ``tools/profile_torch_serve.py --arch mixtral-8x7b --layers 8``'s) and
   B4's launches by capacity, at which phase 3d's check then runs.
5f. prefix-cached serving — the full-depth model of phase 5 serves the
   first 64 requests by arrival of ``make_scenario("shared-sysprompt",
   rps=8.0, duration=8.0, seed=3)`` (prompts cut at 3072 tokens, 32 new
   tokens, arriving as traced; 1024 pages of 128, 32 a sequence) with no
   cache and with a 512-page ``PrefixCache``; then with the cache and
   ``preemption=True`` on a pool cut to 168 pages, the engine on the cost
   model's clock there so that its preemptions do not depend on the
   device. Gates: every request finishes with 32 tokens in [0, vocab), B1
   launches n_layers per fused dispatch, the invariants hold, cached
   tokens > 0, preemptions > 0 in the third run. Reports the hit rate,
   cached tokens, TTFT and TPOT p50/p99, output tokens/s, peak memory and
   the share of tokens equal to the uncached run.
5g. KV migration at full depth — phase 5's 16 prompts (256–3072 tokens,
   32 new tokens) run on a source executor for their prefill and 4 decode
   steps (5 tokens), then move by KV to a second executor on the card
   (the same weights, 512 pages of 128 each), which runs the other 27
   steps; fp32 and int8, fixed plans (chunks of 512). Gates: the installed
   pages equal the payload byte for byte, every request finishes. Reports
   per move (``migrate_serve_move``) the capture and install ms (each
   between two synchronizations), bytes and GB/s each way, and the share
   of tokens equal to a never-migrated run on the same plans.
4j. training parity — ``DecoderLM.train_loss`` and its gradients on the
   card and on the CPU: h2o-danube-1.8b at full width with 1 layer (2
   until 4n's multi-step and speculative cases needed the time) (one
   256-token sequence) under ``attn_impl="dense"`` and ``"flash"``
   (``flash_block=64``: the flash Function's backward), and mixtral-8x7b
   at full width with 1 layer (128 tokens) under ``capacity``; the port's
   own weights (seed 1). Gates: loss within 1e-5 relative, every gradient
   leaf within 1e-4 of its max |g| and nonzero wherever the CPU's is (a
   kernel output without a backward would leave zeros), one AdamW step
   from the CPU's gradients gives params within 1e-6 on both devices, B4
   launched 12 times per layer and router chunk (3 forward, 3 recomputed
   under remat, 6 backward), no other kernel.
4l. SSM and hybrid training parity — 4j's comparison for mamba2-1.3b at
   full width with 1 layer (2 until 4n's multi-step and speculative cases
   needed the time) and zamba2-2.7b at full width with 7 (one application
   of the shared attention block after 6 Mamba2 blocks, then a remainder
   block), one 256-token sequence each (2 chunks). 4j's gates; B5 launched
   twice per Mamba2 block (forward, recomputed under remat) and its
   backward once, no other kernel.
4k. encoder-decoder parity — seamless-m4t-large-v2 at full width (d 1024,
   vocab 256206) with 1 encoder and 1 decoder layer (2 and 2 until 4n's
   multi-step and speculative cases needed the time), the port's own
   weights (seed 1): ``EncDecLM.prefill`` of 2 × 256 frames and 4 decoder
   tokens plus 8 greedy steps, and ``train_loss`` of 2 × (256 frames, 64
   tokens), card and CPU. Gates: first logits within 1e-3, tokens equal,
   4j's gradient gates, no kernel launched.
3i. kernels at the per-shard shapes of the sharded data plane — B3 on
   step (d), B1 on steps (a) and (b) and B2 in int8 on step (a), pages of
   128, at h2o-danube-1.8b's heads a rank at TP 2 (H 16, Hkv 4) and TP 4
   (H 8, Hkv 2), with phase 3b's, 3's and 3c's gates, timing and bound
   (lines ``shard_kernel_step``); after 5d, B4 at mixtral-8x7b's experts
   a rank at TP 2 (E 4), gate/up and down, at C = 8 and at the largest
   capacity 5d launched, with 3d's gates (``moe_kernel_step`` ``ep2_*``).
4n. TP parity — ``launch.mesh.spawn`` starts the ranks of a 1 × TP mesh,
   one process each, all on this card (gloo, which all-reduces and
   broadcasts CUDA tensors through the host: NCCL refuses two ranks on
   one device), and each serves through the sharded executor
   (``mesh=``): rank 0 runs the engine, the others replay its
   dispatches. On the model clock (``MODEL_CLOCK``), phase 4's requests:
   h2o-danube-1.8b at full width, 2 layers, TP 2 and 4, fp32 and int8 KV
   — tokens equal the single-device sequential card run, plans, deferrals
   and VTC counters byte-equal to it (TP 1) at per-shard budgets
   (``cost_shards`` = TP); mixtral-8x7b at full width, 2 layers, TP 2 —
   ``exact`` tokens equal single-device sequential, ``capacity`` tokens
   the single-device fused ``capacity`` run (same plans); h2o-danube-1.8b
   at 2 layers, TP 2, ``mode="sequential"`` — tokens, decisions and VTC
   counters equal the single-device sequential run. Every case: every
   rank 2·L + 2 all-reduces and L B1 (B2 in int8; B3 in sequential)
   launches a dispatch, B4 on every rank under capacity; dispatches =
   engine steps in fused mode (one a chunk and one a decode batch in
   sequential). Committed multi-step and speculative decode under the
   mesh: h2o-danube-1.8b at 2 layers with ``commit_horizon=4`` (TP 2 fp32
   and int8, TP 4 fp32) and with a ``TruncatedSelfDraft(1)`` at γ 2 over
   horizons of 2 rounds (TP 2) — tokens equal the single-device card run
   of the same settings and draft, whose plans, deferrals, VTC and
   speculative counters they equal too; from each rank's dispatch log,
   every rank ran rank 0's dispatches, each with 2·layers + 2
   all-reduces a forward pass (``reduces_per_dispatch`` agreeing) and one
   attention launch a layer of each pass (B1 in a fused step, B3 in each
   multi-step iteration, draft pass and verify pass, B2 for both in
   int8), the case's path ran, and no page leaked on any rank. Then
   TP 1 on NCCL: every dispatch's logits bitwise equal to ``mesh=None``'s
   (lines ``tp_parity``).
4m. bf16 parity — h2o-danube-1.8b 1 layer, mixtral-8x7b 1, mamba2-1.3b 1
   (h2o and mamba2 2 until 4n's multi-step and speculative cases needed
   the time), zamba2-2.7b 7, at full width, the port's own weights (seed
   1). Served at the JAX launch cells' serving opts (bf16 params, compute
   and cache, flash prefill): 2 prompts of 256 tokens (mixtral 64, 128
   before 4n's multi-step and speculative cases) and 4 decode steps on the
   CPU, the card fed the CPU's tokens; logits within 2e-2·max|logit| at
   every step, the card's greedy token the CPU's wherever the CPU's top-2
   margin is wider than that, B5 once per Mamba2 block in the prefill and
   never in decode, B4 in both on mixtral, no other kernel. Trained at the
   launch training opts (fp32 params, bf16 compute and cache, flash,
   capacity, remat, ce_chunk 2048), one sequence of the same length: loss
   within 1e-3 relative; each gradient leaf within 2e-2 + 1.5 × the leaf's
   own bf16 noise (the card's bf16 against its fp32 compute) of its fp32
   max, none lost; B4 and B5 launched as in 4j and 4l.
5e. SSM serving — mamba2-1.3b at full depth (48 layers, 5.8 GB of fp32
   weights, seed 0) through ``DecoderLM.prefill`` plus greedy
   ``decode_step``s, each step ending on its tokens' copy to the host:
   (i) B=8 prompts of 2048 tokens, then 64 steps; (ii) one prompt of
   32768, then 16 steps. Every token in [0, vocab); B5 launched n_layers
   times per prefill, at a shape phase 3e checked, and never in decode.
   Reports the prefill's seconds and tokens/s, the decode step's median
   host ms, output tokens/s, peak memory, B5's launches and shape.
5h. hybrid serving — zamba2-2.7b at full depth and width (54 Mamba2
   blocks, 9 applications of the shared attention block; 9.7 GB of fp32
   weights, seed 0) through ``DecoderLM.prefill`` plus greedy
   ``decode_step``s: B=8 prompts of 2048 tokens, then 64 steps. Gates:
   every token in [0, vocab); B5 launched 54 times per prefill at the
   shape phase 3e (h) checked and never in decode; each shared block's
   ring holds positions 0..S+steps-1. Reports 5e's numbers plus one more
   prefill's device ms by ``torch.profiler`` and B5's share of them.
5i. local:global serving — gemma3-1b at full depth and width (26 layers,
   5.2 GB of fp32 weights, seed 0), 5h's workload. Gates: every token in
   [0, vocab); each local layer's ring holds exactly the last 512
   positions, each global layer's all of them. Reports 5h's numbers.
5j. encoder-decoder serving — seamless-m4t-large-v2 at full depth and
   width (24 + 24 layers, 2.04 B params, 8.2 GB of fp32, seed 0): 8 × 2048
   encoder frames and 4 decoder tokens through ``EncDecLM.prefill``, then
   64 greedy steps. Gates: finite logits, every token in [0, vocab), no
   kernel launched. Reports the prefill's seconds, the decode step's
   median host ms, output tokens/s and peak memory.
5k. bf16 serving — ``DecoderLM`` at the launch serving opts, 5e's gates
   and numbers (with B4's and B5's share of one more prefill's device
   ms): (i) mixtral-8x7b at every published width with 16 of 32 layers
   (46.4 GB of bf16 weights, the memory 5d's 8 fp32 layers take), 4
   prompts of 2048 tokens then 32 greedy steps; (ii) mamba2-1.3b at full
   depth on 5e (i)'s workload (8 × 2048, then 64 steps).
5l. timed TP serve — h2o-danube-1.8b at full width with 4 of its 24 layers
   (cut for the script's time: gloo's host round trips were 85 % of the
   full model's wall; 6 until 4n's multi-step and speculative cases needed
   the time), TP 2 (two processes on this card, gloo), serve-16's traffic
   on the wall clock: phase 5's gates and numbers, with the collectives'
   ms a step (device synchronised either side of each all-reduce and
   broadcast on rank 0; for information: through the host on gloo, not TP
   over NVLink; line ``tp_serve``). Run in the same spawn as 4n's TP 2
   cases.
6a-6c. training — ``make_train_step`` from the port's own weights (seed 0)
   over one fixed batch (seed 11): 6a h2o-danube-1.8b at full width with 3
   of its 24 layers (6 until 4n's multi-step and speculative cases needed
   the time), AdamW, 4 × 1024 tokens, 8 steps; 6b mixtral-8x7b at full
   width with 2 layers, Adafactor, ``capacity``, 2 × 1024 tokens, 5 steps;
   6c seamless-m4t-large-v2 at full width with 12 + 12 of its 24 + 24
   layers, AdamW, 4 × (1024 frames, 256 decoder tokens), 5 steps (6a's and
   6c's depth halved to keep the script's time once 3h-6f came). 6a saves
   a checkpoint after step 3 (``save_checkpoint`` under build/ckpt), loads
   it onto the card and runs the remaining steps again; 6b and 6c repeat
   one loss-and-gradient pass instead, as 6d does (their checkpoint I/O
   went for 3i-5l's time: 6a covers it, and it does not depend on the
   family). Gates: losses finite and the last below the first; every
   step's gradient norm finite (so every gradient leaf is); 6a's resumed
   run's params within 1e-6 of the uninterrupted run's and its losses
   within 1e-6 relative, 6b's and 6c's repeated pass bitwise; B4 launched
   12 times per layer and router chunk a step under capacity, no other
   kernel. Reports s/step (median after the first step), tokens/s, model
   TFLOP/s (6·N·tokens a step; N the active params, the encoder's and the
   decoder's apart for 6c), peak memory, losses, 6a's checkpoint's bytes
   and save/load seconds; 6b also one profiled step's device ms and B4's
   part of it.
6d-6e. SSM and hybrid training — 6a's loop, AdamW, 5 steps: 6d
   mamba2-1.3b at full depth and width (48 Mamba2 blocks), 4 × 2048
   tokens; 6e zamba2-2.7b at full depth and width (54 blocks, 9
   applications of the shared attention block), 4 × 1024 tokens. No
   checkpoint (6a covers its I/O): after the steps one loss-and-gradient
   pass runs twice and
   must repeat bit for bit. B5 launched twice per block a step and its
   backward once, no other kernel. Reports 6a's numbers and one profiled
   step's device ms with B5's forward and backward parts.
6f. bf16 training — 6d's loop and gates at the launch training opts (fp32
   params, bf16 compute and cache, flash, capacity, remat, ce_chunk
   2048): (i) h2o-danube-1.8b at full depth on 6a's batch (4 × 1024,
   AdamW, 5 steps); (ii) mamba2-1.3b at full depth on 6d's (4 × 2048; B5
   on bf16 b and c, forward and backward).

7a. launch cells — ``launch.steps.build_cell`` on a 1 × 1 abstract mesh at
   the JAX launch opts and full width, each cell's own weights from seed
   0: (i) mamba2-1.3b ``train_4k`` (AdamW, remat, ce_chunk 2048) at B 4
   × 4096 (of 256), (ii) mamba2-1.3b ``prefill_32k`` at B 1 (of 32),
   (iii) mamba2-1.3b ``decode_32k`` at B 128, (iv) h2o-danube-1.8b
   ``decode_32k`` at B 128 (its 4096-wide ring: 32.2 GB of bf16 K/V),
   (v) mixtral-8x7b ``decode_32k`` with 16 of 32 layers at B 64 (of
   128: 46.4 GB of bf16 weights and 17.2 GB of K/V); decode cells from a
   full cache, as after a 32 767-token prefill. Each is dry-run first
   (``launch.dryrun.measure`` on ``meta`` tensors, on the host), then
   materialised on the card and stepped twice, under
   ``launch.cost_analysis.analyze`` and then timed (CUDA events) with the
   allocator's peak reset. Gates: argument and output bytes equal the
   dry run's exactly, the card's counted FLOPs the abstract run's, the
   peak (above what was allocated before) within ±10 % of the dry run's
   ``per_device_hbm_bytes``, loss, gradient norm and logits finite, B4
   and B5 launched as the passes imply in both steps (``cell_launches``).
   Reports step ms, TFLOP/s (counted FLOPs over it) and their share of
   989 TFLOP/s, beside the card (lines ``launch_cell``).

Lines before the last: one ``{"kernels": [...]}`` JSON object (B1, B3,
B2, B4, B5, B5's backward; launches summed over every serving and
training phase on the card: 4, 4b, 4c, 4d, 4h, 4e, 4i, 4j, 4l, 4f, 4g,
4n and 5l (every rank's), 5, 5b, 5c, 5f, 5g, 5d, 5e, 5h, 6b, 6d, 6e, 7a
(7a's also alone as B4's, B5's and its backward's
``launch_cell_launches``) (B1
and B2 launch in 4f, 4g,
5f and 5g; B3 and B4 in 4h, B4 and B5 in 4i, B4 in 4j and 6b, B5 and its
backward in 4l, 6d and 6e; 4m, 5k and 6f are also summed alone as B4's,
B5's and its backward's ``bf16_launches``); each kernel's 3h times as
``bf16_*`` (B1 (b) as ``bf16_decode_*``, B3 (f) as ``bf16_chunk_*``, B4
C=960 as ``bf16_prefill_*`` and its backward as ``bf16_backward_*``, B5
(h) as ``bf16_hybrid_*``); B1's, B2's and B4's 3i steps as
``per_shard``, and B3's 3i steps likewise; B1's
times at step (a), pages of 128,
with step (b)'s as ``decode_*``; B3's at step (d), pages of 128, with
step (f)'s, SDPA's beside, as ``chunk_*``; B2's at step (a), int8, pages
of 128, with B1's time from the same call (``b1_ms``) and step (b)'s as
``decode_*``; B4's at the gate/up shape of the capacity 5d launched it at
most, with the gate/up shape of the largest capacity 5d launched as
``prefill_*`` and 3f (u)'s backward pair as ``backward_*``; ``*graph_ms`` are device times alone, by CUDA-graph
replay; B5's at 5e (i)'s shape from a zero state, with 5e (ii)'s as
``long_*`` and 3e (h)'s, 5h's prefill shape, as ``hybrid_*``; B5's
backward's at 3g (l), with (m) as ``long_*`` and (h) as ``hybrid_*``),
and the card's name and power limit.
The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises: the exit code is then non-zero and no result prints.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tools"))

from compare_mamba2_scan import device_ms_by_kernel  # noqa: E402
from repro_torch.cache import PrefixCache  # noqa: E402
from repro_torch.configs import SHAPES, get  # noqa: E402
from repro_torch.core import (BatchItem, BatchPlan,  # noqa: E402
                              LinearCostModel, TaskKind, make_scheduler)
from repro_torch.data.traces import make_scenario  # noqa: E402
from repro_torch.disagg.migration import (  # noqa: E402
    capture_kv, install_kv_pages)
from repro_torch.engine import (Engine, EngineConfig,  # noqa: E402
                                PagedTransformerExecutor, Request,
                                RequestState)
from repro_torch.engine.metrics import summarize  # noqa: E402
from repro_torch.engine.numerics import (  # noqa: E402
    ModelTimedExecutor, ModelTimedMultiExecutor, assert_same_decisions,
    capture_schedule, vtc_counters)
from repro_torch.engine.spec_decode import (  # noqa: E402
    SmallModelDraft, TruncatedSelfDraft)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bounds import (  # noqa: E402
    BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, HBM_BYTES_PER_S, gmm_backward_bound,
    gmm_bound, scan_backward_bound, scan_bound)
from repro_torch.kernels import mamba2_scan  # noqa: E402
from repro_torch.kernels.mamba2_scan import (  # noqa: E402
    mamba_chunk_scan, mamba_chunk_scan_backward)
from repro_torch.kernels.moe_gmm import (MoeGmm, moe_gmm,  # noqa: E402
                                         moe_gmm_backward)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_ragged, paged_attention_ragged_quant)
from repro_torch.kernels.quant import (  # noqa: E402
    dequantize_kv, kv_quant_spec, quantize_kv, raw_pool)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost_analysis import (  # noqa: E402
    analyze, model_flops, param_counts, tree_bytes)
from repro_torch.launch.mesh import Mesh, make_test_mesh, spawn  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    mamba_chunk_scan_backward_ref, mamba_chunk_scan_ref, moe_gmm_ref,
    paged_attention_ragged_quant_ref, paged_attention_ragged_ref,
    paged_attention_ref)
from repro_torch.models.encdec import EncDecLM  # noqa: E402
from repro_torch.models.lm import (DecoderLM, ModelOpts,  # noqa: E402
                                   build_model)
from repro_torch.models.moe import (  # noqa: E402
    _capacity, chunk_capacity, router_chunks)
from repro_torch.models.weights import init_params, params_to  # noqa: E402
from repro_torch.training import (OptConfig, apply_updates,  # noqa: E402
                                  init_opt_state, load_checkpoint,
                                  make_train_step, save_checkpoint)
from repro_torch.training.optimizer import leaves  # noqa: E402
from repro_torch.training.train_step import value_and_grad  # noqa: E402

ATOL_KERNEL = 1e-4
ATOL_LOGITS = 1e-3
N_TIMED, N_WARMUP = 20, 3
H, HKV, D = 32, 8, 80            # h2o-danube-1.8b attention geometry


_T0 = time.perf_counter()


def _emit(tag: str, obj) -> None:
    """One phase line: ``tag`` and ``obj`` as JSON, a record stamped with
    the seconds since the script started (``elapsed_s``)."""
    if isinstance(obj, dict):
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(f"{tag} {json.dumps(obj)}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Step:
    """One ragged attention step: the layout and its device tensors."""
    name: str
    q_lens: list
    pos0: list
    ctx: list
    window: object
    page: int
    args: tuple = ()

    def visible(self, s: int) -> tuple[int, int]:
        """[lo, hi): the keys any row of sequence s can see."""
        last = self.pos0[s] + self.q_lens[s] - 1
        hi = min(self.ctx[s], last + 1)
        lo = 0 if self.window is None else max(0, self.pos0[s] - self.window + 1)
        return lo, hi


# phase 3c's split-boundary steps: 64 decode rows at this context and
# window over step (b)'s 2048-key tables (quant_plan: splits of 512)
SPLIT_STEPS = {"o_ctx511": (511, None), "p_ctx512": (512, None),
               "q_ctx513": (513, None), "r_window300": (2048, 300)}


def _layout(kind: str, rng: np.random.Generator):
    """(q_lens, pos0, ctx, window, max_ctx) of step a, b, c or one of
    ``SPLIT_STEPS``."""
    if kind == "b_decode":
        return [1] * 64, [2047] * 64, [2048] * 64, None, 2048
    if kind in SPLIT_STEPS:
        c, window = SPLIT_STEPS[kind]
        return [1] * 64, [c - 1] * 64, [c] * 64, window, 2048
    window, max_ctx = (None, 4096) if kind == "a_mixed" else (4096, 8192)
    q_lens, pos0, ctx = [], [], []
    for _ in range(4):                     # prefill chunks
        n = int(rng.integers(256, 513))
        p = int(rng.integers(0, min(max_ctx - 512, 3584 * max_ctx // 4096) + 1))
        q_lens.append(n)
        pos0.append(p)
        ctx.append(p + n)
    for _ in range(60):                    # decode rows
        c = int(rng.integers(128, max_ctx + 1))
        q_lens.append(1)
        pos0.append(c - 1)
        ctx.append(c)
    return q_lens, pos0, ctx, window, max_ctx


def make_step(kind: str, page: int, device, seed: int = 0) -> Step:
    rng = np.random.default_rng(seed)
    q_lens, pos0, ctx, window, max_ctx = _layout(kind, rng)
    s = len(q_lens)
    n_pages = -(-max_ctx // page)
    n_rows = sum(q_lens)
    t = n_rows + 5                         # stream padding rows stay zero
    q_starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    # distinct pages per sequence, in shuffled order; page 0 is trash
    pages = 1 + rng.permutation(s * n_pages).astype(np.int32)
    tables = pages.reshape(s, n_pages)
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    pool_shape = (s * n_pages + 1, page, HKV, D)
    dev = torch.device(device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    args = (randn(t, H, D), randn(*pool_shape), randn(*pool_shape),
            i32(tables), i32(ctx), i32(q_starts), i32(q_lens), i32(pos0))
    return Step(kind, q_lens, pos0, ctx, window, page, args)


def step_bound(st: Step, kv_bytes: int = 4, scale_bytes: int = 0,
               q_bytes: int = 4, flops_per_s: float = FP32_FLOPS_PER_S
               ) -> dict:
    """Least time for the work this step's data needs: each input byte read
    once, each output byte written once; FLOPs of QK and PV over the keys
    each row sees, at ``flops_per_s``. ``kv_bytes`` per K/V element,
    ``scale_bytes`` per (key, KV head) row scale and ``q_bytes`` per q and
    output element; a quantized step also reads a scale-table entry per
    page."""
    q = st.args[0]
    t = q.shape[0]
    g = H // HKV
    keys = flops = 0
    for s in range(len(st.q_lens)):
        lo, hi = st.visible(s)
        keys += max(hi - lo, 0)
        for r in range(st.q_lens[s]):
            qp = st.pos0[s] + r
            k_hi = min(st.ctx[s], qp + 1)
            k_lo = 0 if st.window is None else max(0, qp - st.window + 1)
            flops += max(k_hi - k_lo, 0) * HKV * g * D * 4
    n_rows = sum(st.q_lens)
    pages_read = sum(-(-(hi) // st.page) - lo // st.page
                     for lo, hi in map(st.visible, range(len(st.q_lens))))
    tables = 2 if scale_bytes else 1
    nbytes = (n_rows * H * D * q_bytes            # q rows owned
              + keys * HKV * (D * kv_bytes + scale_bytes) * 2  # K, V rows
              + pages_read * 4 * tables + len(st.q_lens) * 4 * 4
              + t * H * D * q_bytes)              # output, padding included
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def library_call(st: Step):
    """The SDPA yardstick: returns (fn, check) where ``fn()`` runs one SDPA
    call over all decode rows (keys padded, boolean mask) and one per
    prefill chunk, and ``check(outs)`` gives its max abs error against the
    plain version on the rows it covers. Gathering is set-up, not timed."""
    import torch.nn.functional as F
    q, kp, vp, tables = st.args[:4]
    page, g = st.page, H // HKV
    dev = q.device
    starts = np.concatenate([[0], np.cumsum(st.q_lens)[:-1]])

    def gathered(s, lo, hi):
        idx = torch.arange(lo, hi, device=dev)
        pg = tables[s].long()[idx // page]
        k = kp[pg, idx % page]                      # (L, Hkv, D)
        v = vp[pg, idx % page]
        return (k.repeat_interleave(g, 1).transpose(0, 1).to(q.dtype),
                v.repeat_interleave(g, 1).transpose(0, 1).to(q.dtype))

    calls = []
    dec = [s for s in range(len(st.q_lens)) if st.q_lens[s] == 1]
    pre = [s for s in range(len(st.q_lens)) if st.q_lens[s] > 1]
    if dec:
        spans = [st.visible(s) for s in dec]
        width = max(hi - lo for lo, hi in spans)
        kb = torch.zeros(len(dec), H, width, D, device=dev, dtype=q.dtype)
        vb = torch.zeros_like(kb)
        mask = torch.zeros(len(dec), 1, 1, width, dtype=torch.bool, device=dev)
        for i, (s, (lo, hi)) in enumerate(zip(dec, spans)):
            kb[i, :, :hi - lo], vb[i, :, :hi - lo] = gathered(s, lo, hi)
            mask[i, 0, 0, :hi - lo] = True
        rows = torch.as_tensor(starts[dec], device=dev)
        qb = q[rows].unsqueeze(2)                    # (n, H, 1, D)
        calls.append(("decode", rows, qb, kb, vb, mask))
    for s in pre:
        lo, hi = st.visible(s)
        k, v = gathered(s, lo, hi)
        rows = torch.arange(starts[s], starts[s] + st.q_lens[s], device=dev)
        qp = st.pos0[s] + torch.arange(st.q_lens[s], device=dev)[:, None]
        kv = torch.arange(lo, hi, device=dev)[None]
        m = kv <= qp
        if st.window is not None:
            m &= (qp - kv) < st.window
        calls.append(("chunk", rows, q[rows].transpose(0, 1)[None], k[None],
                      v[None], m[None, None]))

    def fn():
        return [F.scaled_dot_product_attention(qb, kb, vb, attn_mask=m)
                for _, _, qb, kb, vb, m in calls]

    def check(outs, expect):
        err = 0.0
        for (kind, rows, *_), o in zip(calls, outs):
            got = o[:, :, 0] if kind == "decode" else o[0].transpose(0, 1)
            err = max(err, float((got - expect[rows]).abs().max()))
        return err

    return fn, check


def cuda_timer(fn) -> float:
    """Milliseconds of one call, by CUDA events on the current stream."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def graph_timer(fn, reps: int = 5, windows: int = 3) -> float:
    """Milliseconds of one call's device work alone: the call captured in a
    CUDA graph and replayed ``reps`` times between two events, the median
    of ``windows`` (``cuda_timer`` of one call from an idle card also
    counts the host's time to the first launch)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                  # warm up off the capture stream, as CUDA wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = [cuda_timer(lambda: [graph.replay() for _ in range(reps)]) / reps
             for _ in range(windows)]
    del graph
    return statistics.median(times)


def time_in_turns(timer, kern, plain, library, **others) -> dict:
    """Median ms of the kernel, its plain version and the library call,
    timed in turns, over N_TIMED rounds after N_WARMUP. ``library`` None:
    no single PyTorch call computes the function, ``library_ms`` is None.
    ``others`` (name: function) are timed in the same turns."""
    fns = {"ms": kern, "plain_ms": plain, "library_ms": library, **others}
    ts = {k: [] for k, fn in fns.items() if fn is not None}
    for i in range(N_WARMUP + N_TIMED):
        for key in ts:
            dt = timer(fns[key])
            if i >= N_WARMUP:
                ts[key].append(dt)
    return {"library_ms": None,
            **{k: statistics.median(v) for k, v in ts.items()}}


def poisoned(st):
    """Copies of the pools of ``st`` (a ``Step`` or ``BStep``) with NaN in
    every slot no row of its sequence may read: before the window's first
    key and at or past the context — trash page 0 included, where a batched
    step's table columns past each context point."""
    kp, vp, tables = st.args[1].clone(), st.args[2].clone(), st.args[3]
    kv = torch.arange(tables.shape[1] * st.page, device=kp.device)
    for s in range(len(st.ctx)):
        lo, _ = st.visible(s)
        bad = (kv < lo) | (kv >= st.ctx[s])
        pg = tables[s].long()[kv[bad] // st.page]
        kp[pg, kv[bad] % st.page] = float("nan")
        vp[pg, kv[bad] % st.page] = float("nan")
    return kp, vp


def check_kernel(st: Step, timer, timed: bool) -> dict:
    """Kernel vs plain version on ``st``; times all three when ``timed``."""
    q, kp, vp, *meta = st.args
    kern = lambda: paged_attention_ragged(q, kp, vp, *meta, window=st.window)
    plain = lambda: paged_attention_ragged_ref(q, kp, vp, *meta,
                                               window=st.window)
    got, want = kern(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{st.name}/page {st.page}: non-finite output")
    err = float((got - want).abs().max())
    pad = float(got[sum(st.q_lens):].abs().max()) if got.shape[0] > sum(
        st.q_lens) else 0.0
    kp2, vp2 = poisoned(st)
    same = torch.equal(
        paged_attention_ragged(q, kp2, vp2, *meta, window=st.window), got)
    del kp2, vp2
    lib_fn, lib_check = library_call(st)
    lib_err = lib_check(lib_fn(), want)
    rec = {"step": st.name, "page": st.page, "rows": sum(st.q_lens),
           "seqs": len(st.q_lens), "window": st.window,
           "max_abs_err": err, "pad_rows_max": pad, "poison_ok": same,
           "library_max_abs_err": lib_err, **step_bound(st)}
    if err > ATOL_KERNEL or pad != 0.0 or not same:
        _emit("kernel_step", rec)
        raise AssertionError(f"{st.name}/page {st.page}: kernel disagrees "
                             f"with its plain version")
    if timed:
        rec.update(time_in_turns(timer, kern, plain, lib_fn))
        if q.is_cuda:
            rec["graph_ms"] = graph_timer(kern)
    return rec


def phase_kernels(device, timer) -> list:
    recs = []
    for kind in ("a_mixed", "b_decode", "c_window"):
        for page in (128, 16):
            st = make_step(kind, page, device)
            recs.append(check_kernel(st, timer, timed=True))
            _emit("kernel_step", recs[-1])
            del st
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 3b: the batched kernel (B3) against its plain version
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BStep:
    """One batched attention call: the layout and its device tensors."""
    name: str
    tq: int
    q_starts: list
    ctx: list
    window: object
    page: int
    args: tuple = ()

    def visible(self, b: int) -> tuple[int, int]:
        """[lo, hi): the keys any row of sequence b can see."""
        hi = min(self.ctx[b], self.q_starts[b] + self.tq)
        lo = 0 if self.window is None else max(
            0, self.q_starts[b] - self.window + 1)
        return lo, hi


def _blayout(kind: str, rng: np.random.Generator):
    """(batch, Tq, q_starts, ctx, window, max_ctx) of step d, e, f or g."""
    if kind == "f_chunk":
        q0 = int(rng.integers(0, 3584 + 1))
        return 1, 512, [q0], [q0 + 512], None, 4096
    b, tq, window, max_ctx = {"d_decode": (64, 1, None, 4096),
                              "e_verify": (16, 4, None, 4096),
                              "g_window": (16, 4, 4096, 8192)}[kind]
    ctx = [int(c) for c in rng.integers(128, max_ctx + 1, b)]
    return b, tq, [c - tq for c in ctx], ctx, window, max_ctx


def make_bstep(kind: str, page: int, device, seed: int = 0) -> BStep:
    rng = np.random.default_rng(seed)
    b, tq, q_starts, ctx, window, max_ctx = _blayout(kind, rng)
    n_pages = -(-max_ctx // page)
    # distinct pages per sequence, shuffled; the columns past a context
    # point at trash page 0, as the executor's block tables do
    tables = (1 + rng.permutation(b * n_pages)).reshape(b, n_pages)
    for i, c in enumerate(ctx):
        tables[i, -(-c // page):] = 0
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    pool_shape = (b * n_pages + 1, page, HKV, D)
    dev = torch.device(device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    args = (randn(b, tq, H, D), randn(*pool_shape), randn(*pool_shape),
            i32(tables), i32(ctx), i32(q_starts))
    return BStep(kind, tq, q_starts, ctx, window, page, args)


def bstep_bound(st: BStep, elem: int = 4,
                flops_per_s: float = FP32_FLOPS_PER_S) -> dict:
    """As ``step_bound``: each input byte read once (q, the visible K/V
    rows, the table entries they need, metadata), the output written once,
    ``elem`` bytes an element of q, K, V and the output; FLOPs of QK and PV
    over the keys each row sees, at ``flops_per_s``."""
    g = H // HKV
    b = len(st.ctx)
    keys = flops = pages_read = 0
    for i in range(b):
        lo, hi = st.visible(i)
        keys += max(hi - lo, 0)
        pages_read += max(-(-hi // st.page) - lo // st.page, 0)
        for t in range(st.tq):
            qp = st.q_starts[i] + t
            k_hi = min(st.ctx[i], qp + 1)
            k_lo = 0 if st.window is None else max(0, qp - st.window + 1)
            flops += max(k_hi - k_lo, 0) * HKV * g * D * 4
    q_bytes = b * st.tq * H * D * elem
    nbytes = (q_bytes + keys * HKV * D * elem * 2 + pages_read * 4
              + b * 2 * 4 + q_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def blibrary_call(st: BStep):
    """The SDPA yardstick: one call over the padded batched view (the keys
    each sequence can see, padded to the widest, boolean mask). Gathering
    is set-up, not timed. Returns (fn, check) as ``library_call``."""
    import torch.nn.functional as F
    q, kp, vp, tables = st.args[:4]
    g, b = H // HKV, len(st.ctx)
    dev = q.device
    spans = [st.visible(i) for i in range(b)]
    width = max(hi - lo for lo, hi in spans)
    kb = torch.zeros(b, H, width, D, device=dev, dtype=q.dtype)
    vb = torch.zeros_like(kb)
    mask = torch.zeros(b, 1, st.tq, width, dtype=torch.bool, device=dev)
    for i, (lo, hi) in enumerate(spans):
        idx = torch.arange(lo, hi, device=dev)
        pg = tables[i].long()[idx // st.page]
        kb[i, :, :hi - lo] = kp[pg, idx % st.page].repeat_interleave(
            g, 1).transpose(0, 1)
        vb[i, :, :hi - lo] = vp[pg, idx % st.page].repeat_interleave(
            g, 1).transpose(0, 1)
        qp = st.q_starts[i] + torch.arange(st.tq, device=dev)[:, None]
        m = idx[None] <= qp
        if st.window is not None:
            m &= (qp - idx[None]) < st.window
        mask[i, 0, :, :hi - lo] = m
    qb = q.transpose(1, 2)                           # (B, H, Tq, D)

    def fn():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)

    def check(out, expect):
        return float((out.transpose(1, 2) - expect).abs().max())

    return fn, check


def check_bkernel(st: BStep, timer) -> dict:
    """Batched kernel vs plain version on ``st``; times all three."""
    q, kp, vp, *meta = st.args
    kern = lambda: paged_attention(q, kp, vp, *meta, window=st.window)
    plain = lambda: paged_attention_ref(q, kp, vp, *meta, window=st.window)
    got, want = kern(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{st.name}/page {st.page}: non-finite output")
    err = float((got - want).abs().max())
    kp2, vp2 = poisoned(st)
    same = torch.equal(
        paged_attention(q, kp2, vp2, *meta, window=st.window), got)
    del kp2, vp2
    lib_fn, lib_check = blibrary_call(st)
    lib_err = lib_check(lib_fn(), want)
    rec = {"step": st.name, "page": st.page, "batch": len(st.ctx),
           "tq": st.tq, "window": st.window, "max_abs_err": err,
           "poison_ok": same, "library_max_abs_err": lib_err,
           **bstep_bound(st)}
    if err > ATOL_KERNEL or not same:
        _emit("batched_kernel_step", rec)
        raise AssertionError(f"{st.name}/page {st.page}: batched kernel "
                             f"disagrees with its plain version")
    rec.update(time_in_turns(timer, kern, plain, lib_fn))
    if q.is_cuda:
        rec["graph_ms"] = graph_timer(kern)
    return rec


def phase_batched_kernels(device, timer) -> list:
    recs = []
    for kind in ("d_decode", "e_verify", "f_chunk", "g_window"):
        for page in (128, 16):
            st = make_bstep(kind, page, device)
            recs.append(check_bkernel(st, timer))
            _emit("batched_kernel_step", recs[-1])
            del st
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 3c: the quantized ragged kernel (B2) against its plain version
# ---------------------------------------------------------------------------

def quantize_step(st: Step, fmt: str, seed: int = 0):
    """``st``'s pools quantized to ``fmt``, scale pages at permuted ids.
    Returns (the B2 argument tuple, the dequantized pools (data-page
    order), the spec)."""
    q, kp, vp, tables, *meta = st.args
    spec = kv_quant_spec(fmt, q.device)
    kq, ks = quantize_kv(kp, spec)
    vq, vs = quantize_kv(vp, spec)
    deq = (dequantize_kv(kq, ks), dequantize_kv(vq, vs))
    perm = torch.as_tensor(np.random.default_rng(seed + 1).permutation(
        kp.shape[0]), device=q.device)
    inv = torch.argsort(perm)
    stables = perm[tables.long()].to(torch.int32)
    args = (q, kq, vq, ks[inv].contiguous(), vs[inv].contiguous(), tables,
            stables, *meta)
    return args, deq, spec


def quant_tol(q, kp, vp, spec) -> float:
    """tests/test_kernels.py::_quant_attention_tol: the §14 bound on the
    quantized attention's distance from the fp32 oracle."""
    q1 = float(q.abs().sum(-1).max())
    kmax, vmax = float(kp.abs().max()), float(vp.abs().max())
    delta = D ** -0.5 * q1 * kmax * spec.half_step
    return (math.exp(2.0 * delta) - 1.0) * vmax + vmax * spec.half_step + 1e-6


def poisoned_quant(st: Step, qargs):
    """Copies of the quantized pools with 0x7F bytes (NaN in e4m3fn) in
    every value slot no row of its sequence may read and NaN in those
    slots' scales."""
    _, kq, vq, ks, vs, tables, stables = qargs[:7]
    kb, vb = kq.view(torch.uint8).clone(), vq.view(torch.uint8).clone()
    ks2, vs2 = ks.clone(), vs.clone()
    kv = torch.arange(tables.shape[1] * st.page, device=kq.device)
    for s in range(len(st.ctx)):
        lo, _ = st.visible(s)
        bad = (kv < lo) | (kv >= st.ctx[s])
        col, slot = kv[bad] // st.page, kv[bad] % st.page
        kb[tables[s].long()[col], slot] = 0x7F
        vb[tables[s].long()[col], slot] = 0x7F
        ks2[stables[s].long()[col], slot] = float("nan")
        vs2[stables[s].long()[col], slot] = float("nan")
    return kb.view(kq.dtype), vb.view(vq.dtype), ks2, vs2


def check_quant_kernel(st: Step, fmt: str, timer) -> dict:
    """B2 vs its plain version on ``st`` quantized to ``fmt``; times B2,
    the plain version and SDPA over the dequantized view."""
    q, kp, vp, tables, *meta = st.args
    args, (kd, vd), spec = quantize_step(st, fmt)
    kern = lambda: paged_attention_ragged_quant(*args, window=st.window)
    plain = lambda: paged_attention_ragged_quant_ref(*args, window=st.window)
    got, want = kern(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{st.name}/{fmt}/page {st.page}: non-finite")
    err = float((got - want).abs().max())
    fp32 = paged_attention_ragged_ref(*st.args, window=st.window)
    err32 = float((got - fp32).abs().max())
    tol32 = quant_tol(q, kp, vp, spec)
    del fp32
    pad = float(got[sum(st.q_lens):].abs().max()) if got.shape[0] > sum(
        st.q_lens) else 0.0
    same = torch.equal(paged_attention_ragged_quant(
        q, *poisoned_quant(st, args), *args[5:], window=st.window), got)
    # the yardstick reads the dequantized pools: dequantizing is set-up
    lib_fn, lib_check = library_call(dataclasses.replace(
        st, args=(q, kd, vd, tables, *meta)))
    lib_err = lib_check(lib_fn(), want)
    rec = {"step": st.name, "format": fmt, "page": st.page,
           "rows": sum(st.q_lens), "seqs": len(st.q_lens),
           "window": st.window, "max_abs_err": err,
           "fp32_oracle_max_abs_err": err32, "s14_tolerance": tol32,
           "pad_rows_max": pad, "poison_ok": same,
           "library_max_abs_err": lib_err,
           **step_bound(st, kv_bytes=1, scale_bytes=4)}
    if err > ATOL_KERNEL or err32 > tol32 or pad != 0.0 or not same:
        _emit("quant_kernel_step", rec)
        raise AssertionError(f"{st.name}/{fmt}/page {st.page}: B2 "
                             f"disagrees with its plain version")
    b1 = lambda: paged_attention_ragged(q, kp, vp, tables, *meta,
                                        window=st.window)
    rec.update(time_in_turns(timer, kern, plain, lib_fn, b1_ms=b1))
    if q.is_cuda:
        rec.update(graph_ms=graph_timer(kern), b1_graph_ms=graph_timer(b1))
    return rec


def phase_quant_kernels(device, timer) -> list:
    """Phase 3c: steps (a)-(c) at pages of 128 and 16, then the split
    steps (o)-(r) at pages of 128, each in int8 and fp8-e4m3."""
    recs = []
    steps = [(kind, page) for kind in ("a_mixed", "b_decode", "c_window")
             for page in (128, 16)] + [(kind, 128) for kind in SPLIT_STEPS]
    for kind, page in steps:
        st = make_step(kind, page, device)
        for fmt in ("int8", "fp8_e4m3"):
            recs.append(check_quant_kernel(st, fmt, timer))
            _emit("quant_kernel_step", recs[-1])
        del st
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 3d: the expert GEMM (B4) against its plain version
# ---------------------------------------------------------------------------

def moe_steps() -> list:
    """(name, E, C, K, N) of phase 3d: mixtral-8x7b's gate/up (K=d, N=f)
    and down (K=f, N=d) GEMMs at the capacity of a 64-token decode step,
    a 512-token and a 2048-token chunk, then kimi-k2's gate GEMM at a
    64-token decode step."""
    mix, kimi = get("mixtral-8x7b"), get("kimi-k2-1t-a32b")
    steps = []
    for tag, t in (("h_decode64", 64), ("i_chunk512", 512),
                   ("j_chunk2048", 2048)):
        e, c = mix.moe.n_experts, _capacity(t, mix.moe)
        d, f = mix.d_model, mix.moe.d_ff_expert
        steps += [(f"{tag}_gate_up", e, c, d, f), (f"{tag}_down", e, c, f, d)]
    steps.append(("k_kimi_decode64_gate", kimi.moe.n_experts,
                  _capacity(64, kimi.moe), kimi.d_model,
                  kimi.moe.d_ff_expert))
    return steps


def check_moe_kernel(name, e, c, k, n, w, timer, device, seed=0) -> dict:
    """B4 vs its plain version and ``torch.bmm`` on x ~ N(0, 0.3²) against
    ``w``; gate: max abs error < 2e-4·√K (tests/test_kernels.py)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((e, c, k), generator=g, device=device).mul_(0.3)
    kern = lambda: moe_gmm(x, w)
    plain = lambda: moe_gmm_ref(x, w)
    library = lambda: torch.bmm(x, w)
    got, want = kern(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    tol = 2e-4 * k ** 0.5
    # both against fp64 on the first expert's first rows: the plain
    # version (cuBLAS) may run the same fp32 FMA chain as B4
    rows = min(c, 8)
    exact = x[0, :rows].double() @ w[0].double()
    rec = {"step": name, "E": e, "C": c, "K": k, "N": n,
           "max_abs_err": err, "tolerance": tol,
           "rel_err": err / float(want.abs().max()),
           "fp64_max_abs_err": float((got[0, :rows] - exact).abs().max()),
           "plain_fp64_max_abs_err": float(
               (want[0, :rows] - exact).abs().max()),
           "library_max_abs_err": float((library() - want).abs().max()),
           "repeat_bitwise": torch.equal(kern(), got), **gmm_bound(e, c, k, n)}
    del got, want, exact
    if (err >= tol or rec["fp64_max_abs_err"] >= tol
            or not rec["repeat_bitwise"]):
        _emit("moe_kernel_step", rec)
        raise AssertionError(f"{name}: B4 disagrees with its plain version")
    rec.update(time_in_turns(timer, kern, plain, library))
    if x.is_cuda:
        rec.update(graph_ms=graph_timer(kern),
                   library_graph_ms=graph_timer(library))
    return rec


def phase_moe_kernels(device, timer, steps=None) -> list:
    """Phase 3d. The weights are N(0, 0.3²) like x; one w per (E, K, N),
    freed before the next shape (kimi's holds 22.5 GB)."""
    recs, w, w_shape = [], None, None
    cuda = torch.device(device).type == "cuda"
    for i, (name, e, c, k, n) in enumerate(steps or moe_steps()):
        if (e, k, n) != w_shape:
            del w
            if cuda:
                torch.cuda.empty_cache()
            g = torch.Generator(device=device).manual_seed(100 + i)
            w = torch.randn((e, k, n), generator=g, device=device).mul_(0.3)
            w_shape = (e, k, n)
        recs.append(check_moe_kernel(name, e, c, k, n, w, timer, device, i))
        _emit("moe_kernel_step", recs[-1])
    del w
    if cuda:
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 3e: the SSD chunk scan (B5) against its plain version
# ---------------------------------------------------------------------------

# (name, B, prompt tokens) of phase 3e at mamba2-1.3b's heads: 5e (i)'s and
# (ii)'s shapes, then a prompt shorter than the chunk
SSM_STEPS = (("l_b8_s2048", 8, 2048), ("m_b1_s32768", 1, 32768),
             ("n_b8_s100", 8, 100))
# phase 3e at zamba2-2.7b's heads (H 80, P 64, N 64): 5h's prefill shape
HYBRID_SSM_STEPS = (("h_b8_s2048", 8, 2048),)


def scan_shape(cfg, batch: int, prompt: int) -> tuple:
    """(B, NC, L, H, P, N) that ``mamba_seq`` gives B5 for ``batch``
    prompts of ``prompt`` tokens: chunks of min(chunk, prompt), the last
    one padded."""
    s = cfg.ssm
    chunk = min(s.chunk, prompt)
    return (batch, -(-prompt // chunk), chunk, s.n_heads(cfg.d_model),
            s.head_dim, s.d_state)


def check_ssm_kernel(name, shape, nonzero, timer, device, seed=0) -> dict:
    """B5 vs its plain version at ``shape`` (B, NC, L, H, P, N), from a
    zero initial state or (``nonzero``) one ~ N(0, 0.3²). Gate: max abs
    error ≤ 1e-4 · max(1, max|plain|) on y and on the state, the same
    against fp64 on the first sequence's first two heads, a second launch
    bitwise equal."""
    b, nc, l, h, p, n = shape
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shp: torch.randn(shp, generator=g, device=device)
    x = rnd(b, nc, l, h, p).mul_(0.3)
    a = rnd(b, nc, l, h).abs_().mul_(-0.1)
    bm, cm = rnd(b, nc, l, n).mul_(0.3), rnd(b, nc, l, n).mul_(0.3)
    s0 = (rnd(b, h, p, n).mul_(0.3) if nonzero
          else torch.zeros((b, h, p, n), device=device))
    kern = lambda: mamba_chunk_scan(x, a, bm, cm, s0)
    plain = lambda: mamba_chunk_scan_ref(x, a, bm, cm, s0)
    (y, st), (y_p, st_p) = kern(), plain()
    if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
        raise AssertionError(f"{name}: non-finite output")
    tol_y = ATOL_KERNEL * max(1.0, float(y_p.abs().max()))
    tol_st = ATOL_KERNEL * max(1.0, float(st_p.abs().max()))
    y64, st64 = mamba_chunk_scan_ref(
        x[:1, :, :, :2].double(), a[:1, :, :, :2].double(), bm[:1].double(),
        cm[:1].double(), s0[:1, :2].double())
    y2, st2 = kern()
    carried = nc - 1 + int(nonzero)
    rec = {"step": name, "B": b, "NC": nc, "L": l, "H": h, "P": p, "N": n,
           "init_state": "nonzero" if nonzero else "zero",
           "max_abs_err": float((y - y_p).abs().max()),
           "state_max_abs_err": float((st - st_p).abs().max()),
           "tolerance": tol_y, "state_tolerance": tol_st,
           "fp64_max_abs_err": max(
               float((y[:1, :, :, :2] - y64).abs().max()),
               float((st[:1, :2] - st64).abs().max())),
           "plain_fp64_max_abs_err": max(
               float((y_p[:1, :, :, :2] - y64).abs().max()),
               float((st_p[:1, :2] - st64).abs().max())),
           "repeat_bitwise": torch.equal(y2, y) and torch.equal(st2, st),
           **scan_bound(b, nc, l, h, p, n, carried)}
    del y, st, y_p, st_p, y64, st64, y2, st2
    if (rec["max_abs_err"] > tol_y or rec["state_max_abs_err"] > tol_st
            or rec["fp64_max_abs_err"] > tol_y or not rec["repeat_bitwise"]):
        _emit("ssm_kernel_step", rec)
        raise AssertionError(f"{name}: B5 disagrees with its plain version")
    rec.update(time_in_turns(timer, kern, plain, None))
    if torch.device(device).type == "cuda":
        rec["graph_ms"] = graph_timer(kern)
        _emit("ssm_launches_ms", {"step": name,
                                  "ms": device_ms_by_kernel(kern, 5)})
    return rec


def phase_ssm_kernels(device, timer, cfg=None, steps=SSM_STEPS) -> list:
    """Phase 3e at ``cfg``'s heads (mamba2-1.3b by default): every step
    from a zero and from a nonzero initial state; on the card first the
    occupancy the runtime grants B5's kernels."""
    cfg = cfg or get("mamba2-1.3b")
    if torch.device(device).type == "cuda":
        blocks = mamba2_scan.occupancy()
        plan = mamba2_scan.scan_plan(*scan_shape(cfg, *steps[0][1:]))
        _emit("ssm_occupancy", {
            "blocks_per_sm": blocks,
            "warps_per_sm": {k: blocks[k] * launch.threads // 32
                             for k, launch in plan.launches.items()}})
    recs = []
    for i, (name, batch, prompt) in enumerate(steps):
        for nonzero in (False, True):
            tag = f"{name}_{'state' if nonzero else 'zero'}"
            recs.append(check_ssm_kernel(tag, scan_shape(cfg, batch, prompt),
                                         nonzero, timer, device, seed=i))
            _emit("ssm_kernel_step", recs[-1])
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return recs


# phase 3g: B5's backward at 3e's (l) and (m) and 3e (h)'s shapes
SSM_BACKWARD_STEPS = (("mamba2-1.3b", SSM_STEPS[0]),
                      ("mamba2-1.3b", SSM_STEPS[1]),
                      ("zamba2-2.7b", HYBRID_SSM_STEPS[0]))
SCAN_NEEDS = (True, True, True, True, False)   # as in training: no dinit


def check_ssm_backward(name, shape, timer, device, seed=0) -> dict:
    """B5's backward (``mamba_chunk_scan_backward`` on what a forward launch
    left: y and its scratch) against the fp64 plain backward, 3e's input
    distributions and dy ~ N(0, 1), a zero start and no final-state
    gradient (the training path's). Gate: every gradient (dxdt, da_dt,
    db, dc) within 1e-4 of its max |g|, a repeat bitwise equal. Times the
    kernel, its fp32 plain version and, on the card, its device work alone
    (CUDA-graph replay) and each of its five launches (``torch.profiler``
    over 5 calls)."""
    b, nc, l, h, p, n = shape
    cuda = torch.device(device).type == "cuda"
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shp: torch.randn(shp, generator=g, device=device)
    x = rnd(b, nc, l, h, p).mul_(0.3)
    a = rnd(b, nc, l, h).abs_().mul_(-0.1)
    bm, cm = rnd(b, nc, l, n).mul_(0.3), rnd(b, nc, l, n).mul_(0.3)
    dy = rnd(b, nc, l, h, p)
    saved = mamba2_scan._launch(x, a, bm, cm, None)[::2] if cuda else None
    kern = lambda: mamba_chunk_scan_backward(x, a, bm, cm, None, dy, None,
                                             saved, SCAN_NEEDS)
    plain = lambda: mamba_chunk_scan_backward_ref(x, a, bm, cm, None, dy,
                                                  None)
    got, again = kern()[:4], kern()[:4]
    names = ("dxdt", "da_dt", "db", "dc")
    rec = {"step": name, "B": b, "NC": nc, "L": l, "H": h, "P": p, "N": n,
           "repeat_bitwise": all(torch.equal(u, v)
                                 for u, v in zip(got, again))}
    del again
    exact = mamba_chunk_scan_backward_ref(
        x.double(), a.double(), bm.double(), cm.double(), None,
        dy.double(), None)[:4]
    for k, u, e in zip(names, got, exact):
        err = float((u.double() - e).abs().max())
        rec[f"{k}_max_abs_err"] = err
        rec[f"{k}_rel_err"] = err / float(e.abs().max())
    del exact
    plain_got = plain()[:4]
    rec["plain_vs_kernel_max_abs_err"] = max(
        float((u - v).abs().max()) for u, v in zip(got, plain_got))
    del got, plain_got
    rec["max_abs_err"] = max(rec[f"{k}_max_abs_err"] for k in names)
    rec["max_rel_err"] = max(rec[f"{k}_rel_err"] for k in names)
    rec.update(scan_backward_bound(b, nc, l, h, p, n))
    if rec["max_rel_err"] > ATOL_KERNEL or not rec["repeat_bitwise"]:
        _emit("ssm_backward_step", rec)
        raise AssertionError(f"{name}: B5's backward disagrees with the "
                             f"fp64 plain backward or does not repeat")
    rec.update(time_in_turns(timer, kern, plain, None))
    if cuda:
        rec["graph_ms"] = graph_timer(kern)
        _emit("ssm_backward_launches_ms", {
            "step": name, "ms": device_ms_by_kernel(kern, 5)})
    return rec


def phase_ssm_backward(device, timer, steps=SSM_BACKWARD_STEPS) -> list:
    """Phase 3g: B5's backward at each (arch, (name, B, prompt)) step's
    scan shape."""
    recs = []
    for i, (arch, (name, batch, prompt)) in enumerate(steps):
        recs.append(check_ssm_backward(
            name, scan_shape(get(arch), batch, prompt), timer, device,
            seed=30 + i))
        _emit("ssm_backward_step", recs[-1])
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 4-5: serving through the engine
# ---------------------------------------------------------------------------

def make_requests(cfg, n: int, prompt_range, new_tokens: int, gap: float,
                  seed: int, slo=(30.0, 2.0)) -> list:
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        toks = [int(x) for x in rng.integers(0, cfg.vocab, plen)]
        reqs.append(Request(i, arrival=gap * i, prompt_len=plen,
                            max_new_tokens=new_tokens, ttft_slo=slo[0],
                            tpot_slo=slo[1], tokens=toks))
    return reqs


KERNELS = {"paged_attention_ragged": paged_attention_ragged,
           "paged_attention": paged_attention,
           "paged_attention_ragged_quant": paged_attention_ragged_quant,
           "moe_gmm": moe_gmm, "mamba2_scan": mamba_chunk_scan,
           "mamba2_scan_backward": mamba_chunk_scan_backward}
# launches of each kernel summed over every serving and training run on
# the card
SERVING_LAUNCHES = {name: 0 for name in KERNELS}


def _counted(cuda: bool, fn):
    """Run ``fn`` with every kernel's count set to 0 just before; return
    its result and the launches it made (added to the serving sums on the
    card)."""
    for k in KERNELS.values():
        k.launches = 0
    out = fn()
    launches = {name: k.launches for name, k in KERNELS.items()}
    if cuda:
        for name, c in launches.items():
            SERVING_LAUNCHES[name] += c
    return out, launches


@dataclasses.dataclass
class Served:
    """One serving run: its engine and executor, first-token logits by
    request, wall seconds, each kernel's launches in the run, the
    (horizon, γ) of every multi-step (γ = 0) or speculative dispatch, the
    (token rows, layers) of every forward pass and the scheduler's
    decisions (``numerics.SchedTrace``)."""
    eng: Engine
    ex: PagedTransformerExecutor
    first: dict
    wall: float
    launches: dict
    multi: list
    forwards: list
    trace: object

    @property
    def tokens(self) -> dict:
        return {r: list(q.generated_tokens)
                for r, q in self.eng.requests.items()}


def _no_sync(fn):
    """``fn`` under torch's sync debug mode set to raise: any device→host
    synchronisation while it runs is an error."""
    def run(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def _record_forwards(ex, forwards: list) -> None:
    """Append (token rows, layers run) for every forward pass of ``ex``:
    the fused step's bucket, and each batched pass's B·T rows (sequential
    chunks and decodes, every step of a committed horizon)."""
    fused_step, forward = ex._fused_step, ex._forward

    def fused(st, t_bucket):
        forwards.append((t_bucket, ex.cfg.n_layers))
        return fused_step(st, t_bucket)

    def batched(x, *args, n_layers=None, **kw):
        forwards.append((x.shape[0] * x.shape[1],
                         ex.cfg.n_layers if n_layers is None else n_layers))
        return forward(x, *args, n_layers=n_layers, **kw)

    ex._fused_step, ex._forward = fused, batched


def serve(cfg, params, device, requests, *, page_size, num_pages,
          max_pages_per_seq, capture_logits=False, max_steps=20_000,
          mode="fused", horizon=1, gamma=0, draft=None,
          check_sync=True, kv_dtype="fp32", ragged=True,
          moe_impl="exact", clock=None, cache_pages=None,
          preemption=False, mesh=None, cost_shards=1,
          on_executor=None) -> Served:
    """Serve ``requests`` to completion. On the card, with ``check_sync``,
    every committed horizon and speculative round body runs under torch's
    sync debug mode set to raise: it may not wait for the device. With a
    ``clock`` (a ``LinearCostModel``) the engine runs on that model's step
    times instead of the wall clock, committed horizons and speculative
    rounds included, so that the plans do not depend on the device.
    ``cache_pages`` (not None) attaches a ``PrefixCache`` of that many
    pages on the executor's allocator (0: a disabled cache);
    ``preemption`` lets the engine evict victims for starving requests.
    With a ``mesh`` this is rank 0 of a sharded executor (the caller stops
    the other ranks after), its engine at ``cost_shards`` per-shard
    budgets. ``on_executor(ex)`` runs before the engine starts."""
    ex = PagedTransformerExecutor(cfg, params, num_pages=num_pages,
                                  page_size=page_size,
                                  max_pages_per_seq=max_pages_per_seq,
                                  mode=mode, capture_logits=capture_logits,
                                  kv_dtype=kv_dtype,
                                  ragged_attention=ragged,
                                  moe_impl=moe_impl, mesh=mesh,
                                  device=device)
    if draft is not None:
        ex.set_draft(draft)
    forwards: list = []
    _record_forwards(ex, forwards)
    cuda = torch.device(device).type == "cuda"
    if cuda and check_sync:
        ex._multi_decode_step = _no_sync(ex._multi_decode_step)
        ex._spec_multi_step = _no_sync(ex._spec_multi_step)
    multi, execute_multi = [], ex.execute_multi

    def recorded(plan, reqs, now, h, *, speculate=0):
        n0 = ex.n_dispatches
        out = execute_multi(plan, reqs, now, h, speculate=speculate)
        if ex.n_dispatches > n0:
            multi.append((h, speculate))
        return out

    ex.execute_multi = recorded
    if on_executor is not None:
        on_executor(ex)
    slo_ttft, slo_tpot = requests[0].ttft_slo, requests[0].tpot_slo
    if clock is None:
        sched = make_scheduler("fairbatching",
                               LinearCostModel(a=5e-3, b=7e-5, c=4e-8))
        timed = ex
    else:
        sched = make_scheduler("fairbatching", clock, calibrate=False)
        timed = ModelTimedMultiExecutor(ex, clock)
    cache = None
    if cache_pages is not None:
        cache = PrefixCache(cache_pages, block_size=page_size, alloc=ex.alloc)
        ex.attach_cache(cache)
    eng = Engine(sched, timed, EngineConfig(ttft_slo=slo_ttft,
                                            tpot_slo=slo_tpot,
                                            commit_horizon=horizon,
                                            speculate=gamma,
                                            preemption=preemption,
                                            cost_shards=cost_shards),
                 prefix_cache=cache)
    for r in requests:
        eng.submit(r)
    trace = capture_schedule(eng)
    first = {}

    def loop() -> float:
        t0, n = time.perf_counter(), 0
        while eng.has_work and n < max_steps:
            eng.step()
            n += 1
            for rid, lg in ex.last_logits.items():
                first.setdefault(rid, lg)
        return time.perf_counter() - t0

    wall, launches = _counted(cuda, loop)
    if eng.has_work:
        raise AssertionError(f"engine still busy after {max_steps} steps")
    return Served(eng, ex, first, wall, launches, multi, forwards, trace)


PARITY_PAGES = dict(page_size=16, num_pages=64, max_pages_per_seq=8)


def phase_parity(cfg, device) -> tuple[dict, dict]:
    """The same weights and requests on ``device`` and on the CPU; returns
    the record and the card's tokens."""
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    out = {}
    for dev in (device, "cpu"):
        reqs = make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
        run = serve(cfg, params, dev, reqs, capture_logits=True,
                    **PARITY_PAGES)
        out[dev] = (run.tokens, run.first)
    (tok_d, lg_d), (tok_c, lg_c) = out[device], out["cpu"]
    err = max(float(np.abs(lg_d[r] - lg_c[r]).max()) for r in lg_c)
    rec = {"requests": len(tok_c), "tokens_equal": tok_d == tok_c,
           "first_logits_max_abs_err": err,
           "tokens": sum(len(v) for v in tok_c.values())}
    _emit("serve_parity", rec)
    if tok_d != tok_c or lg_d.keys() != lg_c.keys() or err > ATOL_LOGITS:
        raise AssertionError("card and CPU runs disagree")
    return rec, tok_d


def phase_path_parity(cfg, device, fused_tokens: dict) -> list:
    """Phase 4's weights and requests through the sequential, multi-step
    and speculative paths, on ``device`` and on the CPU."""
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = init_params(dcfg, torch.Generator().manual_seed(5), "cpu")
    paths = {
        "sequential": dict(mode="sequential", capture_logits=True),
        "multi_h4": dict(horizon=4),
        "spec_self_draft": dict(gamma=2, draft=lambda: TruncatedSelfDraft(1)),
        "spec_small_draft": dict(gamma=2, draft=lambda: SmallModelDraft(
            dcfg, dparams)),
    }
    recs = []
    for name, kw in paths.items():
        kw = dict(kw)
        make_draft = kw.pop("draft", None)
        runs = {}
        for dev in (device, "cpu"):
            reqs = make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
            runs[dev] = serve(cfg, params, dev, reqs, **PARITY_PAGES,
                              draft=make_draft() if make_draft else None,
                              **kw)
        d, c = runs[device], runs["cpu"]
        rec = {"path": name, "tokens_equal_cpu": d.tokens == c.tokens,
               "tokens_equal_fused": d.tokens == fused_tokens,
               "dispatches": d.ex.n_dispatches, "steps": len(d.eng.steps),
               "multi_dispatches": len(d.multi), "launches": d.launches,
               "spec_accepted": d.eng.spec_accepted,
               "spec_drafted": d.eng.spec_drafted}
        ok = rec["tokens_equal_cpu"] and rec["tokens_equal_fused"]
        if name == "sequential":
            err = max(float(np.abs(d.first[r] - c.first[r]).max())
                      for r in c.first)
            rec["first_logits_max_abs_err"] = err
            ok &= d.first.keys() == c.first.keys() and err <= ATOL_LOGITS
        else:
            ok &= len(d.multi) >= 1
        _emit("path_parity", rec)
        if not ok:
            raise AssertionError(f"path {name}: card, CPU and fused "
                                 f"single-step runs disagree")
        recs.append(rec)
    return recs


def attention_passes(run: Served, cfg) -> int:
    """Attention launches per layer the run's dispatches imply, each one
    kernel launch: one per fused or sequential dispatch, H per committed
    horizon, and per speculative round γ draft steps (+ the draft's sync
    pass) over the draft's layers plus one verify pass over all."""
    nl = cfg.n_layers
    draft = run.ex.draft
    per_multi = sum(h * ((g + draft.needs_sync_pass) * draft.n_layers + nl
                         if g else nl) for h, g in run.multi)
    return per_multi + nl * (run.ex.n_dispatches - len(run.multi))


def phase_quant_parity(cfg, device) -> list:
    """Phase 4's weights and requests with quantized KV: fused on the card
    and the CPU, then every other path on the card, against the card's
    fused single-step tokens of the same dtype."""
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    paths = {"batched": dict(ragged=False),
             "sequential": dict(mode="sequential"),
             "multi_h4": dict(horizon=4),
             "spec_self_draft": dict(gamma=2, draft=TruncatedSelfDraft)}
    recs = []
    for kv in ("int8", "fp8_e4m3"):
        runs = {}
        for dev in (device, "cpu"):
            reqs = make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
            runs[dev] = serve(cfg, params, dev, reqs, capture_logits=True,
                              kv_dtype=kv, **PARITY_PAGES)
        d, c = runs[device], runs["cpu"]
        err = max(float(np.abs(d.first[r] - c.first[r]).max())
                  for r in c.first)
        # logits are reported, not gated: K/V rows that differ by fp32
        # noise between card and CPU may quantize an element to the
        # neighbouring step, so only the tokens must be equal
        rec = {"kv_dtype": kv, "path": "fused", "tokens_equal_cpu":
               d.tokens == c.tokens, "first_logits_max_abs_err": err,
               "dispatches": d.ex.n_dispatches, "launches": d.launches}
        ok = d.tokens == c.tokens and d.first.keys() == c.first.keys()
        runs = {"fused": d}
        for name, kw in paths.items():
            kw = dict(kw)
            make_draft = kw.pop("draft", None)
            reqs = make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
            runs[name] = serve(cfg, params, device, reqs, kv_dtype=kv,
                               draft=make_draft(1) if make_draft else None,
                               **PARITY_PAGES, **kw)
        _emit("quant_parity", rec)
        recs.append(rec)
        for name, run in runs.items():
            want = attention_passes(run, cfg)
            prec = {"kv_dtype": kv, "path": name,
                    "tokens_equal_fused": run.tokens == d.tokens,
                    "dispatches": run.ex.n_dispatches,
                    "multi_dispatches": len(run.multi),
                    "launches": run.launches,
                    "expected_quant_launches": want}
            ok &= (prec["tokens_equal_fused"]
                   and run.launches["paged_attention_ragged_quant"] == want
                   and run.launches["paged_attention_ragged"] == 0
                   and run.launches["paged_attention"] == 0)
            if name in ("multi_h4", "spec_self_draft"):
                ok &= len(run.multi) >= 1
            if name != "fused":
                _emit("quant_path_parity", prec)
                recs.append(prec)
        if not ok:
            raise AssertionError(f"{kv}: card, CPU and paths disagree")
        del runs, d, c
    return recs


def _check_outputs(run: Served, cfg, new_tokens: int) -> None:
    for r in run.eng.requests.values():
        toks = r.generated_tokens
        if len(toks) != new_tokens or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"request {r.req_id}: bad output {toks[:8]}")


def _serve_record(run: Served, reqs, cfg, cuda: bool) -> dict:
    s = summarize(run.eng.done, duration=max(run.eng.now, 1e-9))
    n_out = sum(len(r.generated_tokens) for r in run.eng.requests.values())
    # engine-clock step times: a committed horizon's steps get dt / H each
    pre = [st.t_end - st.t_start for st in run.eng.steps if st.n_prefill]
    dec = [st.t_end - st.t_start for st in run.eng.steps if not st.n_prefill]
    return {"model": cfg.name, "layers": cfg.n_layers, "requests": len(reqs),
            "prompt_tokens": sum(r.prompt_len for r in reqs),
            "output_tokens": n_out, "steps": len(run.eng.steps),
            "dispatches": run.ex.n_dispatches,
            "prefill_step_median_s": statistics.median(pre) if pre else None,
            "decode_step_median_s": statistics.median(dec) if dec else None,
            "wall_s": run.wall, "output_tok_per_s": n_out / run.wall,
            "ttft_p50_s": s["ttft_p50"], "ttft_p99_s": s["ttft_p99"],
            "tpot_p50_s": s["tpot_p50"], "tpot_p99_s": s["tpot_p99"],
            "slo_attainment": s["slo_attainment"],
            "bucket_keys": len(run.ex.compile_keys),
            "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated()
                                           if cuda else None)}


SERVE_PAGES = dict(page_size=128, num_pages=1024, max_pages_per_seq=32)


def phase_serve(cfg, device, *, n_req=16, prompt_range=(256, 3072),
                new_tokens=32, gap=0.05, params=None) -> tuple[dict, dict]:
    """The main path at full width: Engine + fairbatching + fused executor.
    Returns the record and the tokens."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device)
    reqs = make_requests(cfg, n_req, prompt_range, new_tokens, gap, seed=3,
                         slo=(10.0, 0.25))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = serve(cfg, params, device, reqs, **SERVE_PAGES)
    _check_outputs(run, cfg, new_tokens)
    rec = _serve_record(run, reqs, cfg, cuda)
    rec["attention_launches"] = run.launches["paged_attention_ragged"]
    _emit("serve", rec)
    return rec, run.tokens


def _release_memory() -> None:
    """Free the card's memory of finished runs: an executor and its draft
    refer to each other, so their pools wait for the cycle collector."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _share_equal(got: dict, ref: dict) -> float:
    same = sum(a == b for r in ref for a, b in zip(got[r], ref[r]))
    return same / max(sum(len(v) for v in ref.values()), 1)


def phase_serve_paths(cfg, device, params, serve16_tokens: dict) -> list:
    """Sequential mode, committed multi-step decode and speculative decode
    at full width, with their launch counts held to their dispatches."""
    cuda = torch.device(device).type == "cuda"
    serve16 = lambda: make_requests(cfg, 16, (256, 3072), 32, 0.05, seed=3,
                                    slo=(10.0, 0.25))
    decode16 = lambda: make_requests(cfg, 16, (256, 3072), 64, 0.0, seed=3,
                                     slo=(10.0, 0.25))
    if cuda:
        _release_memory()
        torch.cuda.reset_peak_memory_stats()
    ref = serve(cfg, params, device, decode16(), **SERVE_PAGES)
    _check_outputs(ref, cfg, 64)
    decode16_tokens = dict(ref.tokens)
    _emit("serve_path", {"workload": "decode16_fused_reference",
                         **_serve_record(ref, decode16(), cfg, cuda),
                         "launches": ref.launches})
    del ref
    workloads = [
        ("serve16_sequential", serve16, 32, serve16_tokens,
         dict(mode="sequential")),
        ("decode16_multi_h8", decode16, 64, decode16_tokens,
         dict(horizon=8)),
        ("decode16_spec_g3", decode16, 64, decode16_tokens,
         dict(gamma=3, horizon=4, draft=TruncatedSelfDraft(6))),
    ]
    recs = []
    for name, make, new_tokens, ref_tokens, kw in workloads:
        if cuda:
            _release_memory()
            torch.cuda.reset_peak_memory_stats()
        reqs = make()
        run = serve(cfg, params, device, reqs, **SERVE_PAGES, **kw)
        _check_outputs(run, cfg, new_tokens)
        ex, draft = run.ex, run.ex.draft
        # fused single steps launch B1, every other pass B3
        want_b1 = (0 if ex.mode == "sequential"
                   else cfg.n_layers * (ex.n_dispatches - len(run.multi)))
        want_b3 = attention_passes(run, cfg) - want_b1
        rec = {"workload": name, **_serve_record(run, reqs, cfg, cuda),
               "multi_dispatches": len(run.multi),
               "multi_steps": sum(h for h, _ in run.multi),
               "ragged_launches": run.launches["paged_attention_ragged"],
               "batched_launches": run.launches["paged_attention"],
               "expected_ragged_launches": want_b1,
               "expected_batched_launches": want_b3,
               "spec_accepted": run.eng.spec_accepted,
               "spec_drafted": run.eng.spec_drafted,
               "share_tokens_equal_fused": _share_equal(run.tokens,
                                                        ref_tokens)}
        _emit("serve_path", rec)
        if (rec["batched_launches"] != want_b3 or want_b3 == 0
                or rec["ragged_launches"] != want_b1):
            raise AssertionError(f"{name}: launches do not match the "
                                 f"dispatches")
        if ex.mode != "sequential" and not run.multi:
            raise AssertionError(f"{name}: no multi-step dispatch ran")
        recs.append(rec)
        del run, ex, draft
    return recs, decode16_tokens


def pool_bytes(ex) -> int:
    """Bytes of the executor's K/V pools and, quantized, scale pools."""
    pools = [ex.k_pages, ex.v_pages, ex.k_scales, ex.v_scales]
    return sum(p.numel() * p.element_size() for p in pools if p is not None)


def phase_quant_serve(cfg, device, params, serve16_tokens: dict,
                      decode16_tokens: dict) -> list:
    """Full depth with quantized KV: serve-16 in int8 and fp8-e4m3,
    decode-16 in int8 with ``commit_horizon=8``; B2 carries every
    attention pass."""
    cuda = torch.device(device).type == "cuda"
    workloads = [
        ("serve16_int8", 16, 32, 0.05, serve16_tokens,
         dict(kv_dtype="int8")),
        ("serve16_fp8", 16, 32, 0.05, serve16_tokens,
         dict(kv_dtype="fp8_e4m3")),
        ("decode16_int8_multi_h8", 16, 64, 0.0, decode16_tokens,
         dict(kv_dtype="int8", horizon=8)),
    ]
    recs = []
    for name, n, new_tokens, gap, ref_tokens, kw in workloads:
        if cuda:
            _release_memory()
            torch.cuda.reset_peak_memory_stats()
        reqs = make_requests(cfg, n, (256, 3072), new_tokens, gap, seed=3,
                             slo=(10.0, 0.25))
        run = serve(cfg, params, device, reqs, **SERVE_PAGES, **kw)
        _check_outputs(run, cfg, new_tokens)
        want = attention_passes(run, cfg)
        rec = {"workload": name, **_serve_record(run, reqs, cfg, cuda),
               "kv_dtype": kw["kv_dtype"], "pool_bytes": pool_bytes(run.ex),
               "multi_dispatches": len(run.multi),
               "quant_launches": run.launches["paged_attention_ragged_quant"],
               "expected_quant_launches": want,
               "fp32_kernel_launches": run.launches["paged_attention_ragged"]
               + run.launches["paged_attention"],
               "share_tokens_equal_fp32": _share_equal(run.tokens,
                                                       ref_tokens)}
        _emit("quant_serve", rec)
        if (rec["quant_launches"] != want or want == 0
                or rec["fp32_kernel_launches"] != 0):
            raise AssertionError(f"{name}: launches do not match the "
                                 f"dispatches")
        if kw.get("horizon", 1) > 1 and not run.multi:
            raise AssertionError(f"{name}: no multi-step dispatch ran")
        recs.append(rec)
        del run
    return recs


# ---------------------------------------------------------------------------
# phases 4d, 5d: MoE serving (mixtral-8x7b at full width)
# ---------------------------------------------------------------------------

# the card test's cost model: both devices see the same plans
MODEL_CLOCK = LinearCostModel(a=1e-3, b=1e-4, c=0.0)
# 4d's and 4f's depth: one layer each (two until the multi-step and
# speculative TP cases of 4n came), for the time their CPU runs take
MOE_PARITY_LAYERS = 1
CACHE_PARITY_LAYERS = 1


def phase_moe_parity(cfg, device) -> list:
    """Phase 4d: the port's own weights (seed 1) and phase 4's requests on
    a MoE model, the engine on ``MODEL_CLOCK``. Under ``exact`` and
    ``capacity``: card fused tokens = CPU fused tokens, first-token logits
    within 1e-3. On the card, exact fused tokens = sequential and
    ``commit_horizon=4`` tokens. B4 launches = what the forward passes
    imply: three per layer and router chunk under capacity, none under
    exact."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device)
    on_cpu = params_to(params, "cpu")
    reqs = lambda: make_requests(cfg, 6, (8, 64), 8, 0.01, seed=2)
    runs = {}
    for impl in ("exact", "capacity"):
        for dev, p in ((device, params), ("cpu", on_cpu)):
            runs[impl, dev] = serve(cfg, p, dev, reqs(), capture_logits=True,
                                    moe_impl=impl, clock=MODEL_CLOCK,
                                    **PARITY_PAGES)
    for name, kw in (("sequential", dict(mode="sequential")),
                     ("multi_h4", dict(horizon=4))):
        runs["exact", name] = serve(cfg, params, device, reqs(),
                                    clock=MODEL_CLOCK, **PARITY_PAGES, **kw)
    recs, ok = [], True
    for impl in ("exact", "capacity"):
        d, c = runs[impl, device], runs[impl, "cpu"]
        first_err = max(float(np.abs(d.first[r] - c.first[r]).max())
                        for r in c.first)
        rec = {"moe_impl": impl, "path": "fused",
               "tokens_equal_cpu": d.tokens == c.tokens,
               "share_tokens_equal_cpu": _share_equal(d.tokens, c.tokens),
               "first_token_logits_max_abs_err": first_err,
               "dispatches": d.ex.n_dispatches,
               "cpu_dispatches": c.ex.n_dispatches,
               "b4_launches": d.launches["moe_gmm"],
               "expected_b4_launches": moe_launches(d, cfg)}
        ok &= (rec["tokens_equal_cpu"] and d.first.keys() == c.first.keys()
               and first_err <= ATOL_LOGITS
               and rec["dispatches"] == rec["cpu_dispatches"]
               and rec["b4_launches"] == rec["expected_b4_launches"])
        if impl == "capacity":
            ok &= rec["b4_launches"] > 0
        _emit("moe_parity", rec)
        recs.append(rec)
    fused = runs["exact", device]
    for name in ("sequential", "multi_h4"):
        run = runs["exact", name]
        rec = {"moe_impl": "exact", "path": name,
               "tokens_equal_fused": run.tokens == fused.tokens,
               "dispatches": run.ex.n_dispatches,
               "multi_dispatches": len(run.multi),
               "b4_launches": run.launches["moe_gmm"]}
        ok &= rec["tokens_equal_fused"] and rec["b4_launches"] == 0
        if name == "multi_h4":
            ok &= len(run.multi) >= 1
        _emit("moe_parity", rec)
        recs.append(rec)
    if not ok:
        raise AssertionError("MoE parity: card, CPU and paths disagree")
    return recs


MOE_SERVE_PAGES = dict(page_size=128, num_pages=512, max_pages_per_seq=32)
MOE_SERVE_LAYERS = 8             # of mixtral-8x7b's 32: 47.5 GB of fp32


def launches_by_capacity(run: Served, cfg) -> dict:
    """B4 launches a run's forward passes imply, by the per-expert
    capacity C they run at, most launched first: under ``capacity`` three
    per layer and router chunk of each pass, under ``exact`` none."""
    out: dict = {}
    if run.ex.moe_impl != "capacity":
        return out
    for rows, layers in run.forwards:
        c = chunk_capacity(rows, cfg.moe)
        out[c] = out.get(c, 0) + 3 * layers * router_chunks(rows, cfg.moe)
    return dict(sorted(out.items(), key=lambda kv: (-kv[1], kv[0])))


def moe_launches(run: Served, cfg) -> int:
    return sum(launches_by_capacity(run, cfg).values())


def serve_moe_steps(by_capacity: dict, cfg) -> list:
    """Phase 3d's (name, E, C, K, N) at every capacity a serving run
    launched B4 at: gate/up (K=d, N=f) and down (K=f, N=d) each."""
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    steps = []
    for c in by_capacity:
        steps += [(f"5d_C{c}_gate_up", e, c, d, f),
                  (f"5d_C{c}_down", e, c, f, d)]
    return steps


def phase_moe_serve(cfg, device, *, params=None) -> dict:
    """Phase 5d: serve-16 on ``cfg`` (mixtral-8x7b, every published width,
    depth cut) with ``moe_impl="capacity"``, fused, fp32 KV, pages of 128
    and 512 of them. Every request finishes with its tokens in [0, vocab);
    B4 launches = what the forward passes imply. Reports the serving
    numbers and B4's launches by capacity."""
    cuda = torch.device(device).type == "cuda"
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device)
    reqs = make_requests(cfg, 16, (256, 3072), 32, 0.05, seed=3,
                         slo=(10.0, 0.25))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = serve(cfg, params, device, reqs, moe_impl="capacity",
                **MOE_SERVE_PAGES)
    _check_outputs(run, cfg, 32)
    by_c = launches_by_capacity(run, cfg)
    rec = {**_serve_record(run, reqs, cfg, cuda), "moe_impl": "capacity",
           "pool_bytes": pool_bytes(run.ex),
           "b4_launches": run.launches["moe_gmm"],
           "expected_b4_launches": moe_launches(run, cfg),
           "b4_launches_by_capacity": [[c, n] for c, n in by_c.items()],
           "attention_launches": run.launches["paged_attention_ragged"]}
    _emit("moe_serve", rec)
    if (rec["b4_launches"] != rec["expected_b4_launches"]
            or rec["b4_launches"] == 0
            or rec["attention_launches"] != cfg.n_layers
            * run.ex.n_dispatches):
        raise AssertionError("moe serve: launches do not match the "
                             "dispatches")
    return rec


# ---------------------------------------------------------------------------
# DecoderLM's main path: prefill, then greedy decode steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Generated:
    """One ``prefill`` plus greedy ``decode_step``s: tokens (B, steps + 1),
    the prefill's logits, host seconds of the prefill and of each step,
    each kernel's launches in the prefill and in the decode steps, and the
    cache after the last step."""
    tokens: np.ndarray
    first: np.ndarray
    prefill_s: float
    step_s: list
    prefill_launches: dict
    decode_launches: dict
    cache: dict


def generate(cfg, params, device, prompts: np.ndarray, steps: int,
             opts: Optional[ModelOpts] = None) -> Generated:
    """``DecoderLM``'s main path: ``prefill`` then ``steps`` greedy
    ``decode_step``s, each ending on its tokens' copy to the host, as a
    serving loop checks for a stop token. ``prompts`` holds token ids (B,
    S), or embeddings (B, S, d) for a VLM backbone. Every kernel count is
    set to 0 just before and read just after the prefill and the decode
    steps; launches on the card add to ``SERVING_LAUNCHES``."""
    model = DecoderLM(cfg, opts, device=device)
    x = torch.as_tensor(prompts, device=model.device)
    inputs = {"embeds": x} if x.is_floating_point() else x
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, inputs, prompts.shape[1] + steps)
    tok = logits.argmax(-1)
    out = [tok.cpu()]
    prefill_s = time.perf_counter() - t0
    pre = {name: k.launches for name, k in KERNELS.items()}
    first = logits.cpu().numpy()
    for k in KERNELS.values():
        k.launches = 0
    step_s = []
    for _ in range(steps):
        t = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache)
        tok = logits.argmax(-1)
        out.append(tok.cpu())
        step_s.append(time.perf_counter() - t)
    dec = {name: k.launches for name, k in KERNELS.items()}
    if cuda:
        for name in KERNELS:
            SERVING_LAUNCHES[name] += pre[name] + dec[name]
    return Generated(torch.stack(out, 1).numpy(), first, prefill_s, step_s,
                     pre, dec, cache)


# ---------------------------------------------------------------------------
# phase 4h: speculative decode on a MoE target (ROADMAP A11)
# ---------------------------------------------------------------------------

SPEC_GAMMA, SPEC_ROUNDS = 3, 2


@dataclasses.dataclass
class SpecRun:
    """One run on fixed plans: tokens by request, drafts accepted and
    drafted, speculative and fused dispatches, each kernel's launches, and
    the (token rows, layers) of every forward pass."""
    tokens: dict
    accepted: int
    drafted: int
    spec_dispatches: int
    fused_dispatches: int
    launches: dict
    forwards: list


def spec_plans_run(cfg, params, device, requests, *, moe_impl: str,
                   gamma: int, draft_layers: int = 1,
                   chunk: int = 16) -> SpecRun:
    """``fixed_step``'s plans (chunks of ``chunk``, decode items alongside)
    until every active request decodes; then, with ``gamma`` > 0,
    speculative dispatches of ``SPEC_ROUNDS`` rounds over all of them with
    a ``TruncatedSelfDraft(draft_layers)`` (``gamma`` = 0: plain decode
    steps, the non-speculative run on the same plans). The plans depend on
    nothing the device computes; on the card every speculative dispatch
    runs under the sync check."""
    cuda = torch.device(device).type == "cuda"
    ex = PagedTransformerExecutor(cfg, params, moe_impl=moe_impl,
                                  device=device, **PARITY_PAGES)
    if gamma:
        ex.set_draft(TruncatedSelfDraft(draft_layers))
    forwards: list = []
    _record_forwards(ex, forwards)
    if cuda:
        ex._spec_multi_step = _no_sync(ex._spec_multi_step)
    world = {r.req_id: r for r in requests}
    counts = {"accepted": 0, "drafted": 0, "spec": 0}

    def loop() -> None:
        while any(r.active for r in world.values()):
            active = [r for r in world.values() if r.active]
            if gamma and all(r.state is RequestState.DECODE for r in active):
                plan = BatchPlan([BatchItem(r.req_id, 1, TaskKind.DECODE)
                                  for r in active], 0.0, 0.0, 0, 0)
                _, rounds = ex.execute_multi(plan, world, 0.0, SPEC_ROUNDS,
                                             speculate=gamma)
                if ex.last_deferred:
                    raise AssertionError("pool sized to never defer")
                counts["accepted"] += ex.last_spec_accepted
                counts["drafted"] += ex.last_spec_drafted
                counts["spec"] += 1
                for em in rounds:
                    for rid, toks in em.items():
                        if toks:
                            world[rid].generated_tokens.extend(toks)
                            world[rid].advance(len(toks), 0.0)
            else:
                fixed_step(ex, world, list(world), chunk)
            for r in world.values():
                if not r.active:
                    ex.release(r.req_id)

    _, launches = _counted(cuda, loop)
    _check_pages(ex)
    return SpecRun({rid: list(r.generated_tokens) for rid, r in world.items()},
                   counts["accepted"], counts["drafted"], counts["spec"],
                   ex.n_dispatches - counts["spec"], launches, forwards)


def phase_moe_spec(cfg, device) -> list:
    """Phase 4h: ``cfg`` (mixtral-8x7b, every published width, depth cut)
    with the port's own weights (seed 1), 4 requests of 8-64 prompt tokens
    and 8 new tokens on fixed plans, γ=3 and 2 rounds a dispatch, under
    ``exact`` and ``capacity``, with a draft of one layer and one of every
    layer (the target's own tokens: drafts are accepted, so multi-token
    commits and the KV of kept verify rows run). Gates: card tokens and
    accept/draft counters = the CPU run's; the full-depth draft accepts;
    under exact the tokens = the card's non-speculative run on the same
    plans (the greedy stream; under capacity the verify pass packs
    B·(γ+1) rows, so capacity drops and the tokens may follow the packing:
    the share is reported); B3 launches rounds × (γ · draft layers +
    n_layers) a dispatch, B1 n_layers a fused step, B4 three per layer and
    router chunk of every forward pass under capacity and never under
    exact; no round waits for the device."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device)
    on_cpu = params_to(params, "cpu")
    reqs = lambda: make_requests(cfg, 4, (8, 64), 8, 0.0, seed=2)
    cuda = torch.device(device).type == "cuda"
    recs = []
    for impl, depth in itertools.product(("exact", "capacity"),
                                         (1, cfg.n_layers)):
        t0 = time.perf_counter()
        d = spec_plans_run(cfg, params, device, reqs(), moe_impl=impl,
                           gamma=SPEC_GAMMA, draft_layers=depth)
        if depth == 1:
            plain = spec_plans_run(cfg, params, device, reqs(),
                                   moe_impl=impl, gamma=0)
        c = spec_plans_run(cfg, on_cpu, "cpu", reqs(), moe_impl=impl,
                           gamma=SPEC_GAMMA, draft_layers=depth)
        per_dispatch = SPEC_ROUNDS * (SPEC_GAMMA * depth + cfg.n_layers)
        b4 = (sum(3 * layers * router_chunks(rows, cfg.moe)
                  for rows, layers in d.forwards)
              if impl == "capacity" else 0)
        want = {"paged_attention": per_dispatch * d.spec_dispatches,
                "paged_attention_ragged": cfg.n_layers * d.fused_dispatches,
                "moe_gmm": b4} if cuda else {}
        rec = {"model": cfg.name, "layers": cfg.n_layers, "moe_impl": impl,
               "draft_layers": depth,
               "gamma": SPEC_GAMMA, "rounds_per_dispatch": SPEC_ROUNDS,
               "reduced": [f"n_layers {get(cfg.name).n_layers} -> "
                           f"{cfg.n_layers}"],
               "tokens_equal_cpu": d.tokens == c.tokens,
               "counters": [d.accepted, d.drafted],
               "cpu_counters": [c.accepted, c.drafted],
               "tokens_equal_non_speculative": d.tokens == plain.tokens,
               "share_tokens_equal_non_speculative":
                   _share_equal(d.tokens, plain.tokens),
               "spec_dispatches": d.spec_dispatches,
               "fused_dispatches": d.fused_dispatches,
               "launches": d.launches, "expected_launches": want,
               "seconds": time.perf_counter() - t0}
        _emit("moe_spec_parity", rec)
        ok = (rec["tokens_equal_cpu"] and rec["counters"] ==
              rec["cpu_counters"] and d.spec_dispatches >= 1
              and d.drafted > 0 and (d.accepted > 0 or depth == 1)
              and all(d.launches[k] == n for k, n in want.items()))
        if impl == "exact":
            ok &= rec["tokens_equal_non_speculative"]
        if cuda and impl == "capacity":
            ok &= d.launches["moe_gmm"] > 0
        if not ok:
            raise AssertionError(f"MoE speculation ({impl}, draft of "
                                 f"{depth} layers): card, CPU, launches, "
                                 f"acceptance or stream disagree")
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# phases 4e, 4i, 5e, 5h, 5i: every decoder-only family through DecoderLM
# ---------------------------------------------------------------------------

# (arch, layers, batch, prompt tokens, moe_impl) of phases 4e (mamba2) and
# 4i: every family at full width, 4i's prompts past the flash threshold
# (1024) and, for gemma3, past its 512-token window into the banded path
DECODER_PARITY = (("mamba2-1.3b", 2, 2, 300, "capacity"),
                  ("zamba2-2.7b", 6, 1, 1024, "capacity"),
                  ("gemma3-1b", 6, 1, 1536, "capacity"),
                  # one layer (two until 4n gained its multi-step and
                  # speculative cases): the CPU reference's time
                  ("pixtral-12b", 1, 1, 1024, "capacity"),
                  ("deepseek-67b", 1, 1, 1024, "capacity"),
                  ("mixtral-8x7b", 1, 1, 1024, "capacity"),
                  ("mixtral-8x7b", 1, 1, 1024, "exact"),
                  ("stablelm-3b", 2, 1, 1024, "capacity"))


def _prompts(cfg, batch: int, prompt: int, seed: int) -> np.ndarray:
    """Token ids, or embeddings × 0.1 for a VLM backbone."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        return (rng.standard_normal((batch, prompt, cfg.d_model))
                * 0.1).astype(np.float32)
    return rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int64)


def _decoder_launches_ok(run: Generated, cfg, moe_impl: str,
                         cuda: bool) -> bool:
    """B5 once per Mamba2 block in the prefill and never in decode, B4
    in the prefill and in decode under capacity on a MoE model, no other
    kernel (on the CPU nothing launches)."""
    mamba = cfg.n_layers if cfg.ssm is not None and cuda else 0
    gmm = cfg.moe is not None and moe_impl == "capacity" and cuda
    ok = (run.prefill_launches["mamba2_scan"] == mamba
          and run.decode_launches["mamba2_scan"] == 0
          and (run.prefill_launches["moe_gmm"] > 0) == gmm
          and (run.decode_launches["moe_gmm"] > 0) == gmm)
    others = [n for n in KERNELS if n not in ("mamba2_scan", "moe_gmm")]
    return ok and all(run.prefill_launches[n] == run.decode_launches[n] == 0
                      for n in others)


def phase_decoder_parity(device, cases=DECODER_PARITY, steps=8) -> list:
    """Phases 4e (the SSM family, tagged ``ssm_parity``) and 4i: each
    case's config at full width with its depth cut, the port's own weights
    (seed 1), through ``DecoderLM.prefill`` and ``steps`` greedy
    ``decode_step``s on ``device`` and on the CPU. Gates: first logits
    within 1e-3, greedy tokens equal, the kernels each family runs
    launched as ``_decoder_launches_ok`` says."""
    cuda = torch.device(device).type == "cuda"
    recs = []
    for arch, layers, batch, prompt, impl in cases:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get(arch), n_layers=layers)
        opts = ModelOpts(moe_impl=impl)
        params = init_params(cfg, torch.Generator(
            device=device).manual_seed(1), device)
        prompts = _prompts(cfg, batch, prompt, seed=6)
        d = generate(cfg, params, device, prompts, steps, opts)
        c = generate(cfg, params_to(params, "cpu"), "cpu", prompts, steps,
                     opts)
        rec = {"model": cfg.name, "layers": layers, "batch": batch,
               "prompt_tokens": prompt, "decode_steps": steps,
               "moe_impl": impl if cfg.moe is not None else None,
               "input": "embeds" if cfg.embeds_input else "tokens",
               "reduced": [f"n_layers {get(arch).n_layers} -> {layers}"],
               "tokens_equal_cpu": bool(np.array_equal(d.tokens, c.tokens)),
               "first_logits_max_abs_err": float(
                   np.abs(d.first - c.first).max()),
               "prefill_launches": d.prefill_launches,
               "decode_launches": d.decode_launches,
               "seconds": time.perf_counter() - t0}
        if cfg.ssm is not None:
            rec["scan_shape"] = list(scan_shape(cfg, batch, prompt))
        _emit("ssm_parity" if cfg.family == "ssm" else "decoder_parity", rec)
        if (not rec["tokens_equal_cpu"]
                or rec["first_logits_max_abs_err"] > ATOL_LOGITS
                or not _decoder_launches_ok(d, cfg, impl, cuda)):
            raise AssertionError(f"{cfg.name} ({impl}): card and CPU "
                                 f"disagree, or the launches are wrong")
        recs.append(rec)
        del params, d, c
        if cuda:
            _release_memory()
    return recs


B5_KERNELS = ("chunk_prep_kernel", "chunk_state_kernel", "state_pass_kernel",
              "chunk_scan_kernel")


def prefill_device_ms(fn) -> dict:
    """Device ms of one call of ``fn`` (every kernel, copy and memset of
    its ``torch.profiler`` trace) and B5's four kernels' and B4's
    kernels' parts of it."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = pathlib.Path(__file__).resolve().parent / "build" / "profile" / \
        "decoder_prefill.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    total = sum(e["dur"] for e in events) / 1e3
    b5, b4 = (sum(e["dur"] for e in events
                  if any(k in e.get("name", "") for k in names)) / 1e3
              for names in (B5_KERNELS, B4_KERNELS))
    return {"device_ms": total, "b5_device_ms": b5,
            "b5_share": b5 / total if total else None, "b4_device_ms": b4,
            "b4_share": b4 / total if total else None}


def _ring_positions_ok(cfg, cache: dict, seen: int) -> bool:
    """Every attention cache holds the positions it must after ``seen``
    tokens: a shared block's (width ``seen``) all of 0..seen-1, a local
    layer's ring exactly the last ``window``, a global layer's all."""
    if cfg.family == "hybrid":
        kp = cache["attn"]["kv_pos"]
        return torch.equal(kp.sort(-1).values,
                           torch.arange(seen, device=kp.device,
                                        dtype=kp.dtype).expand_as(kp))
    ok = True
    kv = cache["kv"]      # stacked (one kv_pos) or one cache a layer
    for i, c in enumerate([kv] if isinstance(kv, dict) else kv):
        lo = seen - min(cfg.layer_window(i) or seen, seen)
        kp = c["kv_pos"]
        ok &= torch.equal(kp.sort(-1).values,
                          torch.arange(lo, seen, device=kp.device,
                                       dtype=kp.dtype).expand_as(kp))
    return bool(ok)


# (batch, prompt tokens, greedy decode steps) of phases 5h and 5i, and of
# phase 5e (mamba2-1.3b)
DECODER_SERVE = ((8, 2048, 64),)
SSM_SERVE = ((8, 2048, 64), (1, 32768, 16))


def phase_decoder_serve(cfg, device, workloads=DECODER_SERVE,
                        opts: Optional[ModelOpts] = None,
                        tag: Optional[str] = None) -> list:
    """Phases 5e (mamba2-1.3b, tagged ``ssm_serve``), 5h (zamba2-2.7b), 5i
    (gemma3-1b) and 5k (``opts`` the bf16 serving opts, tagged
    ``bf16_serve``): ``cfg`` at full depth and width with weights from
    seed 0 in ``opts``' parameter dtype (fp32 by default) through
    ``DecoderLM.prefill`` plus greedy ``decode_step``s, once per
    workload. Gates: every token in [0, vocab); the attention caches,
    where there are any, hold the positions ``_ring_positions_ok`` says;
    B5 launched n_layers times per prefill at a shape phase 3e checked,
    never in decode. Reports the serving numbers and the device ms of one
    more prefill by ``torch.profiler``, with B5's and B4's shares."""
    cuda = torch.device(device).type == "cuda"
    opts = opts or ModelOpts()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device, opts.param_dtype)
    scan_steps = {"ssm": SSM_STEPS, "hybrid": HYBRID_SSM_STEPS}.get(
        cfg.family, ())
    checked = {scan_shape(cfg, b, s) for _, b, s in scan_steps}
    recs = []
    for batch, prompt, steps in workloads:
        prompts = _prompts(cfg, batch, prompt, seed=5)
        if cuda:
            _release_memory()
            torch.cuda.reset_peak_memory_stats()
        run = generate(cfg, params, device, prompts, steps, opts)
        rings = (None if cfg.family == "ssm"
                 else _ring_positions_ok(cfg, run.cache, prompt + steps))
        n_out = run.tokens.size
        decode_s = sum(run.step_s)
        rec = {"model": cfg.name, "layers": cfg.n_layers, "batch": batch,
               "prompt_tokens": prompt, "decode_steps": steps,
               "param_dtype": str(opts.param_dtype),
               "prefill_s": run.prefill_s,
               "prefill_tok_per_s": batch * prompt / run.prefill_s,
               "decode_step_median_ms": statistics.median(run.step_s) * 1e3,
               "decode_tok_per_s": batch * steps / decode_s,
               "output_tokens": n_out,
               "output_tok_per_s": n_out / (run.prefill_s + decode_s),
               "weight_bytes": sum(t.numel() * t.element_size()
                                   for t in leaves(params)),
               "max_memory_allocated_bytes": (
                   torch.cuda.max_memory_allocated() if cuda else None),
               "ring_positions_ok": rings,
               "b5_prefill_launches": run.prefill_launches["mamba2_scan"],
               "b5_decode_launches": run.decode_launches["mamba2_scan"]}
        ok = (run.tokens.min() >= 0 and run.tokens.max() < cfg.vocab
              and run.tokens.shape == (batch, steps + 1)
              and rings is not False
              and _decoder_launches_ok(run, cfg, "capacity", cuda))
        if cfg.n_layers != get(cfg.name).n_layers:
            rec["reduced"] = [f"n_layers {get(cfg.name).n_layers} -> "
                              f"{cfg.n_layers}"]
        if cfg.ssm is not None:
            rec["scan_shape"] = list(scan_shape(cfg, batch, prompt))
            ok &= tuple(rec["scan_shape"]) in checked
        del run
        if cuda:
            _release_memory()
            model = DecoderLM(cfg, opts, device=device)
            x = torch.as_tensor(prompts, device=device)
            rec.update(prefill_device_ms(
                lambda: model.prefill(params, x, prompt + steps)))
            del model, x
        if tag is not None:
            rec["phase"] = tag
        _emit("bf16_serve" if tag == "5k" else "ssm_serve"
              if cfg.family == "ssm" else "decoder_serve", rec)
        if not ok:
            raise AssertionError(f"{cfg.name} B={batch} S={prompt}: bad "
                                 f"tokens, ring positions, launches or "
                                 f"scan shape")
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# phases 4f, 4g, 5f, 5g: the prefix cache, preemption and KV migration
# ---------------------------------------------------------------------------

def scenario_requests(cfg, name: str, *, rps: float, duration: float,
                      seed: int, n: int, new_tokens: int,
                      max_prompt: Optional[int] = None,
                      slo=(30.0, 2.0)) -> list:
    """The first ``n`` requests by arrival of a scenario trace, arriving as
    traced, with the trace's own token ids mod the vocabulary (prompts cut
    at ``max_prompt``)."""
    trace = sorted(make_scenario(name, rps=rps, duration=duration,
                                 seed=seed), key=lambda t: t.arrival)[:n]
    reqs = []
    for i, tr in enumerate(trace):
        toks = [t % cfg.vocab for t in tr.tokens[:max_prompt]]
        reqs.append(Request(i, arrival=tr.arrival, prompt_len=len(toks),
                            max_new_tokens=new_tokens, ttft_slo=slo[0],
                            tpot_slo=slo[1], tokens=toks))
    return reqs


def sysprompt_requests(cfg) -> list:
    """Phase 4f's traffic: 8 requests of a shared-sysprompt trace, 8 new
    tokens each, prompts cut at 640 tokens (the 512-token system prompt and
    up to 128 of the user's) so that the CPU's plain attention stays
    within seconds at full width."""
    return scenario_requests(cfg, "shared-sysprompt", rps=8.0, duration=2.0,
                             seed=0, n=8, new_tokens=8, max_prompt=640)


def _check_pages(ex, cache=None) -> None:
    """Allocator and radix invariants; once every request is done, only
    the trash page and the pages the cache holds are in use."""
    ex.alloc.check_invariants()
    held = 0
    if cache is not None and cache.enabled:
        cache.tree.check_invariants()
        held = cache.held_pages
    if ex.alloc.free_blocks + held != ex.alloc.num_blocks - 1:
        raise AssertionError("pages leaked")


CACHE_PARITY_PAGES = dict(page_size=16, num_pages=2048, max_pages_per_seq=200)
CACHE_PARITY_CAPACITY = 512


def preemption_pair(cfg, params, device, preempt: bool) -> dict:
    """tests/test_preemption.py's shared-prefix pair at ``cfg``'s width: X
    publishes a 64-token prefix, Y forks it through the cache; with
    ``preempt`` Y is evicted mid-decode (``Engine._preempt``) and resumes
    by recomputing its uncached tail. The engine runs on the model clock.
    Returns both streams and the preemption count."""
    rng = np.random.default_rng(11)
    shared = [int(x) for x in rng.integers(0, cfg.vocab, 64)]
    prompts = (shared + [1, 2, 3],
               shared + [int(x) for x in rng.integers(0, cfg.vocab, 12)])
    ex = PagedTransformerExecutor(cfg, params, num_pages=64, page_size=16,
                                  max_pages_per_seq=16, device=device)
    cache = PrefixCache(8, block_size=16, alloc=ex.alloc)
    ex.attach_cache(cache)
    eng = Engine(make_scheduler("fairbatching", MODEL_CLOCK,
                                calibrate=False),
                 ModelTimedExecutor(ex, MODEL_CLOCK),
                 EngineConfig(ttft_slo=5.0, tpot_slo=5.0, preemption=True,
                              defer_age=0.01), prefix_cache=cache)
    req = lambda i, now: Request(i, arrival=now, prompt_len=len(prompts[i]),
                                 max_new_tokens=16, ttft_slo=5.0,
                                 tpot_slo=5.0, tokens=list(prompts[i]))
    eng.submit(req(0, 0.0))
    while eng.requests.get(0) is None or \
            eng.requests[0].prefilled < len(prompts[0]):
        eng.step()
    eng.submit(req(1, eng.now))
    while eng.requests.get(1) is None or eng.requests[1].generated < 4:
        eng.step()
    x_table = list(ex.alloc.tables[0])
    shared_pages = [p for p in x_table if ex.alloc.refcount[p] > 1]
    if preempt:
        eng._preempt(eng.requests[1])
        if ex.alloc.tables[0] != x_table or not all(
                p in ex.alloc.refcount for p in shared_pages):
            raise AssertionError("eviction touched the survivor")
    eng.run(max_steps=3000)
    _check_pages(ex, cache)
    return {"tokens": [eng.requests[i].generated_tokens for i in (0, 1)],
            "preemptions": eng.preemptions,
            "shared_pages": len(shared_pages),
            "victim_cached_context": eng.requests[1].cached_context}


def phase_cache_parity(cfg, device) -> list:
    """Phase 4f: phase 4's model and weights serve 8 shared-sysprompt
    requests with a ``PrefixCache`` attached, on the model clock (so card
    and CPU make the same plans), in fp32 and int8; then the preemption
    pair."""
    cuda = torch.device(device).type == "cuda"
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    recs = []
    for kv in ("fp32", "int8"):
        runs = {}
        for dev in (device, "cpu"):
            runs[dev] = serve(cfg, params, dev, sysprompt_requests(cfg),
                              capture_logits=True, kv_dtype=kv,
                              clock=MODEL_CLOCK,
                              cache_pages=CACHE_PARITY_CAPACITY,
                              **CACHE_PARITY_PAGES)
            _check_pages(runs[dev].ex, runs[dev].eng.prefix_cache)
        d, c = runs[device], runs["cpu"]
        ref = {}
        for name, pages in (("no_cache", None), ("capacity_0", 0)):
            ref[name] = serve(cfg, params, device, sysprompt_requests(cfg),
                              kv_dtype=kv, clock=MODEL_CLOCK,
                              cache_pages=pages, **CACHE_PARITY_PAGES)
        err = max(float(np.abs(d.first[r] - c.first[r]).max())
                  for r in c.first)
        stats = d.eng.prefix_cache.stats
        quant = "paged_attention_ragged_quant"
        kern = quant if kv != "fp32" else "paged_attention_ragged"
        rec = {"kv_dtype": kv, "requests": len(d.tokens),
               "prompt_tokens": sum(r.prompt_len
                                    for r in d.eng.requests.values()),
               "tokens_equal_cpu": d.tokens == c.tokens,
               "first_logits_max_abs_err": err,
               "cached_tokens": stats.hit_tokens,
               "cached_tokens_cpu": c.eng.prefix_cache.stats.hit_tokens,
               "hit_requests": stats.hit_requests,
               "evicted_pages": stats.evicted_pages,
               "capacity_0_tokens_equal_no_cache":
                   ref["capacity_0"].tokens == ref["no_cache"].tokens,
               "share_tokens_equal_no_cache": _share_equal(
                   d.tokens, ref["no_cache"].tokens),
               "dispatches": d.ex.n_dispatches, "launches": d.launches,
               "expected_launches": cfg.n_layers * d.ex.n_dispatches}
        _emit("cache_parity", rec)
        recs.append(rec)
        ok = (rec["tokens_equal_cpu"] and d.first.keys() == c.first.keys()
              and 0 < rec["cached_tokens"] == rec["cached_tokens_cpu"]
              and rec["capacity_0_tokens_equal_no_cache"]
              and d.launches[kern] == rec["expected_launches"])
        if kv == "fp32":
            ok &= err <= ATOL_LOGITS
        if not ok:
            raise AssertionError(f"cache parity {kv}: card, CPU and the "
                                 f"no-cache runs disagree")
        del runs, d, c, ref
    dparams = params_to(params, device)
    (plain, with_preempt), launches = _counted(cuda, lambda: (
        preemption_pair(cfg, dparams, device, False),
        preemption_pair(cfg, dparams, device, True)))
    rec = {"preemptions": with_preempt["preemptions"],
           "shared_pages": with_preempt["shared_pages"],
           "victim_cached_context": with_preempt["victim_cached_context"],
           "survivor_tokens_equal": with_preempt["tokens"][0]
           == plain["tokens"][0],
           "victim_tokens_equal": with_preempt["tokens"][1]
           == plain["tokens"][1], "launches": launches}
    _emit("preemption_parity", rec)
    recs.append(rec)
    if (rec["preemptions"] < 1 or plain["preemptions"] != 0
            or rec["shared_pages"] == 0 or not rec["survivor_tokens_equal"]):
        raise AssertionError("preemption pair: no preemption, or the "
                             "survivor's stream changed")
    return recs


def fixed_step(ex, requests: dict, owned, chunk: int) -> int:
    """One teacher-forced step over the active requests in ``owned``: a
    decode token each, or a prefill chunk of up to ``chunk`` tokens (the
    plans depend on nothing the device computes). Returns the items run."""
    items = []
    for rid in owned:
        r = requests[rid]
        if not r.active:
            continue
        if r.state is RequestState.DECODE:
            items.append(BatchItem(rid, 1, TaskKind.DECODE))
        else:
            items.append(BatchItem(rid, min(chunk, r.prompt_len - r.prefilled),
                                   TaskKind.PREFILL))
    if not items:
        return 0
    plan = BatchPlan(items, 0.0, 0.0, 0, 0)
    _, emitted = ex.execute(plan, requests, 0.0)
    if ex.last_deferred:
        raise AssertionError("pool sized to never defer")
    for it in plan.items:
        req = requests[it.req_id]
        if it.req_id in emitted:
            req.generated_tokens.append(emitted[it.req_id])
        req.advance(it.n_tokens, 0.0)
    return len(items)


def never_migrated(ex, requests: list, chunk: int) -> dict:
    """The single-executor run on fixed plans: the migration oracle."""
    world = {r.req_id: r for r in requests}
    while fixed_step(ex, world, list(world), chunk):
        pass
    for rid in world:
        ex.release(rid)
    _check_pages(ex)
    return {rid: list(r.generated_tokens) for rid, r in world.items()}


def payload_bytes(payload, first_page: int = 0) -> int:
    return sum(a[:, first_page:].nbytes for a in (
        payload.k, payload.v, payload.k_scales, payload.v_scales)
        if a is not None)


def installed_equal(ex, rid: int, payload, nref: int) -> bool:
    """The pages (and scale pages) ``install_kv_pages`` materialized equal
    the captured payload byte for byte; the ``nref`` leading ones are the
    destination's cached pages, shared, not copied."""
    tbl = ex.alloc.tables[rid]
    if len(tbl) != payload.n_pages or ex.alloc.lens[rid] != payload.n_tokens:
        return False
    ok = all(ex.alloc.refcount[p] >= 2 for p in tbl[:nref])
    idx = torch.as_tensor(tbl[nref:], device=ex.device)
    for pool, rows in ((ex.k_pages, payload.k), (ex.v_pages, payload.v)):
        ok &= np.array_equal(raw_pool(pool)[:, idx].cpu().numpy(),
                             rows[:, nref:])
    if payload.k_scales is not None:
        sidx = torch.as_tensor(ex.alloc.scale_table(rid)[nref:],
                               device=ex.device)
        for pool, rows in ((ex.k_scales, payload.k_scales),
                           (ex.v_scales, payload.v_scales)):
            ok &= np.array_equal(pool[:, sidx].cpu().numpy(), rows[:, nref:])
    return bool(ok)


def migrating_run(src, dst, requests: list, migrate_at: dict, chunk: int, *,
                  recompute=(), cache=None, timed=False) -> dict:
    """Drive on ``src``; when a request reaches its ``migrate_at`` decode
    count move it to ``dst`` (by recompute for those in ``recompute``, else
    capture → release → install); finish there. Returns the streams and a
    record per move (pages bitwise equal after install, reference pages,
    bytes; with ``timed`` the capture and install times, each between two
    synchronizations)."""
    world = {r.req_id: r for r in requests}
    owner = {rid: "src" for rid in world}
    moves = []

    def synced():
        if timed:
            torch.cuda.synchronize()
        return time.perf_counter()

    while any(r.active for r in world.values()):
        for side, ex in (("src", src), ("dst", dst)):
            fixed_step(ex, world, [r for r, o in owner.items() if o == side],
                       chunk)
        for rid, r in world.items():
            if (owner[rid] != "src" or not r.active
                    or r.state is not RequestState.DECODE
                    or r.generated < migrate_at[rid]):
                continue
            owner[rid] = "dst"
            if rid in recompute:
                src.release(rid)
                r.preempt_requeue()
                moves.append({"req": rid, "mode": "recompute"})
                continue
            t0 = synced()
            payload = capture_kv(src, rid)
            t1 = synced()
            src.release(rid)
            t2 = synced()
            nref = install_kv_pages(dst, cache, r, payload, 0.0)
            t3 = synced()
            if nref is None:
                raise AssertionError("destination sized to host the table")
            move = {"req": rid, "mode": "kv", "pages": payload.n_pages,
                    "tokens": payload.n_tokens, "ref_pages": nref,
                    "bytes": payload_bytes(payload),
                    "wire_bytes": payload_bytes(payload, nref),
                    "pages_equal": installed_equal(dst, rid, payload, nref)}
            if timed:
                move.update(capture_ms=(t1 - t0) * 1e3,
                            install_ms=(t3 - t2) * 1e3,
                            d2h_gb_per_s=move["bytes"] / (t1 - t0) / 1e9,
                            h2d_gb_per_s=move["wire_bytes"] / (t3 - t2)
                            / 1e9)
            moves.append(move)
            src.alloc.check_invariants()
            dst.alloc.check_invariants()
    for rid, o in owner.items():
        (src if o == "src" else dst).release(rid)
        if cache is not None and o == "dst":
            cache.end_request(rid)
    _check_pages(src)
    _check_pages(dst, cache)
    return {"tokens": {rid: list(r.generated_tokens)
                       for rid, r in world.items()}, "moves": moves}


MIGRATION_CHUNK = 64
MIGRATION_PAGES = dict(page_size=16, num_pages=256, max_pages_per_seq=32)


def phase_migration_parity(cfg, device) -> list:
    """Phase 4g: phase 4's model and weights, two executors on ``device``
    sharing one set of weights, fixed plans. Four requests move by KV at
    decode counts 1, 3, 5 and 2, one of them instead by recompute; then
    two requests behind a shared 32-token prefix move into a destination
    whose cache already holds request 0's prompt, its leading blocks by
    reference. fp32 and int8 (scale ids permuted on both sides)."""
    cuda = torch.device(device).type == "cuda"
    params = params_to(init_params(cfg, torch.Generator().manual_seed(1),
                                   "cpu"), device)
    make = lambda kv: PagedTransformerExecutor(
        cfg, params, kv_dtype=kv, device=device, **MIGRATION_PAGES)
    page = MIGRATION_PAGES["page_size"]
    rng = np.random.default_rng(2)
    prefix = [int(x) for x in rng.integers(0, cfg.vocab, 2 * page)]

    def four():
        return make_requests(cfg, 4, (40, 200), 8, 0.0, seed=4)

    def pair():
        reqs = make_requests(cfg, 2, (20, 40), 6, 0.0, seed=6)
        for r in reqs:
            r.tokens = prefix + [(100 + r.req_id) % cfg.vocab] + r.tokens
            r.prompt_len = len(r.tokens)
        return reqs

    recs = []
    for kv in ("fp32", "int8"):
        def run():
            oracle = never_migrated(make(kv), four(), MIGRATION_CHUNK)
            src, dst = make(kv), make(kv)
            if kv != "fp32":
                for ex, seed in ((src, 1), (dst, 2)):
                    np.random.default_rng(seed).shuffle(ex.alloc._free_scales)
            moved = migrating_run(src, dst, four(), {0: 1, 1: 3, 2: 5, 3: 2},
                                  MIGRATION_CHUNK, recompute={3})
            pair_oracle = never_migrated(make(kv), pair(), MIGRATION_CHUNK)
            dst = make(kv)
            cache = PrefixCache(32, block_size=page, alloc=dst.alloc)
            dst.attach_cache(cache)
            warm = pair()[0]
            warm.req_id = 10_000
            world = {warm.req_id: warm}
            while fixed_step(dst, world, list(world), MIGRATION_CHUNK):
                pass
            cache.insert_request(warm.req_id, warm.tokens, 0.0)
            cache.end_request(warm.req_id)
            dst.release(warm.req_id)
            reqs = pair()
            by_ref = migrating_run(make(kv), dst, reqs, {0: 2, 1: 4},
                                   MIGRATION_CHUNK, cache=cache)
            return oracle, moved, pair_oracle, by_ref, reqs

        (oracle, moved, pair_oracle, by_ref, reqs), launches = _counted(
            cuda, run)
        kv_moves = [m for m in moved["moves"] + by_ref["moves"]
                    if m["mode"] == "kv"]
        want_ref = [reqs[0].prompt_len // page, len(prefix) // page]
        got_ref = [m["ref_pages"] for m in by_ref["moves"]]
        per_page = kv_moves[0]["bytes"] // kv_moves[0]["pages"]
        rec = {"kv_dtype": kv, "moves": len(moved["moves"]
                                            + by_ref["moves"]),
               "streams_equal": moved["tokens"] == oracle,
               "by_reference_streams_equal": by_ref["tokens"] == pair_oracle,
               "pages_equal": all(m["pages_equal"] for m in kv_moves),
               "ref_pages": got_ref, "expected_ref_pages": want_ref,
               "payload_bytes": [m["bytes"] for m in by_ref["moves"]],
               "wire_bytes": [m["wire_bytes"] for m in by_ref["moves"]],
               "launches": launches}
        _emit("migration_parity", rec)
        recs.append(rec)
        ok = (rec["streams_equal"] and rec["by_reference_streams_equal"]
              and rec["pages_equal"] and got_ref == want_ref
              # the leading blocks moved by reference: 0 bytes copied
              and all(m["wire_bytes"] == (m["pages"] - m["ref_pages"])
                      * per_page for m in by_ref["moves"]))
        if not ok:
            raise AssertionError(f"migration parity {kv}: streams, pages or "
                                 f"reference transfers disagree")
    return recs


CACHED_SERVE_CAPACITY = 512
# 5f (iii): 168 pages make preemption fire on the model clock; at 160 and
# fewer the engine stops on its KV-deadlock error (ROADMAP §C), at 176 and
# more nothing is deferred
PREEMPT_SERVE_PAGES = dict(SERVE_PAGES, num_pages=168)


def cached_serve_requests(cfg) -> list:
    """Phase 5f's traffic: the first 64 requests of a shared-sysprompt
    trace, prompts cut at 3072 tokens, 32 new tokens, arriving as traced."""
    return scenario_requests(cfg, "shared-sysprompt", rps=8.0, duration=8.0,
                             seed=3, n=64, new_tokens=32, max_prompt=3072,
                             slo=(10.0, 0.25))


def phase_cached_serve(cfg, device, params) -> list:
    """Phase 5f: the full-depth model serves 5f's traffic with no cache,
    with a 512-page ``PrefixCache``, and with the cache and preemption on a
    pool cut to 168 pages. The third run is on the model clock: its plans,
    and so its preemptions, then depend on nothing the device does."""
    cuda = torch.device(device).type == "cuda"
    workloads = [("no_cache", SERVE_PAGES, {}),
                 ("cache", SERVE_PAGES,
                  dict(cache_pages=CACHED_SERVE_CAPACITY)),
                 ("cache_preemption", PREEMPT_SERVE_PAGES,
                  dict(cache_pages=CACHED_SERVE_CAPACITY, preemption=True,
                       clock=MODEL_CLOCK))]
    recs, base = [], None
    for name, pages, kw in workloads:
        if cuda:
            _release_memory()
            torch.cuda.reset_peak_memory_stats()
        reqs = cached_serve_requests(cfg)
        run = serve(cfg, params, device, reqs, **pages, **kw)
        _check_outputs(run, cfg, 32)
        cache = run.eng.prefix_cache
        _check_pages(run.ex, cache)
        rec = {"workload": name, **_serve_record(run, reqs, cfg, cuda),
               "num_pages": pages["num_pages"],
               "attention_launches": run.launches["paged_attention_ragged"],
               "expected_attention_launches": cfg.n_layers
               * run.ex.n_dispatches,
               "preemptions": run.eng.preemptions,
               "defer_events": run.eng.defer_events,
               "clock": "model" if "clock" in kw else "wall"}
        if cache is not None:
            rec.update(cached_tokens=cache.stats.hit_tokens,
                       hit_rate=cache.stats.hit_rate,
                       hit_requests=cache.stats.hit_requests,
                       evicted_pages=cache.stats.evicted_pages)
        if base is None:
            base = run.tokens
        else:
            rec["share_tokens_equal_no_cache"] = _share_equal(run.tokens,
                                                              base)
        _emit("cached_serve", rec)
        recs.append(rec)
        if (rec["attention_launches"] != rec["expected_attention_launches"]
                or (cache is not None and rec["cached_tokens"] == 0)
                or (kw.get("preemption") and rec["preemptions"] == 0)):
            raise AssertionError(f"{name}: launches, cache hits or "
                                 f"preemptions missing")
        del run
    return recs


MIGRATE_SERVE_PAGES = dict(SERVE_PAGES, num_pages=512)
MIGRATE_SERVE_CHUNK = 512


def phase_migrate_serve(cfg, device, params) -> list:
    """Phase 5g: phase 5's 16 prompts (256-3072 tokens, 32 new tokens) run
    on a source executor for their prefill and 4 decode steps (5 tokens),
    move by KV to a second executor on the card (the same weights, 512
    pages each), which runs the other 27 steps; fp32 and int8, fixed
    plans. Every installed page equals the payload byte for byte; every
    request finishes. Reports each move's capture and install times, bytes
    and rates, and the share of tokens equal to a never-migrated run."""
    cuda = torch.device(device).type == "cuda"
    make = lambda kv: PagedTransformerExecutor(
        cfg, params, kv_dtype=kv, device=device, **MIGRATE_SERVE_PAGES)
    reqs = lambda: make_requests(cfg, 16, (256, 3072), 32, 0.0, seed=3,
                                 slo=(10.0, 0.25))
    recs = []
    for kv in ("fp32", "int8"):
        if cuda:
            _release_memory()
        oracle, launches_ref = _counted(cuda, lambda: never_migrated(
            make(kv), reqs(), MIGRATE_SERVE_CHUNK))
        if cuda:
            _release_memory()
            torch.cuda.reset_peak_memory_stats()
        src, dst = make(kv), make(kv)
        moved, launches = _counted(cuda, lambda: migrating_run(
            src, dst, reqs(), {i: 5 for i in range(16)}, MIGRATE_SERVE_CHUNK,
            timed=cuda))
        del src, dst
        finished = all(len(t) == 32 and all(0 <= x < cfg.vocab for x in t)
                       for t in moved["tokens"].values())
        moves = moved["moves"]
        for m in moves:
            _emit("migrate_serve_move", {"kv_dtype": kv, **m})
        rec = {"kv_dtype": kv, "moves": len(moves),
               "pages_equal": all(m["pages_equal"] for m in moves),
               "finished": finished,
               "bytes": sum(m["bytes"] for m in moves),
               "share_tokens_equal_never_migrated": _share_equal(
                   moved["tokens"], oracle),
               "launches": launches, "oracle_launches": launches_ref,
               "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated()
                                              if cuda else None)}
        if cuda:
            for key in ("capture_ms", "install_ms", "d2h_gb_per_s",
                        "h2d_gb_per_s"):
                rec[key + "_median"] = statistics.median(m[key]
                                                         for m in moves)
        _emit("migrate_serve", rec)
        recs.append(rec)
        if not (rec["pages_equal"] and finished and len(moves) == 16):
            raise AssertionError(f"migrate serve {kv}: pages differ after "
                                 f"install, or a request did not finish")
    return recs


# ---------------------------------------------------------------------------
# phases 3i, 4n, 5l: the sharded data plane (tensor and expert parallel)
# ---------------------------------------------------------------------------

# (TP, H, Hkv) of h2o-danube-1.8b's attention on one rank
SHARD_HEADS = ((2, 16, 4), (4, 8, 2))
EP_EXPERTS = 4                   # mixtral-8x7b's experts a rank at TP 2


@contextlib.contextmanager
def attention_heads(h: int, hkv: int):
    """Phase 3's steps at ``h`` query and ``hkv`` KV heads."""
    global H, HKV
    old = H, HKV
    H, HKV = h, hkv
    try:
        yield
    finally:
        H, HKV = old


def phase_shard_kernels(device, timer) -> list:
    """Phase 3i, attention: B1 on steps (a) and (b), B2 in int8 on step
    (a) and B3 on step (d), pages of 128, at h2o-danube-1.8b's heads a
    rank at TP 2 (H 16, Hkv 4) and TP 4 (H 8, Hkv 2), with phase 3's, 3c's
    and 3b's gates and timing."""
    recs = []
    for tp, h, hkv in SHARD_HEADS:
        with attention_heads(h, hkv):
            bst = make_bstep("d_decode", 128, device)
            rec = {"kernel": "paged_attention", "tp": tp, "H": h,
                   "HKV": hkv, **check_bkernel(bst, timer)}
            _emit("shard_kernel_step", rec)
            recs.append(rec)
            del bst
            for kind in ("a_mixed", "b_decode"):
                st = make_step(kind, 128, device)
                checks = [("paged_attention_ragged",
                           lambda: check_kernel(st, timer, timed=True))]
                if kind == "a_mixed":
                    checks.append(("paged_attention_ragged_quant",
                                   lambda: check_quant_kernel(st, "int8",
                                                              timer)))
                for name, check in checks:
                    rec = {"kernel": name, "tp": tp, "H": h, "HKV": hkv,
                           **check()}
                    _emit("shard_kernel_step", rec)
                    recs.append(rec)
                del st
                if torch.device(device).type == "cuda":
                    torch.cuda.empty_cache()
    return recs


def shard_moe_steps(by_capacity: dict, cfg) -> list:
    """Phase 3i, B4: mixtral-8x7b's gate/up and down GEMMs at E = 4 (its
    experts on one rank at TP 2), at C = 8 and at the largest capacity
    phase 5d launched B4 at."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    steps = []
    for c in sorted({8, max(by_capacity)}):
        steps += [(f"ep2_c{c}_gate_up", EP_EXPERTS, c, d, f),
                  (f"ep2_c{c}_down", EP_EXPERTS, c, f, d)]
    return steps


TP_PARITY_LAYERS = 2             # 4n's depth (of 24 and 32)
TP_SPEC_GAMMA = 2                # 4n's speculative cases: γ, 2 rounds
TP_SERVE_LAYERS = 4              # 5l's depth (of 24): gloo's host trips
TP_SERVE = dict(n=16, prompt_range=(256, 3072), new_tokens=32, gap=0.05,
                seed=3, slo=(10.0, 0.25))      # serve-16's traffic (5l)
TP_PARITY_REQUESTS = dict(n=6, prompt_range=(8, 64), new_tokens=8, gap=0.01,
                          seed=2, slo=(30.0, 2.0))   # phase 4's


def tp_requests(cfg, spec: dict) -> list:
    return make_requests(cfg, spec["n"], spec["prompt_range"],
                         spec["new_tokens"], spec["gap"], spec["seed"],
                         slo=spec["slo"])


# the step bodies of a dispatch, by the kind a dispatch log names it
STEP_BODIES = {"_fused_step": "fused", "_chunk_step": "chunk",
               "_decode_step": "decode", "_multi_decode_step": "multi",
               "_spec_multi_step": "spec"}


def _log_dispatches(ex, log: list) -> None:
    """Wrap a sharded executor's step bodies: each dispatch appends
    (kind, key, its all-reduces, its launches by kernel) to ``log``; the
    key is a ``multi``'s horizon and a ``spec``'s (rounds, γ)."""
    for name, kind in STEP_BODIES.items():
        def run(*a, _body=getattr(ex, name), _kind=kind, **kw):
            n0 = ex.tp.all_reduces
            l0 = {n: k.launches for n, k in KERNELS.items()}
            out = _body(*a, **kw)
            key = (a[1:] if _kind == "multi" else
                   (kw["rounds"], kw["gamma"]) if _kind == "spec" else ())
            log.append((_kind, tuple(key), ex.tp.all_reduces - n0,
                        {n: k.launches - l0[n] for n, k in KERNELS.items()}))
            return out
        setattr(ex, name, run)


def _dispatch_passes(kind: str, key: tuple, layers: int,
                     draft_layers: int) -> list:
    """The layers of each forward pass a dispatch runs: one pass, a
    committed horizon's, or per speculative round γ draft passes and the
    verify pass."""
    if kind == "multi":
        return [layers] * key[0]
    if kind == "spec":
        return ([draft_layers] * key[1] + [layers]) * key[0]
    return [layers]


def _tp_case(rank: int, mesh, case: dict) -> dict:
    """One case on one rank: rank 0 serves ``case``'s requests through
    ``serve`` on the sharded executor and stops the others, which replay
    its dispatches (``serve_worker``). A case with ``horizon`` or
    ``gamma`` (a ``TruncatedSelfDraft`` of ``draft_layers``, installed on
    every rank) logs each rank's dispatches. Returns the rank's record."""
    cfg, device = case["cfg"], case["device"]
    cuda = torch.device(device).type == "cuda"
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        case["seed"]), device)
    opts = dict(kv_dtype=case["kv_dtype"], moe_impl=case["moe_impl"],
                mode=case["mode"], **case["pages"])
    timing = {"all_reduce_s": 0.0, "broadcast_s": 0.0}

    def timed(ex):
        """Time every collective (device synchronised either side)."""
        for name in ("all_reduce", "broadcast"):
            fn = getattr(ex.tp, name)

            def run(*a, _fn=fn, _key=f"{name}_s"):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a)
                if cuda:
                    torch.cuda.synchronize()
                timing[_key] += time.perf_counter() - t0
                return out
            setattr(ex.tp, name, run)

    rec = {"rank": rank, "tp": mesh.shape["model"],
           "backend": dist.get_backend(), "model": cfg.name,
           "layers": cfg.n_layers, "kv_dtype": case["kv_dtype"],
           "moe_impl": case["moe_impl"], "mode": case["mode"]}
    logits = {}
    decode = {"horizon": case.get("horizon", 1), "gamma": case.get("gamma",
                                                                    0)}
    log = None if decode == {"horizon": 1, "gamma": 0} else []

    def draft():
        n = case.get("draft_layers")
        return None if n is None else TruncatedSelfDraft(n)

    def on_executor(ex):
        if log is not None:
            _log_dispatches(ex, log)
        if case.get("timed"):
            timed(ex)
    if rank == 0:
        clock = MODEL_CLOCK if case["model_clock"] else None
        reqs = tp_requests(cfg, case["requests"])
        if case.get("single_too"):
            # TP 1: the mesh=None executor on the same weights and plans,
            # every dispatch's logits kept
            for key, m in (("single", None), ("mesh", mesh)):
                out = logits.setdefault(key, [])

                def keep(ex, _out=out):
                    step = ex._fused_step
                    ex._fused_step = lambda st, t: (
                        lambda lg: (_out.append(lg.cpu()), lg)[1])(
                            step(st, t))
                run = serve(cfg, params, device, tp_requests(
                    cfg, case["requests"]), clock=clock, mesh=m,
                    on_executor=keep, check_sync=False, **opts)
                if m is not None:
                    run.ex.stop_workers()
        else:
            # gloo takes CUDA tensors through the host: no sync check
            run = serve(cfg, params, device, reqs, clock=clock, mesh=mesh,
                        cost_shards=case["cost_shards"],
                        on_executor=on_executor, draft=draft(),
                        check_sync=log is None, **decode, **opts)
            run.ex.stop_workers()
        del params
        ex = run.ex
        launches = run.launches
        rec.update(tokens=run.tokens, trace=run.trace,
                   vtc=vtc_counters(run.eng), steps=len(run.eng.steps),
                   spec=(run.eng.spec_rounds, run.eng.spec_accepted,
                         run.eng.spec_drafted))
        if case.get("serve_record"):
            _check_outputs(run, cfg, case["requests"]["new_tokens"])
            rec["serve"] = _serve_record(run, reqs, cfg, cuda)
    else:
        ex = PagedTransformerExecutor(cfg, params, mesh=mesh, device=device,
                                      **opts)
        del params
        if case.get("draft_layers") is not None:
            ex.set_draft(draft())
        if log is not None:
            _log_dispatches(ex, log)
        for k in KERNELS.values():
            k.launches = 0
        ex.serve_worker()
        launches = {name: k.launches for name, k in KERNELS.items()}
    rec.update(dispatches=ex.n_dispatches, all_reduces=ex.tp.all_reduces,
               kv_heads_a_rank=ex.k_pages.shape[3], launches=launches,
               free_blocks=ex.alloc.free_blocks, **timing)
    if log is not None:
        rec["log"] = log
        rec["derived_all_reduces"] = [ex.tp.reduces_per_dispatch(
            cfg.n_layers, steps=key[0] if key else 1,
            gamma=key[1] if kind == "spec" else 0,
            draft_layers=case.get("draft_layers"))
            for kind, key, _, _ in log]
    if logits:
        a, b = logits["single"], logits["mesh"]
        rec["logits_bitwise"] = len(a) == len(b) > 0 and all(
            torch.equal(x, y) for x, y in zip(a, b))
        rec["logits_dispatches"] = len(b)
    del ex
    if cuda:
        _release_memory()
    return rec


def tp_rank(rank: int, world: int, cases: list) -> list:
    """One rank of phases 4n and 5l, in a process of its own
    (``launch.mesh.spawn``): every case on a 1 × ``world`` mesh. All ranks
    share ``cuda:0`` on a one-card machine (gloo); under NCCL on several
    cards rank r takes ``cuda:r``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_test_mesh(data=1, model=world)
    return [_tp_case(rank, mesh, case) for case in cases]


def tp_cases(device, h2o, mix) -> dict:
    """Phase 4n's and 5l's cases by spawn: (world, backend) → cases."""
    pages = dict(PARITY_PAGES)
    small = dataclasses.replace(h2o, n_layers=TP_PARITY_LAYERS)
    mix2 = dataclasses.replace(mix, n_layers=TP_PARITY_LAYERS)

    def case(cfg, tp, kv="fp32", impl="exact", **kw):
        return {"cfg": cfg, "device": device, "seed": 1, "kv_dtype": kv,
                "moe_impl": impl, "pages": pages, "model_clock": True,
                "cost_shards": tp, "requests": TP_PARITY_REQUESTS,
                "mode": "fused", **kw}
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    return {
        (2, "gloo"): [case(small, 2), case(small, 2, "int8"),
                      case(small, 2, mode="sequential"),
                      case(mix2, 2), case(mix2, 2, impl="capacity"),
                      case(small, 2, horizon=4),
                      case(small, 2, "int8", horizon=4),
                      case(small, 2, horizon=2, gamma=TP_SPEC_GAMMA,
                           draft_layers=1),
                      case(dataclasses.replace(h2o,
                                               n_layers=TP_SERVE_LAYERS),
                           2, pages=SERVE_PAGES, model_clock=False,
                           requests=TP_SERVE, seed=0, serve_record=True,
                           timed=True)],
        (4, "gloo"): [case(small, 4), case(small, 4, "int8"),
                      case(small, 4, horizon=4)],
        (1, backend): [case(small, 1, single_too=True)]}


def _decode_opts(c: dict) -> dict:
    """A 4n case's committed horizon, γ and self-draft depth."""
    return {"horizon": c.get("horizon", 1), "gamma": c.get("gamma", 0),
            "draft_layers": c.get("draft_layers")}


def _ref_key(c: dict) -> tuple:
    return (c["cfg"].name, c["cfg"].n_layers, c["kv_dtype"], c["moe_impl"],
            *_decode_opts(c).values())


def _tp_references(device, cases: dict) -> dict:
    """4n's single-device references on the model clock, by (model,
    layers, kv, impl, horizon, γ, draft layers): sequential (dense, MoE
    exact) or fused (capacity; and a multi-step or speculative case, with
    its horizon and draft) runs' tokens, decisions, VTC and speculative
    counters and mode, their executors freed."""
    refs = {}
    for cs in cases.values():
        for c in cs:
            key = _ref_key(c)
            if c.get("serve_record") or c.get("single_too") or key in refs:
                continue
            params = init_params(c["cfg"], torch.Generator(
                device=device).manual_seed(c["seed"]), device)
            dec = _decode_opts(c)
            mode = ("fused" if c["moe_impl"] == "capacity"
                    or dec["horizon"] > 1 or dec["gamma"] else "sequential")
            n = dec.pop("draft_layers")
            run = serve(c["cfg"], params, device,
                        tp_requests(c["cfg"], c["requests"]), mode=mode,
                        clock=MODEL_CLOCK, kv_dtype=c["kv_dtype"],
                        moe_impl=c["moe_impl"],
                        draft=None if n is None else TruncatedSelfDraft(n),
                        **dec, **c["pages"])
            refs[key] = {"tokens": run.tokens, "trace": run.trace,
                         "vtc": vtc_counters(run.eng), "mode": mode,
                         "spec": (run.eng.spec_rounds,
                                  run.eng.spec_accepted,
                                  run.eng.spec_drafted)}
            del params, run
            if torch.device(device).type == "cuda":
                _release_memory()
    return refs


ATTENTION = ("paged_attention_ragged", "paged_attention",
             "paged_attention_ragged_quant")


def _tp_decode_gates(c: dict, ranks: list, cuda: bool) -> tuple:
    """4n's multi-step and speculative cases, from each rank's dispatch
    log: every rank ran rank 0's dispatches in order, the case's path
    among them; each dispatch ran 2·layers + 2 all-reduces a forward pass
    (``reduces_per_dispatch`` agreeing) and, on the card, one attention
    launch a layer of each pass (B1 for a fused step, B3 for a batched
    pass, B2 for both in int8) and no other; no page leaked on any rank.
    Returns (the record's fields, whether every gate held)."""
    dec = _decode_opts(c)
    layers, n = c["cfg"].n_layers, dec["draft_layers"] or 0
    kinds = [(k, key) for k, key, _, _ in ranks[0]["log"]]
    path = "spec" if dec["gamma"] else "multi"
    ok = any(k == path for k, _ in kinds)
    b3, b3_want, ar_want = [], [], []
    for r in ranks:
        ok &= ([(k, key) for k, key, _, _ in r["log"]] == kinds
               and r["dispatches"] == len(r["log"])
               and r["free_blocks"] == c["pages"]["num_pages"] - 1
               and r["all_reduces"] == sum(a for _, _, a, _ in r["log"]))
        b3.append(sum(lc["paged_attention"] for *_, lc in r["log"]))
        want_b3 = want_ar = 0
        for (kind, key, ar, lc), derived in zip(r["log"],
                                                r["derived_all_reduces"]):
            passes = _dispatch_passes(kind, key, layers, n)
            want_ar += sum(2 * p + 2 for p in passes)
            ok &= ar == derived == sum(2 * p + 2 for p in passes)
            attn = ("paged_attention_ragged_quant" if c["kv_dtype"] != "fp32"
                    else "paged_attention_ragged" if kind == "fused"
                    else "paged_attention")
            if attn == "paged_attention":
                want_b3 += sum(passes)
            ok &= all(lc[a] == (sum(passes) if cuda and a == attn else 0)
                      for a in ATTENTION)
        b3_want.append(want_b3 if cuda else 0)
        ar_want.append(want_ar)
    return {**dec, "path": path,
            "path_dispatches": sum(k == path for k, _ in kinds),
            "all_reduces_derived": ar_want, "b3_launches": b3,
            "b3_launches_derived": b3_want,
            "free_blocks": [r["free_blocks"] for r in ranks]}, ok


def phase_tp(device, h2o, mix) -> dict:
    """Phases 4n and 5l. Spawns the TP 2 and TP 4 ranks on gloo (and TP 1
    on NCCL on the card) and holds their runs to the single-device ones:
    tokens, decisions (plans, deferrals, VTC) byte-equal to TP 1, one
    dispatch a step in fused mode, 2·L + 2 all-reduces a dispatch on every
    rank, and on every rank L attention launches (B1, B2 in int8, B3 in
    sequential mode) a dispatch; the multi-step and speculative cases by
    their dispatch logs (``_tp_decode_gates``), with the speculative
    counters equal to TP 1's too. Adds every rank's launches to the
    serving counts. Returns 5l's record."""
    cases = tp_cases(device, h2o, mix)
    refs = _tp_references(device, cases)
    cuda = torch.device(device).type == "cuda"
    serve_rec = None
    for (world, backend), cs in cases.items():
        t0 = time.perf_counter()
        per_rank = spawn(tp_rank, world, backend, cs, timeout=900)
        spawn_s = time.perf_counter() - t0
        for i, c in enumerate(cs):
            ranks = [recs[i] for recs in per_rank]
            r0, cfg = ranks[0], c["cfg"]
            fused = c["mode"] == "fused"
            attn = ("paged_attention" if not fused
                    else "paged_attention_ragged" if c["kv_dtype"] == "fp32"
                    else "paged_attention_ragged_quant")
            if cuda:
                for r in ranks:
                    for name, n in r["launches"].items():
                        SERVING_LAUNCHES[name] += n
            want_launches = cfg.n_layers * r0["dispatches"] if cuda else 0
            rec = {"tp": world, "backend": backend, "model": cfg.name,
                   "layers": cfg.n_layers, "kv_dtype": c["kv_dtype"],
                   "moe_impl": c["moe_impl"], "mode": c["mode"],
                   "steps": r0["steps"],
                   "dispatches": [r["dispatches"] for r in ranks],
                   "all_reduces": [r["all_reduces"] for r in ranks],
                   "all_reduces_per_dispatch": 2 * cfg.n_layers + 2,
                   "kv_heads_a_rank": r0["kv_heads_a_rank"],
                   "attention_kernel": attn,
                   "attention_launches": [r["launches"][attn]
                                          for r in ranks],
                   "b4_launches": [r["launches"]["moe_gmm"] for r in ranks],
                   "spawn_s": spawn_s}
            if "log" in r0:
                fields, good = _tp_decode_gates(c, ranks, cuda)
                rec.update(fields)
            else:
                good = ((r0["dispatches"] == r0["steps"] if fused
                         else r0["dispatches"] >= r0["steps"])
                        and all(r["dispatches"] == r0["dispatches"]
                                and r["all_reduces"]
                                == (2 * cfg.n_layers + 2) * r["dispatches"]
                                and r["launches"][attn] == want_launches
                                for r in ranks))
            if c["moe_impl"] == "capacity" and cuda:
                good &= all(r["launches"]["moe_gmm"] > 0 for r in ranks)
            if c.get("single_too"):
                rec["logits_bitwise"] = r0["logits_bitwise"]
                rec["logits_dispatches"] = r0["logits_dispatches"]
                good &= r0["logits_bitwise"]
                _emit("tp_parity", rec)
            elif c.get("serve_record"):
                s = r0["serve"]
                rec.update(s, all_reduce_ms_per_step=r0["all_reduce_s"]
                           * 1e3 / s["steps"],
                           broadcast_ms_per_step=r0["broadcast_s"] * 1e3
                           / s["steps"],
                           collective_share_of_wall=(
                               r0["all_reduce_s"] + r0["broadcast_s"])
                           / s["wall_s"])
                _emit("tp_serve", rec)
                serve_rec = rec
            else:
                ref = refs[_ref_key(c)]
                rec["tokens_equal_single_device"] = \
                    r0["tokens"] == ref["tokens"]
                rec["reference_mode"] = ref["mode"]
                good &= rec["tokens_equal_single_device"]
                if c["moe_impl"] == "exact":
                    assert_same_decisions(ref["trace"], r0["trace"],
                                          label=f"TP 1 vs TP {world}")
                    rec["decisions_equal_tp1"] = True
                    rec["vtc_equal_tp1"] = r0["vtc"] == ref["vtc"]
                    rec["spec"] = r0["spec"]
                    rec["spec_equal_tp1"] = r0["spec"] == ref["spec"]
                    good &= rec["vtc_equal_tp1"] and rec["spec_equal_tp1"]
                _emit("tp_parity", rec)
            if not good:
                raise AssertionError(f"TP {world} {cfg.name} "
                                     f"{c['kv_dtype']} {c['moe_impl']}: "
                                     f"a gate failed: {rec}")
    return serve_rec


# ---------------------------------------------------------------------------
# phase 3f: B4's backward GEMMs against autograd through the plain version
# ---------------------------------------------------------------------------

# phase 6b's batch: mixtral-8x7b at B = 2 x 1024 tokens, one router chunk
TRAIN_MOE_BATCH = (2, 1024)


def moe_backward_steps() -> list:
    """(name, E, C, K, N) of phase 3f: mixtral-8x7b's gate/up (K=d,
    N=f) and down (K=f, N=d) GEMMs at (s) a decode capacity, C=8, (t) the
    capacity phase 6b trains at and (u) a 7680-token chunk's, C=960."""
    mix = get("mixtral-8x7b")
    e, d, f = mix.moe.n_experts, mix.d_model, mix.moe.d_ff_expert
    train_c = chunk_capacity(math.prod(TRAIN_MOE_BATCH), mix.moe)
    steps = []
    for tag, c in (("s_c8", 8), (f"t_train_c{train_c}", train_c),
                   ("u_c960", 960)):
        steps += [(f"{tag}_gate_up", e, c, d, f),
                  (f"{tag}_down", e, c, f, d)]
    return steps


def check_moe_backward(name, e, c, k, n, w, timer, device, seed=0) -> dict:
    """dx and dw from the ``MoeGmm`` Function (two more B4 calls) against
    autograd through ``moe_gmm_ref``, on x and dy ~ N(0, 0.3²). Gate: max
    abs error < 2e-4·√(contraction) (N for dx, C for dw), the same
    against fp64 on the first expert's first rows, a repeat bitwise
    equal. Times ``moe_gmm_backward`` (both GEMMs and the transposes'
    copies), the plain version's two einsums and ``torch.bmm`` on the
    transposed views."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((e, c, k), generator=g, device=device).mul_(0.3)
    dy = torch.randn((e, c, n), generator=g, device=device).mul_(0.3)
    xf, wf = x.detach().requires_grad_(), w.detach().requires_grad_()
    dx, dw = torch.autograd.grad(MoeGmm.apply(xf, wf), (xf, wf), dy)
    ex, ew = torch.autograd.grad(moe_gmm_ref(xf, wf), (xf, wf), dy)
    del xf, wf
    wt, xt = w.transpose(1, 2), x.transpose(1, 2)
    kern = lambda: moe_gmm_backward(x, w, dy)
    plain = lambda: (moe_gmm_ref(dy, wt), moe_gmm_ref(xt, dy))
    library = lambda: (torch.bmm(dy, wt), torch.bmm(xt, dy))
    if not (torch.isfinite(dx).all() and torch.isfinite(dw).all()):
        raise AssertionError(f"{name}: non-finite gradient")
    rows = min(c, 8)
    exact_dx = dy[0, :rows].double() @ w[0].double().T
    exact_dw = x[0, :, :rows].double().T @ dy[0].double()
    tol_dx, tol_dw = 2e-4 * n ** 0.5, 2e-4 * c ** 0.5
    again = kern()
    rec = {"step": name, "E": e, "C": c, "K": k, "N": n,
           "dx_max_abs_err": float((dx - ex).abs().max()),
           "dw_max_abs_err": float((dw - ew).abs().max()),
           "dx_tolerance": tol_dx, "dw_tolerance": tol_dw,
           "dx_fp64_max_abs_err": float((dx[0, :rows] - exact_dx)
                                        .abs().max()),
           "dw_fp64_max_abs_err": float((dw[0, :rows] - exact_dw)
                                        .abs().max()),
           "repeat_bitwise": bool(torch.equal(again[0], dx)
                                  and torch.equal(again[1], dw)),
           **gmm_backward_bound(e, c, k, n)}
    del dx, dw, ex, ew, exact_dx, exact_dw, again
    rec["max_abs_err"] = max(rec["dx_max_abs_err"], rec["dw_max_abs_err"])
    if (rec["dx_max_abs_err"] >= tol_dx or rec["dw_max_abs_err"] >= tol_dw
            or rec["dx_fp64_max_abs_err"] >= tol_dx
            or rec["dw_fp64_max_abs_err"] >= tol_dw
            or not rec["repeat_bitwise"]):
        _emit("moe_backward_step", rec)
        raise AssertionError(f"{name}: B4's backward disagrees with the "
                             f"plain version")
    rec.update(time_in_turns(timer, kern, plain, library))
    if x.is_cuda:
        rec.update(graph_ms=graph_timer(kern),
                   library_graph_ms=graph_timer(library))
    return rec


def phase_moe_backward(device, timer, steps=None) -> list:
    """Phase 3f. The weights are N(0, 0.3²); one w per (E, K, N)."""
    recs, w, w_shape = [], None, None
    cuda = torch.device(device).type == "cuda"
    for i, (name, e, c, k, n) in enumerate(steps or moe_backward_steps()):
        if (e, k, n) != w_shape:
            del w
            if cuda:
                torch.cuda.empty_cache()
            g = torch.Generator(device=device).manual_seed(200 + i)
            w = torch.randn((e, k, n), generator=g, device=device).mul_(0.3)
            w_shape = (e, k, n)
        recs.append(check_moe_backward(name, e, c, k, n, w, timer, device,
                                       i))
        _emit("moe_backward_step", recs[-1])
    del w
    if cuda:
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 4j, 4k: training and the encoder-decoder, card against CPU
# ---------------------------------------------------------------------------

# (arch, layers, tokens of one sequence, impl) of phase 4j
# (h2o at 1 layer, 2 until 4n's multi-step and speculative cases needed
# the time)
TRAIN_PARITY = (("h2o-danube-1.8b", 1, 256, "dense"),
                ("h2o-danube-1.8b", 1, 256, "flash"),
                ("mixtral-8x7b", 1, 128, "capacity"))
# phase 4l: the SSM family at 1 block (2 until 4n's new cases needed the
# time), the hybrid at 7 (one application of the shared attention block
# after 6, then a remainder block)
TRAIN_PARITY_SSM = (("mamba2-1.3b", 1, 256, "auto"),
                    ("zamba2-2.7b", 7, 256, "auto"))
ATOL_STEP = 1e-6


def _train_opts(impl: str) -> ModelOpts:
    if impl == "capacity":
        return ModelOpts(moe_impl="capacity")
    if impl == "flash":
        return ModelOpts(attn_impl="flash", flash_block=64)
    return ModelOpts(attn_impl=impl)


def counted_grads(model, params, batch) -> tuple:
    """(loss, gradient tree, each kernel's launches): ``train_loss`` and
    its backward, every kernel count set to 0 just before and read just
    after; launches on the card add to ``SERVING_LAUNCHES``."""
    for k in KERNELS.values():
        k.launches = 0
    loss, grads = value_and_grad(model.train_loss, params, batch)
    launches = {name: k.launches for name, k in KERNELS.items()}
    if model.device.type == "cuda":
        for name, c in launches.items():
            SERVING_LAUNCHES[name] += c
    return float(loss), grads, launches


def compare_grads(got, want) -> dict:
    """Each leaf's max |got - want| over its max |want| (the largest
    reported), and how many elements are exactly 0 in ``got`` where
    ``want``'s are not (a gradient the card lost)."""
    worst, missing = 0.0, 0
    for a, b in zip(leaves(got), leaves(want)):
        a = a.cpu()
        scale = float(b.abs().max())
        if scale > 0:
            worst = max(worst, float((a - b).abs().max()) / scale)
        missing += int(((b != 0) & (a == 0)).sum())
    return {"grad_max_rel_err": worst, "grads_lost": missing}


def step_from(params, grads, device) -> dict:
    """One AdamW step of ``params`` from ``grads`` (both moved to
    ``device``), returned on the CPU."""
    opt_cfg = OptConfig()
    p = params_to(params, device)
    p, _ = apply_updates(p, params_to(grads, device),
                         init_opt_state(p, opt_cfg), opt_cfg)
    return params_to(p, "cpu")


def grads_parity(model_d, model_c, params, batch_d, batch_c) -> dict:
    """4j's and 4k's comparison: loss and gradients on ``model_d``'s
    device and on the CPU, then one AdamW step from the CPU's gradients
    on both devices (Adam's first update is about g / |g|, so a gradient
    element near 0 would carry its fp32 noise, amplified up to 1/eps,
    into the params: both devices step from the same gradients)."""
    cpu_params = params_to(params, "cpu")
    ld, gd, launches = counted_grads(model_d, params, batch_d)
    lc, gc_, _ = counted_grads(model_c, cpu_params, batch_c)
    rec = {"loss": ld, "cpu_loss": lc,
           "loss_rel_err": abs(ld - lc) / abs(lc), **compare_grads(gd, gc_),
           "launches": launches}
    del gd
    sd = step_from(params, gc_, model_d.device)
    sc = step_from(cpu_params, gc_, "cpu")
    rec["step_params_max_abs_err"] = max(
        float((a - b).abs().max()) for a, b in zip(leaves(sd), leaves(sc)))
    rec["grads_ok"] = (rec["loss_rel_err"] <= 1e-5
                       and rec["grad_max_rel_err"] <= 1e-4
                       and rec["grads_lost"] == 0
                       and rec["step_params_max_abs_err"] <= ATOL_STEP)
    return rec


def b4_train_launches(cfg, opts: ModelOpts, tokens: int, cuda: bool) -> int:
    """B4 calls of one loss-and-gradient pass: per layer and router chunk
    3 forward, 3 recomputed under remat, 6 backward."""
    if cfg.moe is None or opts.moe_impl != "capacity" or not cuda:
        return 0
    return ((12 if opts.remat else 9) * cfg.n_layers
            * router_chunks(tokens, cfg.moe))


def b5_train_launches(cfg, opts: ModelOpts, cuda: bool) -> tuple:
    """(B5 forward, B5 backward) calls of one loss-and-gradient pass: per
    Mamba2 block the forward, once more under remat (the block recomputed
    for the backward pass), and one backward."""
    if cfg.ssm is None or not cuda:
        return 0, 0
    return (2 if opts.remat else 1) * cfg.n_layers, cfg.n_layers


def train_launches(cfg, opts: ModelOpts, tokens: int, cuda: bool) -> dict:
    """Each kernel's calls in one loss-and-gradient pass: B4's and B5's
    by their rules, no other kernel."""
    fwd, bwd = b5_train_launches(cfg, opts, cuda)
    return {n: 0 for n in KERNELS} | {
        "moe_gmm": b4_train_launches(cfg, opts, tokens, cuda),
        "mamba2_scan": fwd, "mamba2_scan_backward": bwd}


def phase_train_parity(device, cases=TRAIN_PARITY, tag="4j") -> list:
    """Phases 4j and 4l: each case's config at full width, its depth cut,
    the port's own weights (seed 1), one sequence of random tokens (seed
    7): ``train_loss`` and its gradients on ``device`` and on the CPU,
    then one AdamW step. Gates: loss within 1e-5 relative, every gradient
    leaf within 1e-4 of its max |g| and nonzero wherever the CPU's is,
    params after the step within 1e-6, B4 and B5 launched as
    ``train_launches`` says and no other kernel."""
    cuda = torch.device(device).type == "cuda"
    recs = []
    for arch, layers, tokens, impl in cases:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get(arch), n_layers=layers)
        opts = _train_opts(impl)
        params = init_params(cfg, torch.Generator(
            device=device).manual_seed(1), device)
        toks = np.random.default_rng(7).integers(0, cfg.vocab, (1, tokens))
        rec = {"phase": tag, "model": cfg.name, "layers": layers,
               "tokens": tokens, "impl": impl,
               "reduced": [f"n_layers {get(arch).n_layers} -> {layers}"],
               **grads_parity(DecoderLM(cfg, opts, device=device),
                              DecoderLM(cfg, opts, device="cpu"), params,
                              {"tokens": torch.as_tensor(toks,
                                                         device=device)},
                              {"tokens": torch.as_tensor(toks)})}
        want = train_launches(cfg, opts, tokens, cuda)
        rec["launches_expected"] = want
        rec["seconds"] = time.perf_counter() - t0
        _emit("train_parity", rec)
        if not rec["grads_ok"] or rec["launches"] != want:
            raise AssertionError(f"{cfg.name} ({impl}): card and CPU "
                                 f"train differently, or the launches are "
                                 f"wrong")
        recs.append(rec)
        del params
        if cuda:
            _release_memory()
    return recs


def _encdec_inputs(cfg, batch: int, frames: int, dec: int, device,
                   seed: int) -> dict:
    """Encoder frames ~ N(0, 0.1²) and decoder token ids, made on
    ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {"enc_embeds": torch.randn((batch, frames, cfg.d_model),
                                      generator=g, device=device).mul_(0.1),
            "dec_tokens": torch.randint(0, cfg.vocab, (batch, dec),
                                        generator=g, device=device)}


def generate_encdec(model, params, inputs: dict, steps: int) -> Generated:
    """``EncDecLM``'s serving path: ``prefill`` over the encoder frames and
    the decoder prompt, then ``steps`` greedy ``decode_step``s, each
    ending on its tokens' copy to the host; kernel counts as in
    ``generate``."""
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    max_len = inputs["dec_tokens"].shape[1] + steps
    logits, cache = model.prefill(params, inputs, max_len)
    tok = logits.argmax(-1)
    out = [tok.cpu()]
    prefill_s = time.perf_counter() - t0
    pre = {name: k.launches for name, k in KERNELS.items()}
    first = logits.cpu().numpy()
    for k in KERNELS.values():
        k.launches = 0
    step_s = []
    for _ in range(steps):
        t = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache)
        tok = logits.argmax(-1)
        out.append(tok.cpu())
        step_s.append(time.perf_counter() - t)
    dec = {name: k.launches for name, k in KERNELS.items()}
    return Generated(torch.stack(out, 1).numpy(), first, prefill_s, step_s,
                     pre, dec, cache)


def phase_encdec_parity(device, layers: int = 1, steps: int = 8) -> dict:
    """Phase 4k: seamless-m4t-large-v2 at full width with ``layers``
    encoder and decoder layers, the port's own weights (seed 1): prefill
    of B=2 × 256 frames and 4 decoder tokens plus ``steps`` greedy steps,
    and ``train_loss`` of B=2 × (256 frames, 64 tokens), on ``device`` and
    on the CPU. Gates: first logits within 1e-3, tokens equal, 4j's
    gradient gates, no kernel launched (the encoder-decoder runs none)."""
    t0 = time.perf_counter()
    full = get("seamless-m4t-large-v2")
    cfg = dataclasses.replace(full, n_layers=layers, n_encoder_layers=layers)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device)
    md = EncDecLM(cfg, device=device)
    mc = EncDecLM(cfg, device="cpu")
    inputs = _encdec_inputs(cfg, 2, 256, 4, device, seed=8)
    with torch.no_grad():
        d = generate_encdec(md, params, inputs, steps)
        c = generate_encdec(mc, params_to(params, "cpu"),
                            params_to(inputs, "cpu"), steps)
    batch = _encdec_inputs(cfg, 2, 256, 64, device, seed=9)
    rec = {"model": cfg.name, "enc_layers": layers, "dec_layers": layers,
           "reduced": [f"n_layers {full.n_layers} -> {layers}",
                       f"n_encoder_layers {full.n_encoder_layers} -> "
                       f"{layers}"],
           "tokens_equal_cpu": bool(np.array_equal(d.tokens, c.tokens)),
           "first_logits_max_abs_err": float(np.abs(d.first - c.first).max()),
           "serve_launches": {n: d.prefill_launches[n] + d.decode_launches[n]
                              for n in KERNELS},
           **grads_parity(md, mc, params, batch, params_to(batch, "cpu"))}
    rec["seconds"] = time.perf_counter() - t0
    _emit("encdec_parity", rec)
    if (not rec["tokens_equal_cpu"] or not rec["grads_ok"]
            or rec["first_logits_max_abs_err"] > ATOL_LOGITS
            or any(rec["serve_launches"].values())
            or any(rec["launches"].values())):
        raise AssertionError("seamless: card and CPU disagree")
    return rec


# ---------------------------------------------------------------------------
# phase 5j: encoder-decoder serving at full depth
# ---------------------------------------------------------------------------

ENCDEC_SERVE = (8, 2048, 4, 64)   # batch, frames, decoder prompt, steps


def phase_encdec_serve(device, workload=ENCDEC_SERVE) -> dict:
    """Phase 5j: seamless-m4t-large-v2 at full depth and width (24 + 24
    layers, fp32 weights from seed 0) through ``EncDecLM.prefill`` plus
    greedy ``decode_step``s. Gates: finite first logits, every token in
    [0, vocab), no kernel launched. Reports the prefill's seconds, the
    decode step's median host ms, output tokens/s and peak memory."""
    cfg = get("seamless-m4t-large-v2")
    cuda = torch.device(device).type == "cuda"
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    batch, frames, dec, steps = workload
    inputs = _encdec_inputs(cfg, batch, frames, dec, device, seed=5)
    if cuda:
        _release_memory()
        torch.cuda.reset_peak_memory_stats()
    model = EncDecLM(cfg, device=device)
    with torch.no_grad():
        run = generate_encdec(model, params, inputs, steps)
    decode_s = sum(run.step_s)
    n_out = run.tokens.size
    rec = {"model": cfg.name, "enc_layers": cfg.n_encoder_layers,
           "dec_layers": cfg.n_layers, "batch": batch,
           "encoder_frames": frames, "decoder_prompt": dec,
           "decode_steps": steps, "prefill_s": run.prefill_s,
           "prefill_frames_per_s": batch * frames / run.prefill_s,
           "decode_step_median_ms": statistics.median(run.step_s) * 1e3,
           "decode_tok_per_s": batch * steps / decode_s,
           "output_tokens": n_out,
           "output_tok_per_s": n_out / (run.prefill_s + decode_s),
           "weight_bytes": sum(t.numel() * 4 for t in leaves(params)),
           "cache_bytes": sum(t.numel() * t.element_size()
                              for t in leaves(run.cache)),
           "max_memory_allocated_bytes": (
               torch.cuda.max_memory_allocated() if cuda else None)}
    ok = (np.isfinite(run.first).all() and run.tokens.min() >= 0
          and run.tokens.max() < cfg.vocab
          and run.tokens.shape == (batch, steps + 1)
          and not any(run.prefill_launches.values())
          and not any(run.decode_launches.values()))
    _emit("encdec_serve", rec)
    if not ok:
        raise AssertionError("seamless serve: bad logits, tokens or "
                             "launches")
    del params, run, model
    return rec


# ---------------------------------------------------------------------------
# phases 6a-6c: training at full width
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainRun:
    """One phase of 6: the model (config, options), the optimizer, the
    batch (made on the device from a seed), the steps and the step after
    which the checkpoint is saved (None: no checkpoint; a repeated
    loss-and-gradient pass instead)."""
    tag: str
    cfg: object
    opts: ModelOpts
    opt: OptConfig
    batch: tuple          # (B, S) tokens, or (B, frames, decoder tokens)
    steps: int
    save_after: Optional[int] = 3


def train_runs() -> list:
    """6a h2o-danube-1.8b (3 of 24 layers, AdamW, B 4 × 1024; 6f (i)
    trains it at full depth), 6b
    mixtral-8x7b (2 layers, Adafactor, capacity, B 2 × 1024), 6c
    seamless-m4t-large-v2 (12 + 12 of 24 + 24 layers, AdamW, B 4 × (1024
    frames, 256 decoder tokens)), 6d mamba2-1.3b (every layer, AdamW, B 4 × 2048) and
    6e zamba2-2.7b (every layer, AdamW, B 4 × 1024); only 6a with a
    checkpoint (its I/O does not depend on the family), the others
    repeat a loss-and-gradient pass."""
    return [TrainRun("6a", dataclasses.replace(get("h2o-danube-1.8b"),
                                               n_layers=3), ModelOpts(),
                     OptConfig(name="adamw"), (4, 1024), 8),
            TrainRun("6b", dataclasses.replace(get("mixtral-8x7b"),
                                               n_layers=2),
                     ModelOpts(moe_impl="capacity"),
                     OptConfig(name="adafactor"), TRAIN_MOE_BATCH, 5, None),
            TrainRun("6c", dataclasses.replace(
                get("seamless-m4t-large-v2"), n_layers=12,
                n_encoder_layers=12), ModelOpts(),
                     OptConfig(name="adamw"), (4, 1024, 256), 5, None),
            TrainRun("6d", get("mamba2-1.3b"), ModelOpts(),
                     OptConfig(name="adamw"), (4, 2048), 5, None),
            TrainRun("6e", get("zamba2-2.7b"), ModelOpts(),
                     OptConfig(name="adamw"), (4, 1024), 5, None)]


def train_batch(run: TrainRun, device) -> dict:
    if run.cfg.is_encoder_decoder:
        return _encdec_inputs(run.cfg, *run.batch, device, seed=11)
    g = torch.Generator(device=device).manual_seed(11)
    return {"tokens": torch.randint(0, run.cfg.vocab, run.batch,
                                    generator=g, device=device)}


def trace_ms(fn, groups: dict, label: str) -> tuple:
    """(device ms of one call of ``fn``: every kernel, copy and memset of
    its ``torch.profiler`` trace; by group of ``groups`` (name: kernel
    names), the part in kernels whose name holds one of the group's),
    the trace kept as build/profile/``label``.json."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = pathlib.Path(__file__).resolve().parent / "build" / "profile" / \
        f"{label}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    total = sum(e["dur"] for e in events) / 1e3
    parts = {g: sum(e["dur"] for e in events
                    if any(k in e.get("name", "") for k in names)) / 1e3
             for g, names in groups.items()}
    return total, parts


B4_KERNELS = ("gmm_tile_kernel", "gmm_stream_kernel", "splitk_reduce_kernel")
CKPT_DIR = pathlib.Path(__file__).resolve().parent / "build" / "ckpt"


def phase_train(run: TrainRun, device) -> dict:
    """One of phases 6a-6e: ``make_train_step`` over one fixed batch for
    ``run.steps`` steps from the port's own weights (seed 0). With
    ``save_after`` a checkpoint is saved after that step, loaded, and the
    remaining steps run again; without it one loss-and-gradient pass is
    repeated. Gates: every loss finite and the last below the first;
    every step's gradient norm finite (so every gradient leaf is); the
    restored run's params within 1e-6 of the uninterrupted run's and its
    losses within 1e-6 relative, or the repeated pass's loss and
    gradients bitwise equal; B4 and B5 launched as ``train_launches``
    says a step, no other kernel. Reports s/step (median of the steps
    after the first), tokens/s, model TFLOP/s, peak memory, the losses,
    the checkpoint's bytes and save/load seconds; under capacity or with
    Mamba2 blocks also one profiled step's device ms and B4's, or B5's
    forward and backward, part of it."""
    cfg, cuda = run.cfg, torch.device(device).type == "cuda"
    model = build_model(cfg, run.opts, device=device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device, run.opts.param_dtype)
    counts = param_counts(cfg, params)
    batch = train_batch(run, device)
    step = make_train_step(model, run.opt)
    opt = init_opt_state(params, run.opt)
    ckpt = CKPT_DIR / f"{run.tag}.npz"
    if cuda:
        _release_memory()
        torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    for k in KERNELS.values():
        k.launches = 0
    for i in range(run.steps):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
        if i + 1 == run.save_after:
            t0 = time.perf_counter()
            save_checkpoint(str(ckpt), {"params": params, "opt": opt},
                            meta={"step": i + 1})
            save_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    if cuda:
        for name, c in launches.items():
            SERVING_LAUNCHES[name] += c
    peak = torch.cuda.max_memory_allocated() if cuda else None
    # the uninterrupted run's params, before the profiled step moves them
    final = None if run.save_after is None else params_to(params, "cpu")
    s = statistics.median(step_s[1:])
    tokens = math.prod(run.batch) if not cfg.is_encoder_decoder else \
        run.batch[0] * (run.batch[1] + run.batch[2])
    flops = model_flops(cfg, counts, run.batch)
    rec = {"phase": run.tag, "model": cfg.name, "layers": cfg.n_layers,
           "optimizer": run.opt.name,
           "dtypes": {k: str(getattr(run.opts, k)) for k in (
               "param_dtype", "compute_dtype", "cache_dtype")},
           "moe_impl": run.opts.moe_impl if cfg.moe is not None else None,
           "batch": list(run.batch), "steps": run.steps, **counts,
           "losses": losses, "grad_norms": norms, "step_s": step_s,
           "s_per_step": s, "tokens_per_s": tokens / s,
           "model_flops_per_step": flops,
           "model_tflop_per_s": flops / s / 1e12,
           "max_memory_allocated_bytes": peak, "launches": launches}
    full = get(cfg.name)
    rec["reduced"] = [f"{k} {getattr(full, k)} -> {getattr(cfg, k)}"
                      for k in ("n_layers", "n_encoder_layers")
                      if getattr(cfg, k) != getattr(full, k)] or None
    want = {n: c * run.steps for n, c in train_launches(
        cfg, run.opts, math.prod(run.batch), cuda).items()}
    groups = {}
    if cfg.moe is not None and run.opts.moe_impl == "capacity":
        groups["b4"] = B4_KERNELS
    if cfg.ssm is not None:
        groups |= {"b5_forward": B5_KERNELS,
                   "b5_backward": mamba2_scan.BACKWARD_KERNELS}
    if cuda and groups:
        total, parts = trace_ms(lambda: step(params, opt, batch), groups,
                                f"train_{run.tag}")
        rec["step_device_ms"] = total
        for g, ms in parts.items():
            rec[f"{g}_device_ms"] = ms
            rec[f"{g}_share"] = ms / total if total else None
    if run.save_after is None:
        del opt
        if cuda:
            _release_memory()
        passes = [value_and_grad(model.train_loss, params, batch)
                  for _ in range(2)]
        (l1, g1), (l2, g2) = passes
        rec["repeat_bitwise"] = bool(torch.equal(l1, l2) and all(
            torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2))))
        del passes, g1, g2
        restored = rec["repeat_bitwise"]
    else:
        del params, opt
        if cuda:
            _release_memory()
        t0 = time.perf_counter()
        state = load_checkpoint(str(ckpt), device)
        load_s = time.perf_counter() - t0
        ckpt_bytes = ckpt.stat().st_size
        ckpt.unlink()
        params, opt = state["params"], state["opt"]
        del state
        resumed = []
        for _ in range(run.save_after, run.steps):
            params, opt, met = step(params, opt, batch)
            resumed.append(float(met["loss"]))
        restore_err = max(float((a.cpu() - b).abs().max())
                          for a, b in zip(leaves(params), leaves(final)))
        del final, opt
        rec.update(checkpoint_bytes=ckpt_bytes, save_s=save_s,
                   load_s=load_s, resumed_losses=resumed,
                   restore_params_max_abs_err=restore_err,
                   restore_bitwise=restore_err == 0.0)
        restored = (restore_err <= ATOL_STEP
                    and all(abs(a - b) <= 1e-6 * abs(b)
                            for a, b in zip(resumed,
                                            losses[run.save_after:])))
    _emit("train", rec)
    ok = (all(math.isfinite(v) for v in losses + norms)
          and losses[-1] < losses[0] and restored and launches == want)
    del params, model, batch
    if not ok:
        raise AssertionError(f"{run.tag} {cfg.name}: training failed a gate")
    return rec


# ---------------------------------------------------------------------------
# phase 3h: the kernels in bf16
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def one_rounding(got, plain) -> tuple:
    """(max |got - plain|, whether every element of ``got`` is within one
    bf16 rounding of the plain version's fp32 result ``plain``: |Δ| ≤
    2⁻⁸·|plain| + 1e-4·max|plain|, the 1e-4 for fp32 sums in another
    order; an fp32 ``got`` is rounded to no bf16, so its bar is the 1e-4
    alone)."""
    d = (got.double() - plain.double()).abs()
    p = plain.double().abs()
    ulp = 2.0 ** -8 if got.dtype == BF16 else 0.0
    return float(d.max()), bool((d <= ulp * p
                                 + 1e-4 * float(p.max())).all())


def _bf16_timed(rec, timer, kern, plain, library, cuda=True) -> dict:
    """3h's times: as phase 3's, ``graph_ms`` on the card only."""
    rec.update(time_in_turns(timer, kern, plain, library))
    if cuda:
        rec["graph_ms"] = graph_timer(kern)
    return rec


def _bf16_gate(tag, rec, ok) -> None:
    if not ok:
        _emit(tag, rec)
        raise AssertionError(f"{rec['step']}: the bf16 kernel disagrees "
                             f"with its plain version")


def check_bf16_attention(kind, batched, timer, device) -> dict:
    """B1 (a ragged step) or B3 (a batched one) on bf16 q and pools, pages
    of 128, against the plain version's fp32 math on the same bf16 values;
    poison (NaN) in every slot no row may read leaves the output bitwise
    equal; a repeat bitwise equal. Library: SDPA in bf16."""
    st = (make_bstep if batched else make_step)(kind, 128, device)
    q, kp, vp, *meta = st.args
    q, kp, vp = (t.to(BF16) for t in (q, kp, vp))
    st = dataclasses.replace(st, args=(q, kp, vp, *meta))
    fn, ref = ((paged_attention, paged_attention_ref) if batched else
               (paged_attention_ragged, paged_attention_ragged_ref))
    kern = lambda: fn(q, kp, vp, *meta, window=st.window)
    plain = lambda: ref(q.float(), kp, vp, *meta, window=st.window)
    got, want = kern(), plain()
    err, ok = one_rounding(got, want)
    same = None          # the kernel's property: the plain version
    if q.is_cuda:        # multiplies masked NaN by 0
        kp2, vp2 = poisoned(st)
        same = torch.equal(fn(q, kp2, vp2, *meta, window=st.window), got)
        del kp2, vp2
    lib_fn, lib_check = (blibrary_call if batched else library_call)(st)
    rec = {"step": f"{kind}_bf16", "kernel": fn.__name__, "page": 128,
           "max_abs_err": err, "one_rounding": ok, "poison_ok": same,
           "repeat_bitwise": torch.equal(kern(), got),
           "library_max_abs_err": lib_check(lib_fn(), want),
           **(bstep_bound(st, 2, BF16_FLOPS_PER_S) if batched else
              step_bound(st, 2, 0, 2, BF16_FLOPS_PER_S))}
    _bf16_gate("bf16_kernel_step", rec,
               ok and same is not False and rec["repeat_bitwise"])
    return _bf16_timed(rec, timer, kern, plain, lib_fn, q.is_cuda)


def check_bf16_quant(kind, timer, device) -> dict:
    """B2 on step ``kind`` (pages of 128) with int8 pools and a bf16 q, the
    output bf16, against the plain version's fp32 math; poison and a
    repeat as 3c. Library: SDPA in bf16 over the dequantized pools."""
    st = make_step(kind, 128, device)
    args, (kd, vd), _ = quantize_step(st, "int8")
    q = args[0].to(BF16)
    args = (q, *args[1:])
    kern = lambda: paged_attention_ragged_quant(*args, window=st.window)
    plain = lambda: paged_attention_ragged_quant_ref(q.float(), *args[1:],
                                                     window=st.window)
    got, want = kern(), plain()
    err, ok = one_rounding(got, want)
    same = None if not q.is_cuda else torch.equal(
        paged_attention_ragged_quant(q, *poisoned_quant(st, args),
                                     *args[5:], window=st.window), got)
    lib_fn, lib_check = library_call(dataclasses.replace(
        st, args=(q, kd, vd, *st.args[3:])))
    rec = {"step": f"{kind}_int8_bf16q", "kernel": "paged_attention_ragged_"
           "quant", "page": 128, "max_abs_err": err, "one_rounding": ok,
           "poison_ok": same, "repeat_bitwise": torch.equal(kern(), got),
           "library_max_abs_err": lib_check(lib_fn(), want),
           **step_bound(st, 1, 4, 2, BF16_FLOPS_PER_S)}
    _bf16_gate("bf16_kernel_step", rec,
               ok and same is not False and rec["repeat_bitwise"])
    return _bf16_timed(rec, timer, kern, plain, lib_fn, q.is_cuda)


def check_bf16_gmm(c, timer, device, backward=False) -> dict:
    """B4 at mixtral-8x7b's gate/up shape (E 8, K 4096, N 14336) at
    capacity ``c`` in bf16 (x, w ~ N(0, 0.3²) rounded), against the plain
    version's fp32 math and fp64 on the first expert's first rows, a
    repeat bitwise; with ``backward`` its backward pair (dx = dy · wᵀ, dw =
    xᵀ · dy, dy bf16 likewise) instead. Library: ``torch.bmm`` in bf16."""
    mix = get("mixtral-8x7b")
    e, k, n = mix.moe.n_experts, mix.d_model, mix.moe.d_ff_expert
    g = torch.Generator(device=device).manual_seed(300 + c)
    rnd = lambda *shp: torch.randn(shp, generator=g, device=device).mul_(
        0.3).to(BF16)
    x, w = rnd(e, c, k), rnd(e, k, n)
    rows = min(c, 8)
    if backward:
        dy = rnd(e, c, n)
        wt, xt = w.transpose(1, 2), x.transpose(1, 2)
        kern = lambda: moe_gmm_backward(x, w, dy)
        plain = lambda: (moe_gmm_ref(dy.float(), wt.float()),
                         moe_gmm_ref(xt.float(), dy.float()))
        library = lambda: (torch.bmm(dy, wt), torch.bmm(xt, dy))
        exact = (dy[0, :rows].double() @ w[0].double().T,
                 x[0, :, :rows].double().T @ dy[0].double())
        bound = gmm_backward_bound(e, c, k, n, 2, BF16_FLOPS_PER_S)
    else:
        kern = lambda: (moe_gmm(x, w),)
        plain = lambda: (moe_gmm_ref(x.float(), w.float()),)
        library = lambda: torch.bmm(x, w)
        exact = (x[0, :rows].double() @ w[0].double(),)
        bound = gmm_bound(e, c, k, n, 2, BF16_FLOPS_PER_S)
    got, want, again = kern(), plain(), kern()
    errs = [one_rounding(a, b) for a, b in zip(got, want)]
    rec = {"step": f"c{c}_gate_up_bf16" + ("_backward" if backward else ""),
           "kernel": "moe_gmm", "E": e, "C": c, "K": k, "N": n,
           "max_abs_err": max(v for v, _ in errs),
           "one_rounding": all(o for _, o in errs),
           "fp64_max_abs_err": max(float((a[0, :rows].double() - x64)
                                         .abs().max())
                                   for a, x64 in zip(got, exact)),
           "repeat_bitwise": all(torch.equal(a, b)
                                 for a, b in zip(got, again)), **bound}
    del got, want, again, exact
    _bf16_gate("bf16_moe_kernel_step", rec,
               rec["one_rounding"] and rec["repeat_bitwise"])
    rec = _bf16_timed(rec, timer, kern, plain, library, x.is_cuda)
    if x.is_cuda:
        rec["library_graph_ms"] = graph_timer(library)
    return rec


def check_bf16_scan(arch, batch, prompt, timer, device, backward=False,
                    contract=False) -> dict:
    """B5 at ``arch``'s heads and the scan shape of ``batch`` prompts of
    ``prompt`` tokens, at the dtypes ``models/mamba2.py`` gives it under
    bf16 compute: fp32 xdt and a_dt, bf16 b and c (3e's distributions,
    b and c rounded), a zero start, y in fp32; with ``contract`` the
    Pallas kernel's instead (all four bf16, y bf16). y against the plain
    version's fp32 math on the same values (one rounding), the state
    (fp32) within 1e-4·max(1, max|plain|), fp64 on the first sequence's
    first two heads (the backward: on the first sequence), a repeat
    bitwise. With ``backward`` B5's backward at the model's dtypes
    instead, from a forward launch that wrote y in fp32 (what it reads),
    dy ~ N(0, 1) fp32: the four gradients, each in its input's dtype,
    each one rounding from the plain fp32 backward. No library call."""
    shape = scan_shape(get(arch), batch, prompt)
    b, nc, l, h, p, n = shape
    g = torch.Generator(device=device).manual_seed(400 + int(backward))
    rnd = lambda *shp: torch.randn(shp, generator=g, device=device)
    x, a = rnd(b, nc, l, h, p).mul_(0.3), rnd(b, nc, l, h).abs_().mul_(-0.1)
    bm, cm = rnd(b, nc, l, n).mul_(0.3), rnd(b, nc, l, n).mul_(0.3)
    xt = BF16 if contract else torch.float32
    ins = [x.to(xt), a.to(xt), bm.to(BF16), cm.to(BF16)]
    x_elem = 2 if contract else 4
    cuda = ins[0].is_cuda
    del x, a, bm, cm
    f32 = [t.float() for t in ins]
    if backward:
        dy = rnd(b, nc, l, h, p)
        saved = (mamba2_scan._launch(*ins, None, torch.float32)[::2]
                 if cuda else None)
        kern = lambda: mamba_chunk_scan_backward(*ins, None, dy, None, saved,
                                                 SCAN_NEEDS)[:4]
        plain = lambda: mamba_chunk_scan_backward_ref(*f32, None, dy,
                                                      None)[:4]
        exact = mamba_chunk_scan_backward_ref(
            *(t[:1].double() for t in f32), None, dy[:1].double(), None)[:4]
        cut = lambda t: t[:1]
        bound = scan_backward_bound(b, nc, l, h, p, n, 2)
    else:
        y_dtype = None if contract else torch.float32
        kern = lambda: mamba_chunk_scan(*ins, None, y_dtype)
        plain = lambda: mamba_chunk_scan_ref(*f32)
        exact = mamba_chunk_scan_ref(
            f32[0][:1, :, :, :2].double(), f32[1][:1, :, :, :2].double(),
            f32[2][:1].double(), f32[3][:1].double())
        cut = lambda t: t[:1, :, :, :2] if t.dim() == 5 else t[:1, :2]
        bound = scan_bound(b, nc, l, h, p, n, nc - 1, x_elem, 2)
    got, want, again = kern(), plain(), kern()
    if backward:
        errs = [one_rounding(u, v) for u, v in zip(got, want)]
        state_ok = True
    else:
        errs = [one_rounding(got[0], want[0])]
        tol = ATOL_KERNEL * max(1.0, float(want[1].abs().max()))
        state_ok = float((got[1] - want[1]).abs().max()) <= tol
    rec = {"step": f"{arch}_b{batch}_s{prompt}_"
           + ("bf16" if contract else "bf16bc")
           + ("_backward" if backward else ""),
           "kernel": "mamba2_scan" + ("_backward" if backward else ""),
           "dtypes": ("xdt, a_dt, b, c and y bf16" if contract else
                      "xdt, a_dt fp32; b, c bf16; y fp32"),
           "B": b, "NC": nc, "L": l, "H": h, "P": p, "N": n,
           "max_abs_err": max(v for v, _ in errs),
           "one_rounding": all(o for _, o in errs), "state_ok": state_ok,
           "fp64_max_abs_err": max(float((cut(u).double() - e64).abs().max())
                                   for u, e64 in zip(got, exact)),
           "repeat_bitwise": all(torch.equal(u, v)
                                 for u, v in zip(got, again)), **bound}
    del got, want, again, exact
    _bf16_gate("bf16_ssm_kernel_step", rec, rec["one_rounding"] and state_ok
               and rec["repeat_bitwise"])
    return _bf16_timed(rec, timer, kern, plain, None, cuda)


def phase_bf16_kernels(device, timer) -> dict:
    """Phase 3h: every kernel in bf16 at the main path's shapes (pages of
    128): B1 at steps (a) and (b), B2 at (a) with int8 pools, B3 at (d)
    and (f), B4 at mixtral's gate/up at C = 8 and 960 and its backward pair
    at C = 640, B5 at 3e (l) and (h) and its backward at (l) at the
    model's dtypes (what 4m, 5k and 6f launch), then B5 at (l) at the
    Pallas kernel's (all bf16). Returns the records by kernel."""
    cuda = torch.device(device).type == "cuda"
    steps = {
        "paged_attention_ragged": [
            lambda: check_bf16_attention("a_mixed", False, timer, device),
            lambda: check_bf16_attention("b_decode", False, timer, device)],
        "paged_attention_ragged_quant": [
            lambda: check_bf16_quant("a_mixed", timer, device)],
        "paged_attention": [
            lambda: check_bf16_attention("d_decode", True, timer, device),
            lambda: check_bf16_attention("f_chunk", True, timer, device)],
        "moe_gmm": [lambda: check_bf16_gmm(8, timer, device),
                    lambda: check_bf16_gmm(960, timer, device),
                    lambda: check_bf16_gmm(640, timer, device, True)],
        "mamba2_scan": [
            lambda: check_bf16_scan("mamba2-1.3b", 8, 2048, timer, device),
            lambda: check_bf16_scan("zamba2-2.7b", 8, 2048, timer, device),
            lambda: check_bf16_scan("mamba2-1.3b", 8, 2048, timer, device,
                                    contract=True)],
        "mamba2_scan_backward": [
            lambda: check_bf16_scan("mamba2-1.3b", 8, 2048, timer, device,
                                    True)]}
    recs = {}
    for name, fns in steps.items():
        recs[name] = []
        for fn in fns:
            recs[name].append(fn())
            _emit("bf16_kernel_step", recs[name][-1])
            if cuda:
                _release_memory()
    return recs


# ---------------------------------------------------------------------------
# phase 4m: bf16 models, card against CPU, at reduced depth
# ---------------------------------------------------------------------------

# the JAX launch cells' opts (src/repro/launch/steps.py::_model_opts)
SERVE_BF16 = ModelOpts(param_dtype=BF16, compute_dtype=BF16,
                       cache_dtype=BF16, attn_impl="flash",
                       moe_impl="capacity", remat=False)
TRAIN_BF16 = ModelOpts(param_dtype=torch.float32, compute_dtype=BF16,
                       cache_dtype=BF16, attn_impl="flash",
                       moe_impl="capacity", remat=True, ce_chunk=2048)
# (arch, layers, prompt or training tokens) of phase 4m: 4j's and 4l's
# (h2o and mamba2 at 1 layer and mixtral at 64 tokens since 4n's
# multi-step and speculative cases needed the time: 2, 2 and 128 before)
BF16_PARITY = (("h2o-danube-1.8b", 1, 256), ("mixtral-8x7b", 1, 64),
               ("mamba2-1.3b", 1, 256), ("zamba2-2.7b", 7, 256))
BF16_BAR = 2e-2


def forced(cfg, params, device, prompts, steps, opts, tokens=None):
    """``DecoderLM`` prefill and ``steps`` decode steps, each fed
    ``tokens[:, i]`` (None: its own greedy token). Returns (logits of the
    prefill and of each step, on the host; the tokens fed; each kernel's
    launches in the prefill and in the decode steps). Every count is set
    to 0 just before and read just after; launches on the card add to
    ``SERVING_LAUNCHES``."""
    model = DecoderLM(cfg, opts, device=device)
    x = torch.as_tensor(prompts, device=model.device)
    for k in KERNELS.values():
        k.launches = 0
    logits, cache = model.prefill(params, x, prompts.shape[1] + steps)
    pre = {name: k.launches for name, k in KERNELS.items()}
    for k in KERNELS.values():
        k.launches = 0
    out, fed = [logits.float().cpu()], []
    for i in range(steps):
        tok = (logits.argmax(-1) if tokens is None
               else torch.as_tensor(tokens[:, i], device=model.device))
        fed.append(tok.cpu())
        logits, cache = model.decode_step(params, tok, cache)
        out.append(logits.float().cpu())
    dec = {name: k.launches for name, k in KERNELS.items()}
    if model.device.type == "cuda":
        for name in KERNELS:
            SERVING_LAUNCHES[name] += pre[name] + dec[name]
    return out, torch.stack(fed, 1).numpy(), pre, dec


def _bf16_leaves_ok(got, want, exact) -> tuple:
    """(worst per-leaf |got - want| over the leaf's max |exact|, its bar,
    leaves ``want`` moves and ``got`` does not): ``got`` the card's bf16
    gradients, ``want`` and ``exact`` the CPU's plain path at bf16 and at
    fp32 compute. The bar of a leaf is 2e-2 plus 1.5 times that leaf's
    bf16 noise in the reference alone, |want - exact| over the same max
    (bf16 gradients are a few % from fp32 ones; the card's should be no
    further from the CPU's), so nothing the card computes sets its own
    bar."""
    worst, worst_bar, lost, ok = 0.0, 0.0, 0, True
    for a, b, r in zip(leaves(got), leaves(want), leaves(exact)):
        a = a.cpu()
        scale = float(r.abs().max())
        if float(b.abs().max()) > 0 and float(a.abs().max()) == 0:
            lost += 1
        if scale == 0:
            continue
        err = float((a - b).abs().max()) / scale
        bar = BF16_BAR + 1.5 * float((b - r).abs().max()) / scale
        ok &= err <= bar
        if err > worst:
            worst, worst_bar = err, bar
    return worst, worst_bar, lost, ok


def phase_bf16_parity(device, cases=BF16_PARITY, steps=4, seed=1,
                      train=True) -> list:
    """Phase 4m: each case's config at full width, its depth cut, the
    port's own weights (``seed``). Serving at the launch serving opts (bf16
    weights, compute and cache): prefill of 2 prompts and ``steps`` decode
    steps on the CPU (greedy) and on the card (fed the CPU's tokens).
    Gates: logits within 2e-2·max|logit| of the CPU's at every step, the
    card's greedy token the CPU's wherever the CPU's top-2 margin is
    larger than that; B5 once per Mamba2 block in the prefill, never in
    decode, B4 in both on the MoE model, no other kernel. Training at the
    launch training opts (fp32 weights, bf16 compute; skipped without
    ``train``): ``train_loss`` and its gradients on both, the CPU's also
    at fp32 compute for each leaf's bf16 noise: loss within 1e-3
    relative, every leaf within 2e-2 + 1.5 × that noise of its fp32 max
    (``_bf16_leaves_ok``), none lost, B4 and B5 launched as
    ``train_launches`` says."""
    recs = []
    cuda = torch.device(device).type == "cuda"
    for arch, layers, tokens in cases:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get(arch), n_layers=layers)
        params = init_params(cfg, torch.Generator(
            device=device).manual_seed(seed), device, BF16)
        prompts = _prompts(cfg, 2, tokens, seed=6)
        cl, toks, _, _ = forced(cfg, params_to(params, "cpu"), "cpu",
                                prompts, steps, SERVE_BF16)
        dl, _, pre, dec = forced(cfg, params, device, prompts, steps,
                                 SERVE_BF16, toks)
        del params
        err, tok_ok = 0.0, True
        for a, b in zip(dl, cl):
            bar = BF16_BAR * float(b.abs().max())
            err = max(err, float((a - b).abs().max()) / bar * BF16_BAR)
            top2 = b.topk(2, -1).values
            clear = (top2[:, 0] - top2[:, 1]) > bar
            tok_ok &= bool(torch.equal(a.argmax(-1)[clear],
                                       b.argmax(-1)[clear]))
        mamba = cfg.n_layers if cfg.ssm is not None and cuda else 0
        gmm = cfg.moe is not None and cuda
        launches_ok = (pre["mamba2_scan"] == mamba
                       and dec["mamba2_scan"] == 0
                       and (pre["moe_gmm"] > 0) == gmm
                       and (dec["moe_gmm"] > 0) == gmm
                       and all(pre[n] == dec[n] == 0 for n in KERNELS
                               if n not in ("mamba2_scan", "moe_gmm")))
        rec = {"phase": "4m", "model": cfg.name, "layers": layers,
               "tokens": tokens, "decode_steps": steps, "seed": seed,
               "reduced": [f"n_layers {get(arch).n_layers} -> {layers}"],
               "serve_opts": "bf16 params, compute and cache",
               "logits_max_rel_err": err, "tokens_ok": tok_ok,
               "prefill_launches": pre, "decode_launches": dec}
        train_ok = True
        if train:       # at the launch training opts
            params = init_params(cfg, torch.Generator(
                device=device).manual_seed(seed), device)
            host = params_to(params, "cpu")
            toks = np.random.default_rng(7).integers(0, cfg.vocab,
                                                     (1, tokens))
            bd = {"tokens": torch.as_tensor(toks, device=device)}
            bc = {"tokens": torch.as_tensor(toks)}
            ld, gd, tl = counted_grads(
                DecoderLM(cfg, TRAIN_BF16, device=device), params, bd)
            del params
            lc, gc_, _ = counted_grads(
                DecoderLM(cfg, TRAIN_BF16, device="cpu"), host, bc)
            f32 = dataclasses.replace(TRAIN_BF16, compute_dtype=torch.float32,
                                      cache_dtype=torch.float32)
            _, g32, _ = counted_grads(DecoderLM(cfg, f32, device="cpu"),
                                      host, bc)
            worst, worst_bar, lost, grads_ok = _bf16_leaves_ok(gd, gc_, g32)
            del host, gd, g32, gc_
            rec.update({"train_opts": "fp32 params, bf16 compute and cache",
                        "loss": ld, "cpu_loss": lc,
                        "loss_rel_err": abs(ld - lc) / abs(lc),
                        "grad_worst_rel_err": worst,
                        "grad_worst_bar": worst_bar, "grads_lost": lost,
                        "train_launches": tl})
            train_ok = (rec["loss_rel_err"] <= 1e-3 and grads_ok
                        and lost == 0
                        and tl == train_launches(cfg, TRAIN_BF16, tokens,
                                                 cuda))
        rec["seconds"] = time.perf_counter() - t0
        _emit("bf16_parity", rec)
        if not (err <= BF16_BAR and tok_ok and launches_ok and train_ok):
            raise AssertionError(f"{cfg.name}: bf16 on the card and on the "
                                 f"CPU disagree, or the launches are wrong")
        recs.append(rec)
        if cuda:
            _release_memory()
    return recs


# ---------------------------------------------------------------------------
# phase 5k: bf16 serving through DecoderLM at full width
# ---------------------------------------------------------------------------

BF16_MOE_LAYERS = 16             # of mixtral-8x7b's 32: 46.4 GB of bf16
BF16_MOE_SERVE = ((4, 2048, 32),)


def phase_bf16_serve(device) -> list:
    """Phase 5k at the launch serving opts: (i) mixtral-8x7b at every
    published width, 16 of its 32 layers (the memory 5d's 8 fp32 layers
    take), 4 prompts of 2048 then 32 decode steps; (ii) mamba2-1.3b at
    full depth on 5e (i)'s workload (8 × 2048, then 64 steps). 5e's gates
    and numbers (``phase_decoder_serve``), with B4's and B5's share of one
    more prefill's device ms."""
    mix = dataclasses.replace(get("mixtral-8x7b"), n_layers=BF16_MOE_LAYERS)
    recs = phase_decoder_serve(mix, device, BF16_MOE_SERVE, SERVE_BF16,
                               tag="5k")
    _release_memory()
    recs += phase_decoder_serve(get("mamba2-1.3b"), device, SSM_SERVE[:1],
                                SERVE_BF16, tag="5k")
    return recs


# ---------------------------------------------------------------------------
# phase 6f: training at the launch training opts (fp32 weights, bf16 compute)
# ---------------------------------------------------------------------------

def bf16_train_runs() -> list:
    """6f (i) h2o-danube-1.8b at full depth on 6a's batch (4 × 1024, AdamW,
    5 steps) and (ii) mamba2-1.3b at full depth on 6d's (4 × 2048): B5 in
    bf16 forward and backward; a repeated pass instead of a checkpoint."""
    return [TrainRun("6f_i", get("h2o-danube-1.8b"), TRAIN_BF16,
                     OptConfig(name="adamw"), (4, 1024), 5, None),
            TrainRun("6f_ii", get("mamba2-1.3b"), TRAIN_BF16,
                     OptConfig(name="adamw"), (4, 2048), 5, None)]


def bf16_fields(rec: dict, prefix: str = "bf16_") -> dict:
    """A 3h record's times, bound and error, keyed with ``prefix``."""
    keys = ("ms", "graph_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")
    return {prefix + k: rec.get(k) for k in keys}


# ---------------------------------------------------------------------------
# phase 7a: launch cells on the card, held to their dry run
# ---------------------------------------------------------------------------

# (tag, arch, shape, batch cut, depth cut): full width, the launch opts;
# the batch and mixtral's depth cut as far as the card (its memory, by
# the dry run) and this script's time force (PERF.md §4)
LAUNCH_CELLS = (("i", "mamba2-1.3b", "train_4k", 4, None),
                ("ii", "mamba2-1.3b", "prefill_32k", 1, None),
                ("iii", "mamba2-1.3b", "decode_32k", None, None),
                ("iv", "h2o-danube-1.8b", "decode_32k", None, None),
                ("v", "mixtral-8x7b", "decode_32k", 64, 16))
PEAK_TOLERANCE = 0.10      # the card's peak against the dry run's


def cell_launches(cell, cuda: bool) -> dict:
    """Each kernel's calls in one step of ``cell``: a training step's by
    ``train_launches``; in a prefill B5 once per Mamba2 block; B4 three
    times per layer and router chunk of every forward under capacity; no
    other kernel (on the CPU nothing launches)."""
    cfg, opts, shape = cell.arch, cell.model.opts, cell.shape
    tokens = shape.global_batch * (1 if cell.mode == "decode"
                                   else shape.seq_len)
    if cell.mode == "train":
        return train_launches(cfg, opts, tokens, cuda)
    want = {n: 0 for n in KERNELS}
    if cuda and cfg.moe is not None and opts.moe_impl == "capacity":
        want["moe_gmm"] = 3 * cfg.n_layers * router_chunks(tokens, cfg.moe)
    if cuda and cfg.ssm is not None and cell.mode == "prefill":
        want["mamba2_scan"] = cfg.n_layers
    return want


def _step_values(cell, out) -> dict:
    """A step's loss and gradient norm (training) or its logits' largest
    magnitude, and whether they are finite."""
    if cell.mode == "train":
        vals = {k: float(out[2][k]) for k in ("loss", "grad_norm")}
    else:
        vals = {"logits_absmax": float(out[0].float().abs().max())}
    return {**vals, "finite": all(math.isfinite(v) for v in vals.values())}


def phase_launch_cells(device, card: str, cells=LAUNCH_CELLS,
                       reduced: bool = False) -> list:
    """Phase 7a: each cell through ``build_cell`` on a 1 × 1 abstract mesh
    at the launch opts, its batch and depth cut, dry-run on ``meta``
    tensors (``dryrun.measure``), then its arguments drawn on ``device``
    (``CellSpec.materialize``, seed 0; a decode cell's cache full, as
    after a prefill of seq_len - 1 tokens) and its step run twice: under
    ``analyze``, then timed by CUDA events with the allocator's peak
    reset, the arguments resident. Gates: the arguments' and the outputs'
    bytes equal the dry run's exactly, the card's FLOPs equal the
    abstract run's exactly, the timed run's peak above what was
    allocated before lies within ±10 % of the dry run's
    ``per_device_hbm_bytes`` (the analysed run's peak is reported: the
    dry run counts the step as it runs under a dispatch mode), the
    loss, gradient norm or logits are finite, and each run launches B4
    and B5 as ``cell_launches`` says. Reports step ms, counted TFLOP/s
    and their share of 989 TFLOP/s (bf16), beside the card."""
    cuda = torch.device(device).type == "cuda"
    mesh = Mesh.abstract((1, 1), ("data", "model"))
    recs = []
    for tag, arch, shape, batch, layers in cells:
        if cuda:
            _release_memory()
        cell = build_cell(arch, shape, mesh, reduced=reduced, batch=batch,
                          layers=layers)
        dry = dryrun.measure(cell)
        base = torch.cuda.memory_allocated() if cuda else 0
        args = cell.materialize(device, torch.Generator(
            device=device).manual_seed(0))
        arg_bytes = tree_bytes(args)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        res, launches = _counted(cuda, lambda: analyze(cell.fn, *args))
        values = _step_values(cell, res.pop("output"))
        want = cell_launches(cell, cuda)
        full = get(arch)
        rec = {"cell": tag, "arch": arch, "shape": shape, "mode": cell.mode,
               "batch": cell.shape.global_batch,
               "seq_len": cell.shape.seq_len, "layers": cell.arch.n_layers,
               "reduced": {k: [a, b] for k, a, b in (
                   ("global_batch", SHAPES[shape].global_batch,
                    cell.shape.global_batch),
                   ("n_layers", full.n_layers, cell.arch.n_layers))
                   if a != b},
               "dry": {**dry["memory"], "flops": dry["flops"],
                       "bytes": dry["bytes"],
                       "analysis_s": dry["analysis_s"]},
               "argument_bytes": arg_bytes,
               "output_bytes": res["output_bytes"], "flops": res["flops"],
               "bytes": res["bytes"], **values,
               "launches": launches, "launches_expected": want}
        del res
        if cuda:
            torch.cuda.synchronize()
            # the allocator's peak while the step ran under the analysis
            # (a Python dispatch mode), which the dry run counts
            rec["analysed_run_peak_bytes"] = (
                torch.cuda.max_memory_allocated() - base)
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            out, again = _counted(cuda, lambda: (start.record(),
                                                 cell.fn(*args),
                                                 end.record())[1])
            torch.cuda.synchronize()
            rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
            rec["allocated_before"] = base
            rec["peak_over_dry"] = (rec["peak_bytes"]
                                    / dry["per_device_hbm_bytes"])
            rec["step_ms"] = start.elapsed_time(end)
            rec["tflops"] = rec["flops"] / rec["step_ms"] / 1e9
            rec["share_of_bf16_peak"] = (rec["tflops"] * 1e12
                                         / BF16_FLOPS_PER_S)
            rec["launches_timed_run"] = again
            rec["timed_run"] = _step_values(cell, out)
            del out
        if cell.mode == "train":
            rec["model_flops_6nd"] = model_flops(
                cell.arch, param_counts(cell.arch, args[0]),
                (cell.shape.global_batch, cell.shape.seq_len))
        rec["card"] = card
        _emit("launch_cell", rec)
        ok = (arg_bytes == dry["memory"]["argument_bytes"]
              and rec["output_bytes"] == dry["memory"]["output_bytes"]
              and rec["flops"] == dry["flops"] and rec["finite"]
              and launches == want
              and (not cuda or (abs(rec["peak_over_dry"] - 1)
                                <= PEAK_TOLERANCE
                                and rec["launches_timed_run"] == want
                                and rec["timed_run"]["finite"])))
        if not ok:
            raise AssertionError(f"7a ({tag}) {arch} {shape}: a gate "
                                 f"failed: {rec}")
        recs.append(rec)
        del args, cell
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    _emit("device", {"nvidia_smi": card,
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "name": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    info = _build.build()
    _emit("build", {"seconds": time.perf_counter() - t0,
                    "kernels": {n: i["seconds"] for n, i in info.items()}})
    for n, i in info.items():
        for line in i["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {n}: {line.strip()}")

    recs = phase_kernels("cuda", cuda_timer)
    brecs = phase_batched_kernels("cuda", cuda_timer)
    qrecs = phase_quant_kernels("cuda", cuda_timer)
    tp_recs = phase_shard_kernels("cuda", cuda_timer)
    mrecs = phase_moe_kernels("cuda", cuda_timer)
    brecs_b4 = phase_moe_backward("cuda", cuda_timer)
    srecs = phase_ssm_kernels("cuda", cuda_timer)
    hrecs = phase_ssm_kernels("cuda", cuda_timer, cfg=get("zamba2-2.7b"),
                              steps=HYBRID_SSM_STEPS)
    grecs = phase_ssm_backward("cuda", cuda_timer)
    _release_memory()
    b16 = phase_bf16_kernels("cuda", cuda_timer)
    small = dataclasses.replace(get("h2o-danube-1.8b"), n_layers=2)
    _, fused_tokens = phase_parity(small, "cuda")
    phase_path_parity(small, "cuda", fused_tokens)
    phase_quant_parity(small, "cuda")
    _release_memory()
    phase_moe_parity(dataclasses.replace(get("mixtral-8x7b"),
                                         n_layers=MOE_PARITY_LAYERS), "cuda")
    _release_memory()
    phase_moe_spec(dataclasses.replace(get("mixtral-8x7b"), n_layers=2),
                   "cuda")
    _release_memory()
    phase_decoder_parity("cuda")
    _release_memory()
    phase_train_parity("cuda")
    _release_memory()
    phase_train_parity("cuda", TRAIN_PARITY_SSM, tag="4l")
    _release_memory()
    phase_encdec_parity("cuda")
    _release_memory()
    # the bf16 main paths (4m, 5k, 6f): their launches, summed
    bf16_launches = {name: 0 for name in KERNELS}

    def bf16_path(fn, *args):
        before = dict(SERVING_LAUNCHES)
        out = fn(*args)
        for name in KERNELS:
            bf16_launches[name] += SERVING_LAUNCHES[name] - before[name]
        _release_memory()
        return out

    bf16_path(phase_bf16_parity, "cuda")
    phase_cache_parity(dataclasses.replace(small,
                                           n_layers=CACHE_PARITY_LAYERS),
                       "cuda")
    phase_migration_parity(small, "cuda")
    cfg = get("h2o-danube-1.8b")
    _release_memory()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    serve_rec, serve16_tokens = phase_serve(cfg, "cuda", params=params)
    if serve_rec["attention_launches"] == 0 or serve_rec[
            "attention_launches"] != cfg.n_layers * serve_rec["dispatches"]:
        raise AssertionError(
            f"attention launches {serve_rec['attention_launches']} != "
            f"{cfg.n_layers} x {serve_rec['dispatches']} dispatches")
    _, decode16_tokens = phase_serve_paths(cfg, "cuda", params,
                                           serve16_tokens)
    phase_quant_serve(cfg, "cuda", params, serve16_tokens, decode16_tokens)
    phase_cached_serve(cfg, "cuda", params)
    phase_migrate_serve(cfg, "cuda", params)
    del params
    _release_memory()
    phase_tp("cuda", cfg, get("mixtral-8x7b"))
    _release_memory()
    mix = dataclasses.replace(get("mixtral-8x7b"), n_layers=MOE_SERVE_LAYERS)
    by_c = dict(phase_moe_serve(mix, "cuda")["b4_launches_by_capacity"])
    _release_memory()
    served_mrecs = phase_moe_kernels("cuda", cuda_timer,
                                     serve_moe_steps(by_c, mix))
    _release_memory()
    shard_mrecs = phase_moe_kernels("cuda", cuda_timer,
                                    shard_moe_steps(by_c, mix))
    _release_memory()
    phase_decoder_serve(get("mamba2-1.3b"), "cuda", SSM_SERVE)
    _release_memory()
    phase_decoder_serve(get("zamba2-2.7b"), "cuda")
    _release_memory()
    phase_decoder_serve(get("gemma3-1b"), "cuda")
    _release_memory()
    phase_encdec_serve("cuda")
    _release_memory()
    bf16_path(phase_bf16_serve, "cuda")
    for run in train_runs():
        _release_memory()
        phase_train(run, "cuda")
    for run in bf16_train_runs():
        _release_memory()
        bf16_path(phase_train, run, "cuda")
    # 7a: the launch cells; their launches also summed alone
    before = dict(SERVING_LAUNCHES)
    phase_launch_cells("cuda", card)
    _release_memory()
    cell_launches_sum = {n: SERVING_LAUNCHES[n] - before[n] for n in KERNELS}

    main_rec = recs[0]            # step (a), pages of 128: the serving shape
    dec_rec = recs[2]             # step (b), pages of 128
    main_brec = brecs[0]          # step (d), pages of 128: decode batches
    chunk_brec = brecs[4]         # step (f), pages of 128: a prefill chunk
    main_qrec = qrecs[0]          # step (a), int8, pages of 128
    dec_qrec = qrecs[4]           # step (b), int8, pages of 128
    mrecs += served_mrecs
    main_mrec = served_mrecs[0]   # gate/up at 5d's most launched C
    pre_mrec = max((r for r in served_mrecs if r["step"].endswith("gate_up")),
                   key=lambda r: r["C"])   # gate/up at 5d's largest C
    main_srec = srecs[0]          # step (l), zero state: 5e (i)'s shape
    long_srec = srecs[2]          # step (m), zero state: 5e (ii)'s shape
    hyb_srec = hrecs[0]           # step (h), zero state: 5h's shape
    bwd_mrec = next(r for r in brecs_b4           # step (u), gate/up
                    if r["step"] == "u_c960_gate_up")
    main_grec, long_grec, hyb_grec = grecs   # 3g (l), (m), (h)
    b16_b1, b16_b3 = b16["paged_attention_ragged"], b16["paged_attention"]

    def per_shard(recs, kernel=None) -> list:
        """3i's steps of one kernel, for its row."""
        return [{k: r[k] for k in ("tp", "H", "HKV", "E", "C", "step",
                                   "ms", "graph_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "max_abs_err") if k in r}
                for r in recs if kernel is None or r["kernel"] == kernel]
    b16_b4, b16_b5 = b16["moe_gmm"], b16["mamba2_scan"]
    kernels = [{
        "name": "paged_attention_ragged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention_ragged.cu",
        "replaces": "src/repro/kernels/paged_attention.py:243",
        "launches": SERVING_LAUNCHES["paged_attention_ragged"],
        "max_abs_err": max(r["max_abs_err"] for r in recs + [
            r for r in tp_recs if r["kernel"] == "paged_attention_ragged"]),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "graph_ms": main_rec["graph_ms"], "decode_ms": dec_rec["ms"],
        "decode_graph_ms": dec_rec["graph_ms"],
        "decode_bound_ms": dec_rec["bound_ms"],
        "per_shard": per_shard(tp_recs, "paged_attention_ragged"),
        **bf16_fields(b16_b1[0]), **bf16_fields(b16_b1[1], "bf16_decode_"),
        "bf16_max_abs_err": max(r["max_abs_err"] for r in b16_b1)}, {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:382",
        "launches": SERVING_LAUNCHES["paged_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in brecs + [
            r for r in tp_recs if r["kernel"] == "paged_attention"]),
        "ms": main_brec["ms"], "plain_ms": main_brec["plain_ms"],
        "bound_ms": main_brec["bound_ms"], "bound_by": main_brec["bound_by"],
        "library_ms": main_brec["library_ms"],
        "graph_ms": main_brec["graph_ms"], "chunk_ms": chunk_brec["ms"],
        "chunk_graph_ms": chunk_brec["graph_ms"],
        "chunk_library_ms": chunk_brec["library_ms"],
        "chunk_bound_ms": chunk_brec["bound_ms"],
        "per_shard": per_shard(tp_recs, "paged_attention"),
        **bf16_fields(b16_b3[0]), **bf16_fields(b16_b3[1], "bf16_chunk_"),
        "bf16_max_abs_err": max(r["max_abs_err"] for r in b16_b3)}, {
        "name": "paged_attention_ragged_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/"
                  "paged_attention_ragged_quant.cu",
        "replaces": "src/repro/kernels/paged_attention.py:309",
        "launches": SERVING_LAUNCHES["paged_attention_ragged_quant"],
        "max_abs_err": max(r["max_abs_err"] for r in qrecs + [
            r for r in tp_recs
            if r["kernel"] == "paged_attention_ragged_quant"]),
        "ms": main_qrec["ms"], "plain_ms": main_qrec["plain_ms"],
        "bound_ms": main_qrec["bound_ms"], "bound_by": main_qrec["bound_by"],
        "library_ms": main_qrec["library_ms"],
        "graph_ms": main_qrec["graph_ms"], "b1_ms": main_qrec["b1_ms"],
        "decode_ms": dec_qrec["ms"], "decode_graph_ms": dec_qrec["graph_ms"],
        "decode_b1_ms": dec_qrec["b1_ms"],
        "decode_bound_ms": dec_qrec["bound_ms"],
        "per_shard": per_shard(tp_recs, "paged_attention_ragged_quant"),
        **bf16_fields(b16["paged_attention_ragged_quant"][0])}, {
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:38",
        "launches": SERVING_LAUNCHES["moe_gmm"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in mrecs + brecs_b4 + shard_mrecs),
        "ms": main_mrec["ms"], "plain_ms": main_mrec["plain_ms"],
        "bound_ms": main_mrec["bound_ms"], "bound_by": main_mrec["bound_by"],
        "library_ms": main_mrec["library_ms"],
        "graph_ms": main_mrec["graph_ms"],
        "prefill_C": pre_mrec["C"], "prefill_ms": pre_mrec["ms"],
        "prefill_library_ms": pre_mrec["library_ms"],
        "prefill_graph_ms": pre_mrec["graph_ms"],
        "prefill_library_graph_ms": pre_mrec["library_graph_ms"],
        "prefill_bound_ms": pre_mrec["bound_ms"],
        "backward_C": bwd_mrec["C"], "backward_ms": bwd_mrec["ms"],
        "backward_plain_ms": bwd_mrec["plain_ms"],
        "backward_graph_ms": bwd_mrec["graph_ms"],
        "backward_bound_ms": bwd_mrec["bound_ms"],
        "backward_library_ms": bwd_mrec["library_ms"],
        "backward_library_graph_ms": bwd_mrec["library_graph_ms"],
        "per_shard": per_shard(shard_mrecs),
        "launch_cell_launches": cell_launches_sum["moe_gmm"],
        "bf16_launches": bf16_launches["moe_gmm"],
        **bf16_fields(b16_b4[0]), **bf16_fields(b16_b4[1], "bf16_prefill_"),
        **bf16_fields(b16_b4[2], "bf16_backward_"),
        "bf16_library_graph_ms": b16_b4[0]["library_graph_ms"],
        "bf16_prefill_library_graph_ms": b16_b4[1]["library_graph_ms"],
        "bf16_max_abs_err": max(r["max_abs_err"] for r in b16_b4)}, {
        "name": "mamba2_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba2_scan.cu",
        "replaces": "src/repro/kernels/mamba2_scan.py:64",
        "launches": SERVING_LAUNCHES["mamba2_scan"],
        "max_abs_err": max(max(r["max_abs_err"], r["state_max_abs_err"])
                           for r in srecs + hrecs),
        "ms": main_srec["ms"], "plain_ms": main_srec["plain_ms"],
        "bound_ms": main_srec["bound_ms"], "bound_by": main_srec["bound_by"],
        "library_ms": main_srec["library_ms"],
        "graph_ms": main_srec["graph_ms"], "long_ms": long_srec["ms"],
        "long_graph_ms": long_srec["graph_ms"],
        "long_bound_ms": long_srec["bound_ms"],
        "hybrid_ms": hyb_srec["ms"], "hybrid_plain_ms": hyb_srec["plain_ms"],
        "hybrid_graph_ms": hyb_srec["graph_ms"],
        "hybrid_bound_ms": hyb_srec["bound_ms"],
        "hybrid_bound_by": hyb_srec["bound_by"],
        "launch_cell_launches": cell_launches_sum["mamba2_scan"],
        "bf16_launches": bf16_launches["mamba2_scan"],
        "bf16_dtypes": b16_b5[0]["dtypes"],
        **bf16_fields(b16_b5[0]), **bf16_fields(b16_b5[1], "bf16_hybrid_"),
        **bf16_fields(b16_b5[2], "bf16_contract_"),
        "bf16_max_abs_err": max(r["max_abs_err"] for r in b16_b5[:2])}, {
        "name": "mamba2_scan_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba2_scan.cu",
        "replaces": "src/repro/models/mamba2.py:75",
        "replaces_note": "the VJP of ssd_chunked, which the JAX package's "
                         "training differentiates: the TPU package has no "
                         "Pallas backward of src/repro/kernels/"
                         "mamba2_scan.py:64",
        "launches": SERVING_LAUNCHES["mamba2_scan_backward"],
        "max_abs_err": max(r["max_abs_err"] for r in grecs),
        "max_rel_err": max(r["max_rel_err"] for r in grecs),
        "ms": main_grec["ms"], "plain_ms": main_grec["plain_ms"],
        "bound_ms": main_grec["bound_ms"], "bound_by": main_grec["bound_by"],
        "library_ms": main_grec["library_ms"],
        "graph_ms": main_grec["graph_ms"], "long_ms": long_grec["ms"],
        "long_graph_ms": long_grec["graph_ms"],
        "long_bound_ms": long_grec["bound_ms"],
        "hybrid_ms": hyb_grec["ms"], "hybrid_plain_ms": hyb_grec["plain_ms"],
        "hybrid_graph_ms": hyb_grec["graph_ms"],
        "hybrid_bound_ms": hyb_grec["bound_ms"],
        "launch_cell_launches": cell_launches_sum["mamba2_scan_backward"],
        "bf16_launches": bf16_launches["mamba2_scan_backward"],
        "bf16_dtypes": b16["mamba2_scan_backward"][0]["dtypes"],
        **bf16_fields(b16["mamba2_scan_backward"][0])}]
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError("a kernel of the serving paths never launched")
    if not all(k["bf16_launches"] > 0 for k in kernels
               if "bf16_launches" in k):
        raise AssertionError("a kernel of the bf16 paths never launched")
    if not all(k["launch_cell_launches"] > 0 for k in kernels
               if "launch_cell_launches" in k):
        raise AssertionError("a kernel of the launch cells never launched")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
