#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one card

Phases, in order; any failure exits non-zero:

1. **device** — the card's name and power limit (``nvidia-smi``).
2. **build** — compiles every kernel from the sources in this checkout:
   one ``nvcc`` per CUDA source (K4-bwd's ``ssd_scan_bwd.cu`` among
   them), all started together, then the Triton
   kernels' (K1-bwd's) first launches; then reads the libraries' SASS with
   ``cuobjdump`` and fails unless each bf16 K2 and K2-bwd product kernel,
   the bf16 K4 kernel and K4-bwd's three bf16 kernels (the sweep, the
   dx/db pass, the dc pass) hold tensor-core instructions
   (``HGMMA``/``HMMA``), printing the count per kernel.
3. **kernels** — each kernel at the main paths' shapes against its plain
   PyTorch version on the same inputs, with the tolerance stated: K1 and
   K2 forward at the qwen2.5-3b serving shapes (K1 also at the
   mamba2-1.3b gated norm's width, 4096, and at one training
   microbatch, with its host cost per call and the launch floor beside
   its device time) and, beside K1-bwd and K2-bwd,
   at the training shapes as the training path calls them (K1-bwd also
   at one row, at a ragged last program and at width 4096, its row pass
   and its dw pass also timed apart); K3a and K3b
   at the largest bucket of the full-width gradient layout and at a
   ragged length; K4 (the SSD chunk scan) at the mamba2-1.3b prefill
   shapes (S 512 in chunks of 256, S 128) and training microbatch (B 8,
   S 512), in fp32, at a ragged single chunk of 159 and with G > 1 and N
   = 16; K4-bwd (its backward) at the training microbatch, the train
   CLI's smoke widths (P 8, N 16, Q 32), G 2 of H 8, a chunk of 48 and in
   fp32, against the plain backward and autograd of the plain forward;
   K1 and K1-bwd also at the mamba2 training microbatch (4,096 rows of
   2048 and of 4096). K1, K1-bwd, K4 and K4-bwd must give the same bits
   on a second call. Times the kernel, the plain
   version and, as a yardstick only, the one PyTorch call that computes
   the same function where there is one (device time, with the stream
   held busy while the host queues the calls; the host's own cost per
   call beside it); computes the bound from the bytes and flops of the
   inputs. K2, K2-bwd and K4 take one route per dtype (bf16 on the
   tensor cores, fp32 on the CUDA cores), named in each of their rows; K2's
   forward is also timed at the training shape, as the training path
   calls it, beside K2-bwd. K1-bwd (with K1's training forward), K2 and
   K2-bwd are also checked at each microbatch the campaign's live cells
   run (phase 13: N x per-type batch rows of seq tokens) and each
   microbatch an elastic rank runs (phase 14: N x per-type batch / DP
   rows at DP 4 and DP 2), with the same tolerances; K3a and K3b also at
   the largest bucket of the elastic layout and at a rank's DP-4 and
   DP-2 chunks of it, and at every bucket of the mamba2-1.3b training
   layout at each depth of its ladder (phase 11; the stacked wz, wx and
   out_proj leaves, 402,653,184 elements at 48 layers, are the largest).
   At the families' shapes (phase 15, ``family_kernel_checks``): K1 at
   widths 4608, 3072, 1536 and 4096 (the serving bucket and a training
   microbatch), K1-bwd at the microbatch, K2 and K2-bwd in bf16 at each
   config's heads (GQA groups 9, 3, 6, 16, and MHA at D 64), K3a and K3b
   at every distinct bucket size of each config's training layout. K2
   and K2-bwd at head dims 16 and 32 (``small_head_checks``), in bf16
   and fp32: the launchers' smoke heads (H 4, KV 2, D 16) at the cli
   train run's microbatch (B 8, S 64), a ragged last tile (S 200) and one
   token; qwen2.5-3b's heads at a training microbatch (B 8, S 256) at D
   16 and 32, and at D 32 a ragged tile and one token. At deepseek-v3's
   training shapes (``v3_kernel_checks``): K1 and K1-bwd at 2,048 rows of
   7168, 1536 and 512, K3a and K3b at its layout's largest buckets (the
   embedding's and head's 928,514,048 elements). At the FSDP x TP
   step's (phase 19 (d), ``fsdp_tp_kernel_checks``): K2 and K2-bwd in
   bf16 on a model rank's heads (H 8, KV 1, D 128) at a data rank's
   batch (B 2, S 256). K2 and K2-bwd give the same bits on a second call
   at every shape.
4. **reference** — a small qwen configuration with head_dim 128 served
   in fp32 on the card (kernels) and on the CPU (plain versions):
   greedy tokens identical, prefill logits within 1e-4.
5. **train reference** — a small configuration with head_dim 128,
   three training steps through the ``MeshExecutor`` in fp32 on the
   card (kernels) and on the CPU (plain versions): with fp32 buckets,
   losses within 1e-5 relative and params within 1e-5; with int8 EF,
   each step from the card's state, losses within 1e-5 relative, the
   synced gradients within one int8 quantum of their bucket (codes
   within 1, scales within 1e-5), the residuals within one quantum, and
   the card's residuals carried from step to step bit for bit.
6. **slice** — the serving path: full-width qwen2.5-3b (36 layers,
   random weights from a seed, bf16) behind a ``ReplicaServer`` with two
   replicas; one healthy run, one where a ``ScriptedInjector`` kills
   replica 0 mid-run. Every request completes in both with zero drops,
   nothing is rebuilt after warmup, the burst run's tokens equal the
   healthy run's, logits are finite, the kernels' launch counters (set
   to 0 just before, read just after) match the prefills and decode
   steps run, and a prefill of a generated continuation agrees with the
   decode's greedy choices. Then the step builders' default spellings,
   counted from 0 on their own: ``make_prefill(model)`` against the
   cache-filling prefill's last position (one bf16 ulp per row), and
   ``make_serve_step(model)``, the dense step at a scalar position, over
   caches filled from that prefill, against the paged engine's tokens
   (the same 0.25 logit gap). Then a third serving run, **wipeout**:
   the same set-up with a ``CheckpointManager`` (the params saved at
   construction under ``chiprun_out/``, removed after) and both
   replicas killed at ``kill_step``; the wipe-out reloads the params
   from the checkpoint onto the card. Every request completes with the
   healthy run's tokens, nothing is dropped or rebuilt, the reloaded
   params equal the originals bit for bit, and the launch counters (set
   to 0 just before, read just after) match; the reload's seconds are
   printed.
7. **ssm reference** — a small mamba2 configuration (2 layers, d_model
   256, head_dim 64, d_state 128, chunk 64) served in fp32 on the card
   (K4) and on the CPU (plain versions): prefill logits of a 128-token
   prompt (two chunks) within 1e-4, greedy tokens identical.
8. **ssm slice** — the same serving path and gates on full-width
   mamba2-1.3b (48 layers, no cut): every prefill runs K4 once per
   layer; the decode-vs-prefill check uses a request of the 128 bucket.
9. **train** — the training path (Alg. 1): full-width qwen2.5-3b, random
   bf16 weights from a seed, through the ``MeshExecutor`` on a one-rank
   NCCL group with the int8 error-feedback sync; a ``ScriptedInjector``
   kills a group (masked, ``S_A`` rises) and later a set that wipes the
   system out (rollback to the snapshot). Every loss is finite; the
   report matches the script; after the rollback, params, optimizer
   state and EF residuals equal the snapshot bit for bit (checksums);
   the first replayed step's loss equals that step's first execution
   bit for bit; the launch counters (set to 0 just before, read just
   after) equal the counts the code implies. Depth is 36 layers unless
   peak device memory passes ``TRAIN["mem_limit_gib"]``; then the
   largest of 24, 18, 12 that fits, with both readings printed. First
   the ``"dots"`` remat check (``DOTS``): full-width qwen2.5-3b and
   mamba2-1.3b at 2 layers, one training microbatch each (8 x 256 and
   8 x 512 tokens), random bf16 weights and tokens from seed 0, the
   loss's gradient under ``remat_policy`` ``"nothing"``, ``"dots"`` and
   ``"none"`` from one set of params: ``"dots"`` bit-identical to
   ``"nothing"`` with equal launch counts (K1 4L+1, K1-bwd 2L+1, K2 2L,
   K2-bwd L; mamba2 K4 2L, K4-bwd L); against ``"none"`` bit-identical
   or the largest distance printed with its cause; the peak device
   memory of each printed.
10. **failure tiers** — the training path with every failure tier on
   (``FAILURE``): full-width qwen2.5-3b at 4 layers (for the script's
   time; it ran 18 before the hybrid phase came, 6 before the MLA
   phase) through the int8-EF
   ``MeshExecutor`` with a checkpoint directory under ``chiprun_out/``
   (removed at the end; the Eq.-1 interval due at every snapshot point,
   one checkpoint kept), a
   ``StragglerDetector`` with its defaults and a ``ScriptedInjector``:
   a 3x straggler that is flagged, demoted and, once it heals,
   re-admitted, then a masked kill and a kill that wipes the system out.
   Gates: finite losses; the events and ``health_log`` equal a tiny CPU
   run of the same script; the re-admitted weight table equals an
   always-healthy run's bit for bit, with no rebuild; at least two saves
   commit and the latest restores onto the card to the state recorded
   at its step, bit for bit; the rollback restores the snapshot and the
   first replayed step's loss its first execution's, bit for bit; exact
   launch counts. Prints the host copy's, the disk write's and the
   restore's seconds, the step time with and without a save in flight,
   and the peak host RSS against ``MemTotal``. A smaller depth (2) only
   if the two checkpoints it writes exceed the disk's free space or the
   phase's write budget, or ``MemTotal`` is below the host snapshot; the
   readings are printed.
11. **ssm train** — SSM training: (a) the reference: a small fp32
   mamba2 (2 layers, d_model 256, head_dim 64, d_state 128, chunk 64,
   seq 128: two chunks) through three ``MeshExecutor`` steps on the card
   (K4, K4-bwd) and on the CPU, with the gates of phase 5; (b) the main
   path, as phase 9 (``SSM_TRAIN``): full-width mamba2-1.3b (48 layers
   unless peak device memory passes the limit; then 36 or 24), random
   bf16 weights from a seed, one example a type at seq 512 (two chunks:
   4,096 tokens a microbatch), the int8-EF ``MeshExecutor`` on a one-rank
   NCCL group, the same scripted masked kill and wipe-out, the same gates;
   per microbatch K4 runs 2L times (the forward and the remat
   recompute), K4-bwd L times, K1 4L + 1, K1-bwd 2L + 1, no K2.
12. **cli** — both launchers as subprocesses on the card at the smoke
   configuration with ``--failure-model``, ``--topology`` and
   ``--ckpt-dir`` (the train launcher through ``--mesh --grad-compress
   int8_ef``), and the train launcher on mamba2-1.3b's smoke
   configuration (``--mesh --grad-compress int8_ef --mtbf-steps 2``),
   and in a whole run the hybrid and MLA phases' launcher runs too, all
   ten started together with the train launcher's command run also
   with ``--device cpu``: exit code 0 and the report parsed; the card's
   train launcher prints the CPU run's ``params`` (107,072), head dim
   (16), steps and failure counts, the JAX launchers' smoke
   configuration on both, and its first loss within
   ``CLI_FIRST_LOSS_TOL`` (0.05) of the CPU run's (each draws its own
   init).
13. **campaign** — the campaign runner (``CAMPAIGN``): (a) the DES
   ``smoke`` preset at jobs 1 and 2 (spawned workers), artifacts
   byte-identical, rankings printed; (b) the three live trainer cells
   of the JAX preset (weibull, rack burst, trace replay: N 8, r 3, 40
   steps, seq 32) through ``run_trainer_cell`` on the card at the full
   width of qwen2.5-3b, each against the same cell at smoke size on the
   CPU: the report's counts equal, every loss finite, the §3.1 error at
   most 1e-2, at least one multi-group event; (c) the gray arms
   (tolerate, demote) through ``run_gray_cell`` on the one-rank NCCL
   ``MeshExecutor`` at the same width, against the CPU: flag, demote
   and re-admit steps, health actions and modeled TTT equal, the
   re-admitted table bit-identical, no run recompile, demote's TTT
   below tolerate's; (d) ``python -m repro_torch.launch.obs`` exits 0
   on every trace of (b) with ``--assert-coverage 0.95
   --assert-recovery-markers`` and on the demote arm's with
   ``--assert-coverage 0.95`` (a gray episode kills nobody, so it has
   no failure marker), whose attribution rows must be a demote and a
   re-admit. K1, K1-bwd, K2 and K2-bwd must launch on both live paths.
   The depth is a fixed 2 layers, and the phase fails unless the
   training state (params, AdamW moments, the accumulator and the two
   gradient trees of the §3.1 check, reckoned from the leaves) fits 75
   GiB; the reckoning is printed (36 layers fit too, but take half the
   script's time limit). Prints per cell the seconds, step seconds by
   ``S_A``, peak device memory, the process's peak RSS so far and the
   seconds of the host snapshots the cell's trace spans
   (``ckpt_save``).

14. **elastic** — the elastic tier (``ELASTIC``) on four ranks, one per
   SPARe group, each a spawned process on the one card, over a gloo
   group that carries CUDA tensors through the host (NCCL refuses two
   ranks on one device; the backend is printed). The kernels are built
   before the ranks start, and this process gives back its cached card
   memory first. Full-width qwen2.5-3b at 2 layers, for the script's
   time limit; the reckoning is printed and must hold: the four ranks'
   state (params, AdamW moments, accumulator, err1, err2, reckoned from
   the leaves) and CUDA contexts fit 75 GiB, and their four host
   snapshots and rank processes fit the host's 96 GiB less this
   process's RSS and 8 GiB of headroom. The card's
   four ranks are spawned once, for the arms and then the bit run; the
   CPU's arms run meanwhile (``run_elastic_cells``), with their traces
   apart. (a) The JAX package's reshape arm at N 4 (r 2, 6 steps where
   the JAX package's cells run 24, the kill at step 4 where they kill at
   8, seq 32, int8 EF)
   on the card, each rank running ``elastic_cells_on_ranks`` (what
   ``run_elastic_cells`` runs on a rank), against the same cell at smoke
   size on four CPU ranks: failures, wipe-outs, reshapes, final DP,
   steps, recompiles, cache entries, rollback steps, outage and the
   modeled TTT equal; every loss finite; 0 wipe-outs, DP 4 -> 2, cache
   shapes (2, 1) and (4, 1), its TTT below the restart arm's (run on the
   CPU ranks). The mask and restart arms are cut from the card for the
   script's time (``elastic_cells``). (b)
   Bit-transparency on the card: 2 steps, ``reshape([0, 1])`` (the
   survivors' params and moments unchanged by checksum, err1 kept, each
   half of err2 the old chunk it came from, by checksum), 2 steps at DP
   2 (a snapshot at their start), ``restore_full_mesh`` and the
   rollback (all four ranks hold rank 2's snapshot, the rejoining ranks'
   err1 is zero, err2 re-sliced). (c) K1, K1-bwd, K2 and K2-bwd launch
   on every rank of every arm, K3a and K3b exactly twice a bucket for
   every step the rank ran; the counts, set to 0 in each rank just
   before its run and read just after, sum into the kernel table.
   Prints per arm the seconds, the step seconds before and after the
   kill (the arm's trace), the reshape's wall seconds, peak device
   memory per rank and each rank's host RSS at the end of its run; for
   (b), from each rank's deep telemetry, the step seconds and the
   sync's share of a step at DP 4 and DP 2 (the ``grad_sync`` spans in
   each ``compute`` span), and the wall seconds of the reshape, the
   restore and the rollback with their parts (the elastic executor's
   ``reshape/*``, ``restore/*`` and ``rollback/*`` spans: group build,
   state broadcast, EF move).

15. **families** — the two-matrix MLPs and the ``embeds=`` frontends:
   starcoder2-7b (gelu), minitron-4b (relu2), qwen2-vl-2b (vlm
   frontend), musicgen-medium (audio frontend, gelu, MHA at head dim 64)
   and glm4-9b, at published width with random bf16 weights from seed 0
   (``FAMILY_DEPTHS``, ``FAMILY_SERVE``, ``FAMILY_TRAIN``). For each:
   (a) the token path's prefill logits in fp32 at 2 layers, card
   against CPU, within 1e-4; (b) for the two frontends,
   ``forward(embeds=embed[tokens].float())`` equal to
   ``forward(tokens)`` bit for bit in bf16 at full depth; (c) serving at
   full depth, 2 replicas x 8 slots, one bucket of 128, 16 requests of 16
   new tokens, replica 0 killed at server step 6: the slice phase's
   gates (no drop, no rebuild, identical tokens, exact K1 and K2
   counts, decode against prefill); (d) training through the int8-EF
   ``MeshExecutor`` on a one-rank NCCL group, 2,048 tokens a
   microbatch, 6 steps, group 0 killed at poll 4 (masked), 2 layers
   each; finite losses, the report equal to the script, exact K1,
   K1-bwd, K2, K2-bwd, K3a and K3b counts; a frontend's batches carry
   ``embeds``. Logs each config's seconds.

16. **hybrid** — jamba-v0.1-52b (``HYBRID``): the MoE FFN and the
   hybrid period at published width, random bf16 weights from seed 0.
   (a) one ``mamba_moe`` and one ``attn_dense`` block in fp32 over 96
   positions, card against CPU, within 1e-4 of the largest |ref|; every
   token routed to the same experts on both, or, where not, with a gap
   between its k-th and (k+1)-th gate within twice the devices' gate
   difference (then left out of the comparison); (b) one MoE layer over
   128 tokens on the card, the grouped dispatch against the dense
   oracle: fp32 output and the gradients of x, router and experts within
   1e-5, bf16 within 2^-7 of the largest |ref|; both timed in bf16; (c)
   serving at 16 layers (two periods) with ``FAMILY_SERVE``: the slice
   phase's gates, with K1 3 a Mamba block, 2 an attention block and 1 a
   prefill or decode step (47), K2 2 and K4 14 a prefill; (d) the
   kernel phase checks K1, K2 and K4 at jamba's shapes
   (``hybrid_kernel_checks``); (e) both launchers on jamba's smoke
   configuration, the train launcher through ``--mesh --grad-compress
   int8_ef`` (the MoE backward, K2-bwd, K4-bwd at N 16 and K3 on the
   card), in a whole run with the cli phase's. Prints tok/s, p50 and
   p99, the peak GiB and the phase's seconds.

17. **mla** — deepseek-v2-lite-16b (``MLA``): MLA attention (the JAX
   package's absorbed latent form, plain products: no mixer kernel) and
   the ``moe`` family at published width, random bf16 weights from seed
   0. (a) its ``attn_dense`` and ``attn_moe`` blocks and deepseek-v3's
   MLA mixer (d 7168, 128 heads, compressed queries through q_norm at
   1536) in fp32 over 32 positions, card against CPU, within 1e-5 of
   the largest |ref|, with no token of the MoE layer routed to other
   experts; (b) serving at full depth (27 layers) with ``FAMILY_SERVE``:
   the slice phase's gates (no drop, no rebuild, identical tokens
   through the kill, decode against prefill, the write guard reading the
   latent's length), K1 exactly 3L + 1 = 82 a prefill or decode step,
   K2 and K4 never; the init's and serving's peak device memory each
   within 75 GiB; (c) training at 4 layers (one dense, three MoE blocks)
   with ``FAMILY_TRAIN``: the train phase's gates, K1-bwd 3L + 1 a
   microbatch, K3a and K3b twice a bucket a step; (d) the kernel phase
   checks K1 on the latent (512) and at deepseek-v3's 1536, K1-bwd at
   512, K3a and K3b at the 4-layer layout's largest buckets
   (``mla_kernel_checks``); (e) both launchers on deepseek-v2-lite's
   smoke configuration, the train launcher through ``--mesh
   --grad-compress int8_ef``, and both launchers on deepseek-v3-671b's
   (q_lora; its bf16 accumulator and moments), in a whole run with the
   cli phase's.
   Prints tok/s, p50 and p99, the peak GiB, the training step and the
   phase's seconds.

18. **v3 train** — deepseek-v3-671b (``V3_TRAIN``) at published width
   (d 7168, MLA with 128 heads and q_lora 1536, dense SwiGLU 18432,
   vocab 129280, untied), random bf16 weights from seed 0, trained with
   its own settings: a bf16 gradient accumulator, bf16 AdamW moments and
   the int8-EF sync through the ``MeshExecutor`` on one NCCL rank. Its
   three dense blocks (3.607B parameters) unless the state reckoned from
   the leaves (printed) or the measured peak passes 75 GiB, then 2.
   FAMILY_TRAIN's microbatch; group 0 killed at the first poll (two
   microbatches a step), a wipe-out at poll 3 rolled back to step 0,
   group 0 killed again at the poll after; 6 steps after the rollback.
   Gates: the train phase's (finite losses, the report equal to the
   script, the rollback bit-identical to the snapshot, the replayed
   step's loss its first execution's, exact K1 (4L+1 a pass), K1-bwd,
   K3a and K3b counts, K2 at 0) and the bf16 settings' (``v3_gates``):
   before the run, the step's own accumulator over two microbatches bit
   for bit the in-order bf16 sum of each microbatch's gradient rounded
   to bf16 (an fp32 accumulator fails it); on the first step, the
   gradients AdamW receives bf16 and each bucket's leaves the bf16
   rounding of what the sync left in it; the snapshot's moments and the
   accumulator bf16; every step two microbatches. Prints the step, the
   logical batch's tokens/s, the sync's share, the peak and reckoned
   GiB, the snapshot's GiB and seconds, the rollback's and the phase's
   seconds.

19. **tp** — tensor and expert parallelism (``TP``, ``EP``) on the
   elastic phase's four ranks (in a whole run the same spawn, after its
   bit run), a grid of data 2 x model 2 sharing the card over gloo; the
   CPU's arms at smoke size meanwhile on four CPU ranks. (a) Full-width
   qwen2.5-3b at 2 layers (the reckoning printed: four ranks' state
   under each arm and their contexts within 75 GiB), N 4, r 2, 2 x 256
   tokens a rank's microbatch, through both of the ``MeshExecutor``'s
   syncs at model degree 2: ``shard_map`` with the int8 EF sync (the
   model ranks of a data slice replicas) and ``gspmd`` with fp32
   buckets (the column blocks on the model group, gathered each step).
   Each arm: the first step's whole gradient (``mesh_grads``) against a
   one-rank executor's with fp32 buckets on rank 0 (a one-rank NCCL
   group), within ``TP_GRAD_TOL`` (``gspmd``) or the §3.1 sweep's int8
   oracle; then 5 steps with group 0 killed at poll 2 (masked, ``S_A``
   2) and a wipe-out at poll 4 rolled back to step 3. Gates: each
   rank's report (failures, wipe-outs, steps, rollback steps, ``S_A``
   by step, events) equal to the same script's on the CPU ranks; every
   loss finite and the same on every rank; the rollback bit-identical
   to the snapshot and the replayed step's loss its first execution's
   (at the healthy ``S_A`` 1 where it first ran masked at 2: within
   ``TP_REPLAY_TOL``);
   after every step the two model ranks of a data slice bit-identical
   under ``shard_map`` and different (each its block) under ``gspmd``;
   a rank's stored params and moments exactly the bytes reckoned from
   the leaves; K1 4L+1, K1-bwd 2L+1, K2 2L and K2-bwd L a microbatch,
   K3a and K3b twice a bucket a step on the int8 arm and never under
   ``gspmd``, counted from 0 in each rank around its run. (b)
   deepseek-v2-lite-16b's MoE layer at published width (64 experts
   top-6, d_expert 1408, 2 shared) on the model group of ranks 0 and 1,
   each holding its 32 experts and its shared-expert slice alone, at 128
   and 8 tokens in bf16 and fp32, forward and backward, against the
   expert-parallel body on a one-rank group (all 64 experts, the same
   capacity, so the same drops): the output and every gradient within
   ``EP["tol"]`` of the largest |one-rank| element; the drops printed,
   and some case must drop; then its first two blocks (dense, MoE) in
   fp32 built on the model group against the same model on the one-rank
   group: the loss and every gradient within ``EP["model_tol"]``, K1
   and K1-bwd at the exact counts of two passes. Prints per arm the
   step seconds and the sync's share (the data group's buckets and the
   gathers, host time to a synchronise), the gradient's distance, a
   rank's stored GiB, peak device memory and RSS per rank; for (b) each
   rank's expert bytes, the drops and each case's milliseconds. (c)
   The elastic tier on the same grid (``TP_ELASTIC``), at the same
   width and depth: the cell ``elastic_regime_cells(n=2, r=1,
   model_degree=2, steps=12)``, its ``mask`` arm, under ``shard_map``
   with the int8 EF sync (group 0 killed at step 8, unmaskable at r 1:
   the policy reshapes DP 2 -> 1 onto row 1's two ranks; N 2 because six
   or eight ranks at full width do not fit the host, and r 2 needs N >=
   3): its row equal to the same cell's on the four CPU ranks (failures,
   wipe-outs, reshapes, final DP, outage, modeled TTT and the rest of
   ``ELASTIC_SAME``), every loss finite, the cache keys ``(2, 2, .)``
   and ``(1, 2, .)``, each rank's kernels exact for the steps its row
   ran. Then, in both syncs, 2 steps (2 x 256 tokens a rank), ``reshape
   ([0])``, 2 steps at DP 1 (4 x 256), ``restore_full_mesh`` and the
   rollback, gated per model column by checksum: the survivors' params
   and moments unchanged by the reshape, ``err1`` kept and ``err2``
   re-sliced; a row's two ranks replicas under ``shard_map`` and
   different blocks under ``gspmd``; after the restore and the rollback
   every rank holds its column's snapshot of row 1; K1, K1-bwd, K2 and
   K2-bwd exact per rank, K3a and K3b twice a bucket a step it ran
   (none under ``gspmd``). Prints the cell's row and seconds, the step
   seconds and the sync's share at DP 2 and DP 1, and the reshape,
   restore and rollback seconds with their parts. (d) The FSDP x TP step
   (``FSDP_TP``), the program the dry run traces: the same four ranks as
   the rule table's (data 2, model 2) grid (``build_model(cfg, mesh=
   groups)``, ``make_train_step(model, grad_shardings=model.specs)``),
   qwen2.5-3b at published width and 2 layers, random bf16 weights from
   a seed, each rank storing only its blocks; 2 x 256 tokens a rank, 3
   steps on the §3.1 weight tables of a healthy, a masked and a healthy
   step (the second recorded). Gates: the first step's gradient,
   gathered whole between its two halves (``step.grads``,
   ``step.update``), against a one-rank ``make_train_step`` on the card
   within ``FSDP_TP["grad_tol"]`` times the one-rank bf16 gradient's own
   distance from the same step in fp32 (and below 2^-4 of the largest
   element), and the three losses within ``FSDP_TP["loss_tol"]``
   relative (the bf16 roundings the split adds, see there); each rank's stored bytes (its blocks,
   moments, batch and the step counter) equal to the dry run's
   ``arg_bytes`` for the same grid, config and rank, exactly; each
   rank's ``max_memory_allocated`` over the steps (from a reading taken
   before the state was placed) within the dry run's ``peak_bytes`` +-
   (10% + 256 MiB), the gap printed; each rank's recorded collective
   schedule equal to the dry run's trace of that rank; K1, K1-bwd, K2 and
   K2-bwd launched on the path (``fsdp_tp``, counted from 0 around the
   three steps). The dry runs run meanwhile in a process of their own
   (no card, no group), with (e): the production cell
   ``run_cell("qwen2.5-3b", "train_4k", multi_pod=False)`` at full
   depth and width, ``ok`` and its ``peak_bytes`` under 75 GiB; its
   record and seconds printed.

20. **audit** — the §3.1 certification and the static audit
   (``AUDIT``), in the JAX lint's terms: (a) the AST passes
   (``repro_torch.analysis``) over the port's files, 0 violations; (b)
   the lint's certification target set (``repro_torch.launch.lint
   .certify_executors``) with CUDA tensors through the kernels, each
   rank of each grid on torch's fake process group in turn (8 ranks
   sharing the card; the collectives move nothing, the schedule is each
   rank's own): the ``MeshExecutor`` in ``shard_map``, ``gspmd`` and
   ``shard_map`` + int8 EF at smoke qwen2.5-3b (N 4, r 2, model degree
   2), every recoverable survivor set on every rank; the elastic
   executor at N 8 reshaped past ``[0, 1]``, with and without int8 EF;
   the demoted set and the re-admission's restored table; the trainer's
   step; a warmed ``ServeEngine``'s three callables. Each audited step
   is recorded (``repro_torch.launch.steplog``) under
   ``torch.cuda.set_sync_debug_mode``, the sweep's steps for their
   collectives only; 0 violations, and one ``[audit]``
   line a target (survivor sets and programs certified, leaves audited
   in place, host syncs, violations). (c) At published width,
   qwen2.5-3b at 2 layers, N 4, r 2, the int8 EF sync in 32 MiB buckets,
   2 x 256 tokens a rank: the step passes and the schedule sweep on ranks
   0 and 3 of a fake grid of 4; the int8/fp32 wire bytes at most 0.3;
   ``survivor_set_sweep`` on a real one-rank NCCL group, every check
   within 5e-3 with fp32 buckets and within ``int8_sweep_tolerance(1)``
   with int8 EF. K1, K1-bwd, K2, K2-bwd, K3a and K3b must launch
   (counted from 0 around the phase: the ``audit`` path). Prints the
   phase's seconds.

Prints the kernel table as one JSON line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Details
go to ``chiprun_out/chip_smoke.json``. ``--phase kernels`` stops after
the kernel phase; ``--phase train`` runs the build, the train phase and
the failure tiers only; ``--phase ssm-train`` the build, K4-bwd's
kernel checks and the ssm train phase; ``--phase campaign`` the build
and the campaign phase only; ``--phase elastic`` the build and the
elastic phase only; ``--phase families`` the build, the families'
kernel checks and the families phase; ``--phase hybrid`` the build,
jamba's kernel checks and the hybrid phase; ``--phase mla`` the build,
deepseek's kernel checks and the MLA phase; ``--phase v3-train`` the
build, deepseek-v3's training kernel checks and the v3 train phase;
``--phase tp`` the build, the tp path's kernel checks and the tp phase
on four ranks of its own; ``--phase audit`` the build and the audit
phase;
``--phase profile`` only profiles a serving decode step and prefill of
both full-width models and a training step of each
(``chiprun_out/chip_profile.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the training state fills most of the card: let the caching allocator
# grow segments instead of fragmenting (read when torch first allocates)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12         # fp32 outside the tensor cores
SPIN_CYCLES = 20_000_000  # ~10 ms of the SM clock; grown 4x where short
ARCH = "qwen2.5-3b"
SSM_ARCH = "mamba2-1.3b"
SERVE = dict(replicas=2, slots=8, page_size=16, buckets=(128, 512),
             max_new=32, requests=16, kill_step=10, seed=0)
# the training path: 8 groups x 1 example x 256 tokens = 2048 tokens per
# microbatch; a group dies at poll 2 (masked), a set that wipes the
# system out at poll 5 (rollback to the snapshot taken at step 0)
TRAIN = dict(n_groups=8, r=2, per_type_batch=1, seq=256, steps=8,
             kill_poll=2, wipe_poll=5, seed=0, depths=(36, 24, 18, 12),
             mem_limit_gib=75.0, bucket_mb=32.0)
# the failure tiers: group 3 at 3x over polls 0-2 (flagged, demoted,
# re-admitted once it heals), group 0 killed at poll 13 (masked), at
# poll 14 a group that wipes the system out (rollback to the snapshot of
# step 12); snapshots every 6 steps, each written to disk (the Eq.-1
# interval with t_save 1e-12 s is ~1e-4 s); keep 1 checkpoint on disk.
# The phase writes two checkpoints; write_budget_gib caps what it may
# write in one run (deleted files included), below the disk's free space.
# depths: 4 layers first, for the script's time (at 18, 140 s of the
# 1,282 s a whole run took with the hybrid phase on one H100; 6 until
# the MLA phase came, 62 s of a 1,136.6 s run), then 2
#: the SSM training path: mamba2-1.3b, 8 groups x 1 example x 512 tokens =
#: 4,096 tokens per microbatch (two chunks of 256: the state's gradient
#: crosses a chunk boundary), the kills of TRAIN, depth 48 unless peak
#: device memory passes the limit
SSM_TRAIN = dict(TRAIN, seq=512, depths=(48, 36, 24))
FAILURE = dict(steps=15, snapshot_every=6, slow_group=3, slow_factor=3.0,
               slow_from=0, slow_until=3, kill_poll=13, wipe_poll=14,
               mtbf=300.0, t_save=1e-12, t_restart=3600.0, keep=1,
               depths=(4, 2), write_budget_gib=36.0)
GIB = float(1 << 30)
#: the families phase (15): five dense configs at published width, random
#: bf16 weights from seed 0, each with its training depth: 2 layers.
#: starcoder2-7b, minitron-4b and glm4-9b fit only ~13, ~21 and ~10
#: layers of training state under the 75 GiB limit and their snapshots
#: would cost 20-30 s each; qwen2-vl-2b and musicgen-medium trained at
#: full depth (28, 48) until the hybrid phase came, then 4, for the
#: script's time (their snapshots took 13-17 s), and all five 2 once the
#: MLA phase came (the phase took 131 s of a 1,136.6 s run at 4). Their
#: width, what the phase ports, is the same at any depth
FAMILY_DEPTHS = {"starcoder2-7b": 2, "minitron-4b": 2, "qwen2-vl-2b": 2,
                 "musicgen-medium": 2, "glm4-9b": 2}
#: serving: one bucket of 128, 16 requests of 16 new tokens (every slot
#: of both replicas busy: 256 token latencies a run), replica 0 killed at
#: server step 6
FAMILY_SERVE = dict(SERVE, buckets=(128,), max_new=16, requests=16,
                    kill_step=6)
#: training: the train phase's set-up (2,048 tokens a microbatch, int8
#: EF), 6 steps, group 0 killed at poll 4 (masked), no wipe-out: three
#: S_A = 1 steps after the first and two masked ones to time
FAMILY_TRAIN = dict(TRAIN, steps=6, kill_poll=4, wipe_poll=None)
HYBRID_ARCH = "jamba-v0.1-52b"
#: the hybrid phase (16): jamba-v0.1-52b at published width, random bf16
#: weights from seed 0, two periods (16 layers: 26.0B parameters, ~52 GB;
#: all 32 layers would need ~103 GB); the fp32 block references over 96
#: positions, one MoE layer against its dense oracle over 128 tokens,
#: serving with FAMILY_SERVE
HYBRID = dict(depth=16, ref_positions=96, moe_tokens=128, seed=0)
#: the hybrid phase's launcher runs (``python -m`` arguments) on jamba's
#: smoke configuration; in a whole run they start with the cli phase's
HYBRID_CLIS = {
    "train_hybrid": ["repro_torch.launch.train", "--arch", HYBRID_ARCH,
                     "--steps", "4", "--n-groups", "4", "-r", "2", "--seq",
                     "64", "--per-type-batch", "1", "--mtbf-steps", "2",
                     "--mesh", "--grad-compress", "int8_ef"],
    "serve_hybrid": ["repro_torch.launch.serve", "--arch", HYBRID_ARCH,
                     "--replicas", "2", "--requests", "8", "--kill", "3:0"]}
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_V3_ARCH = "deepseek-v3-671b"
#: the MLA phase (17): deepseek-v2-lite-16b at published width, random
#: bf16 weights from seed 0: the fp32 block references over 32 positions
#: (its attn_dense and attn_moe blocks, and deepseek-v3-671b's MLA mixer
#: with its compressed queries), serving at full depth (27 layers, 15.71B
#: parameters, 29.3 GiB) with FAMILY_SERVE, training at 4 layers (one
#: dense block and three MoE blocks, 2.26B parameters: ~18 B a
#: parameter of state, 8 layers would need ~83 GB) with FAMILY_TRAIN
MLA = dict(ref_positions=32, train_depth=4, seed=0, mem_limit_gib=75.0)
#: the MLA phase's launcher runs, as :data:`HYBRID_CLIS`; deepseek-v3's
#: train run takes its bf16 accumulator and moments
MLA_CLIS = {
    **{name: ["repro_torch.launch.train", "--arch", arch, "--steps", "4",
              "--n-groups", "4", "-r", "2", "--seq", "64",
              "--per-type-batch", "1", "--mtbf-steps", "2", "--mesh",
              "--grad-compress", "int8_ef"]
       for name, arch in (("train_mla", MLA_ARCH),
                          ("train_mla_v3", MLA_V3_ARCH))},
    "serve_mla": ["repro_torch.launch.serve", "--arch", MLA_ARCH,
                  "--replicas", "2", "--requests", "8", "--kill", "3:0"],
    "serve_mla_v3": ["repro_torch.launch.serve", "--arch", MLA_V3_ARCH,
                     "--replicas", "2", "--requests", "8", "--kill",
                     "3:0"]}


#: the v3 training phase (18): deepseek-v3-671b at published width (d
#: 7168, MLA with 128 heads and q_lora 1536, dense SwiGLU 18432, vocab
#: 129280, untied), random bf16 weights from seed 0, trained with its own
#: settings: a bf16 gradient accumulator, bf16 AdamW moments and the
#: int8-EF sync through the MeshExecutor on one NCCL rank. Its three
#: dense blocks (first_k_dense 3: 583.5M parameters a block; with 1.85B
#: of embedding and head, 3.60B), or 2 (3.02B) if the reckoned state or
#: the measured peak passes the limit; no MoE block (one holds 11.3B
#: expert parameters). FAMILY_TRAIN's microbatch (2,048 tokens); group 0
#: killed at the first poll (S_A 2: two microbatches a step), a group
#: that wipes the system out at poll 3 (rollback to step 0), group 0
#: killed again at the poll after, so the replayed steps run two
#: microbatches too; 6 steps after the rollback
V3_ARCH = MLA_V3_ARCH
V3_TRAIN = dict(FAMILY_TRAIN, steps=6, kill_poll=0, wipe_poll=3,
                rekill=True, depths=(3, 2))
#: the cli phase's gate on the card's train launcher against the same
#: command with --device cpu: the card draws its init from the CUDA
#: generator, the CPU from its own, so the first losses differ by the
#: init; four CPU seeds of that command gave 6.2390-6.2574 (ln 512 =
#: 6.2383)
CLI_FIRST_LOSS_TOL = 0.05


def launcher_runs(table: dict) -> dict:
    """``table``'s launcher arguments as commands of this interpreter."""
    return {name: [sys.executable, "-m", *args]
            for name, args in table.items()}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, iters: int = 50, warmup: int = 3) -> tuple[float, float]:
    """``(device ms, host ms)`` per call of ``fn()``.

    A spin kernel holds the stream while the host queues all ``iters``
    calls, so the CUDA events around them time the device's work alone,
    back to back, not the host's launch rate; the host clock around the
    queueing gives the host's cost per call. Raises if the host could not
    queue everything before the spin ended.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = SPIN_CYCLES
    for _ in range(4):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters, host_ms / iters
        cycles *= 4
    raise AssertionError("the host could not queue the calls within the "
                         "spin; device time not measured")


def cuda_ms(fn) -> float:
    """Device time of ``fn()`` in ms (see :func:`timed`)."""
    return timed(fn)[0]


def bound(nbytes: float, flops: float,
          peak: float) -> tuple[float, str]:
    """Least time in ms: bytes over the memory rate or operations over
    ``peak`` (the card's rate for their type), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ #
# build                                                              #
# ------------------------------------------------------------------ #
#: per CUDA source, the bf16 kernels that must run their products on the
#: tensor cores, and the template values each is built for: K2 and
#: K2-bwd's two product passes per head dim, K4 per state dim
TENSOR_CORE_KERNELS = {
    "flash_attention": (("fa_fwd_bf16", "fa_bwd_dkdv_bf16", "fa_bwd_dq_bf16"),
                        (64, 128)),
    "ssd_scan": (("ssd_scan_bf16",), (16, 32, 64, 128)),
    "ssd_scan_bwd": (("sweep_bf16", "dxdb_bf16", "dc_bf16"), (64, 128))}


def cuobjdump() -> str:
    """``cuobjdump``: on ``PATH``, else in the CUDA toolkit's ``bin``,
    else under Triton's ``backends/nvidia/bin``."""
    import importlib.util
    import shutil

    from repro_torch.kernels import _build

    found = shutil.which("cuobjdump")
    if found:
        return found
    toolkit = Path(_build._nvcc()).parent / "cuobjdump"
    if toolkit.exists():
        return str(toolkit)
    spec = importlib.util.find_spec("triton")
    for loc in (spec.submodule_search_locations or []) if spec else []:
        path = Path(loc) / "backends" / "nvidia" / "bin" / "cuobjdump"
        if path.exists():
            return str(path)
    raise AssertionError("cuobjdump not found on PATH, in the CUDA "
                         "toolkit or in Triton's package")


def tensor_core_sass() -> dict:
    """Count the tensor-core instructions (``HGMMA`` or ``HMMA``) in the
    SASS of each bf16 kernel of ``TENSOR_CORE_KERNELS``, per template
    value, in the built libraries; fail unless every one of them has
    some."""
    import re

    from repro_torch.kernels import _build

    counts, want = {}, []
    for lib, (kernels, values) in TENSOR_CORE_KERNELS.items():
        want += [f"{k}<{v}>" for k in kernels for v in values]
        sass = subprocess.run(
            [cuobjdump(), "-sass", str(_build.build(lib))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        name = None
        for line in sass.splitlines():
            fn = re.search(r"Function : \S*?(\w+_bf16)ILi(\d+)E", line)
            if fn and fn.group(1).endswith(kernels):
                base = next(k for k in kernels if fn.group(1).endswith(k))
                name = f"{base}<{fn.group(2)}>"
                counts[name] = 0
            elif "Function : " in line:
                name = None
            elif name and re.search(r"\bHG?MMA\.", line):
                counts[name] += 1
    missing = [k for k in want if not counts.get(k)]
    if missing:
        raise AssertionError(f"no HGMMA/HMMA in the SASS of {missing} "
                             f"(counts {counts})")
    return counts


def build_kernels() -> dict:
    import torch

    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    # Triton compiles on first launch: K1-bwd
    x = torch.ones((2, 64), dtype=torch.bfloat16, device="cuda",
                   requires_grad=True)
    w = torch.ones(64, device="cuda", requires_grad=True)
    ops.rmsnorm(x, w).sum().backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ptxas = {name: _build.ptxas_log(name) for name in _build.SOURCES}
    for name, text in ptxas.items():
        log(f"[build] {name}: {text.strip()}")
    log(f"[build] kernels built in {secs:.1f} s")
    sass = tensor_core_sass()
    print(f"[sass] tensor-core instructions (HGMMA/HMMA) per bf16 flash "
          f"attention, SSD scan and SSD scan backward kernel: "
          f"{json.dumps(sass)}", flush=True)
    return {"seconds": secs, "ptxas": ptxas, "tensor_core_sass": sass}


def bf16_ulps(out, ref) -> float:
    """The largest error of a row of ``out`` against ``ref`` (the last
    axis is the row), in bf16 ulps at that row's largest ``|ref|``
    (2**-7 of it). Two fp32 results that differ only by summation order
    land at most one ulp apart once rounded to bf16, so a kernel is
    within tolerance at <= 1 in every row, whatever the row's scale."""
    o, r = out.float(), ref.float()
    err = (o - r).abs().amax(-1)
    ulp = 2.0 ** -7 * r.abs().amax(-1)
    return (err / ulp.clamp_min(1e-30)).max().item()


def same_bits(a, b) -> bool:
    """Bit-identical fp32 tensors, a NaN equal to a NaN in the same place
    (the payload of a NaN is not part of the contract)."""
    import torch

    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32))


# ------------------------------------------------------------------ #
# kernel phase                                                       #
# ------------------------------------------------------------------ #
def check_rmsnorm(cfg, row_shapes) -> dict:
    """K1 at each (rows, D) of ``row_shapes``; the main shape is the
    longest prompt bucket at ``cfg``'s width. Beside each device time,
    the host's cost per call and the launch floor (the device time of an
    empty kernel, timed the same way); a second call must give the same
    bits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    floor_ms, floor_host_ms = timed(lambda: torch.cuda._sleep(0))
    shapes, worst = [], 0.0
    for rows, d in row_shapes:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.rand((d,), generator=gen, device="cuda") + 0.5
        y = ops.rmsnorm(x, w, eps=cfg.norm_eps)
        ref = rmsnorm_ref(x, w, cfg.norm_eps)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        # one bf16 ulp at each row's largest output: the kernel's rsqrt
        # and sum order may move a value across a bf16 rounding boundary
        ulps = bf16_ulps(y, ref)
        if not ulps <= 1.0 or not torch.isfinite(y).all():
            raise AssertionError(f"rmsnorm ({rows}, {d}): {ulps} bf16 ulps "
                                 f"(max err {err}) > 1")
        if not torch.equal(y.view(torch.int16), ops.rmsnorm(
                x, w, eps=cfg.norm_eps).view(torch.int16)):
            raise AssertionError(f"rmsnorm ({rows}, {d}): a second call "
                                 f"gave other bits")
        wb = w.to(torch.bfloat16)
        nbytes = 2 * rows * d * 2 + d * 4
        # the math is fp32 whatever x's dtype
        b_ms, b_by = bound(nbytes, 4 * rows * d, FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: ops.rmsnorm(x, w, eps=cfg.norm_eps))
        shapes.append({
            "shape": [rows, d], "tokens": rows, "dtype": "bfloat16",
            "main": (rows, d) == (max(SERVE["buckets"]), cfg.d_model),
            "max_abs_err": err, "max_row_ulps": ulps,
            "tol": "1 bf16 ulp per row", "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(lambda: rmsnorm_ref(x, w, cfg.norm_eps)),
            # yardstick: F.rms_norm takes the weight in x's dtype
            "library_ms": cuda_ms(
                lambda: F.rms_norm(x, (d,), wb, cfg.norm_eps)),
            "bound_ms": b_ms, "bound_by": b_by,
            "launch_floor_ms": floor_ms,
            "launch_floor_host_ms": floor_host_ms})
        worst = max(worst, err)
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:44",
            "max_abs_err": worst, "shapes": shapes}


#: the route each dtype takes through K2 and K2-bwd on the card
FLASH_ROUTES = {"bfloat16": "tensor cores (wgmma bf16 -> fp32, cp.async "
                            "tiles)",
                "float32": "CUDA cores (fp32 fmaf)"}
#: the route each dtype takes through K4 on the card
SSD_ROUTES = {"bfloat16": "tensor cores (wgmma bf16 -> fp32, cp.async "
                          "tiles; fp32 operands as bf16 parts)",
              "float32": "CUDA cores (fp32 fmaf)"}


def check_flash(cfg, cases) -> dict:
    """K2's forward at each ``(batch, seq, dtype)`` of ``cases``; the
    main shape is the longest prompt bucket, one sequence, in bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_ref

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes, worst = [], 0.0
    for b, s, dtype in cases:
        # the model's (B, S, H, dh) activations, passed transposed
        q = torch.randn((b, s, h, dh), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        k = torch.randn((b, s, kv, dh), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        v = torch.randn((b, s, kv, dh), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        out = ops.flash_attention(q, k, v)
        ref = flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # bf16: fp32 math in another summation order, then one rounding,
        # so one bf16 ulp at each (head, position) row's largest output
        # (late rows average many values and are small: an absolute
        # tolerance would not see them); fp32: summation order only
        if dtype == torch.bfloat16:
            ulps, tol = bf16_ulps(out, ref), "1 bf16 ulp per row"
            ok = ulps <= 1.0
        else:
            ulps, tol = None, 1e-5
            ok = err <= tol
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention B={b} S={s} {dtype}: "
                                 f"max err "
                                 f"{err}, {ulps} bf16 ulps; tol {tol}")
        if not same_bits(out.float(), ops.flash_attention(q, k, v).float()):
            raise AssertionError(f"flash_attention B={b} S={s} D={dh} "
                                 f"{dtype}: a second call gave other bits")
        esize = q.element_size()
        nbytes = b * (2 * s * h * dh + 2 * s * kv * dh) * esize
        flops = b * 4 * h * dh * s * (s + 1) / 2
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: ops.flash_attention(q, k, v))
        dname = str(dtype).replace("torch.", "")
        shapes.append({
            "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": dh},
            "tokens": b * s,
            "main": (b, s) == (1, max(SERVE["buckets"]))
            and dtype == torch.bfloat16,
            "dtype": dname, "dtype_route": FLASH_ROUTES[dname],
            "max_abs_err": err, "max_row_ulps": ulps, "tol": tol,
            "same_bits_again": True, "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by})
        worst = max(worst, err)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:98",
            "dtype_routes": FLASH_ROUTES, "max_abs_err": worst,
            "shapes": shapes}


def grad_timer(outputs, inputs, grad_out):
    """A call that runs autograd's backward of an already built graph
    (kept with ``retain_graph``): the plain version's and the library's
    backward, timed alone."""
    import torch

    return lambda: torch.autograd.grad(outputs, inputs, grad_out,
                                       retain_graph=True)


def check_rmsnorm_bwd(cfg, cases) -> dict:
    """K1-bwd at each (rows, width) of ``cases``, the first the training
    shape (the main one): dx within one bf16 ulp of each row's largest
    |ref|, dw within 1e-5 of max|dw_ref|, against autograd through the
    plain version; and K1's forward at each shape, as the training path
    calls it, within one bf16 ulp per row. At every shape a second call
    gives the same bits; at the first the row pass and the dw pass are
    also timed apart."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_dw,
                                             rmsnorm_bwd_rows,
                                             rmsnorm_bwd_triton, rmsnorm_ref)

    eps = cfg.norm_eps
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes, worst = [], 0.0
    for n, width in cases:
        x0 = (torch.randn((n, width), generator=gen, device="cuda") * 2).to(
            torch.bfloat16)
        w0 = torch.rand((width,), generator=gen, device="cuda") + 0.5
        dy = torch.randn((n, width), generator=gen, device="cuda").to(
            torch.bfloat16)
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = ops.rmsnorm(x, w, eps=eps)
        y.backward(dy)
        xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        yr = rmsnorm_ref(xr, wr, eps)
        dx_ref, dw_ref = torch.autograd.grad(yr, (xr, wr), dy,
                                             retain_graph=True)
        torch.cuda.synchronize()
        fwd_ulps = bf16_ulps(y, yr)
        ulps = bf16_ulps(x.grad, dx_ref)
        dw_rel = ((w.grad - dw_ref).abs().max()
                  / dw_ref.abs().max()).item()
        err = (x.grad.float() - dx_ref.float()).abs().max().item()
        if not (fwd_ulps <= 1.0 and torch.isfinite(y).all()):
            raise AssertionError(f"rmsnorm (training forward) ({n}, "
                                 f"{width}): {fwd_ulps} bf16 ulps (> 1)")
        if not (ulps <= 1.0 and dw_rel <= 1e-5
                and torch.isfinite(x.grad).all()):
            raise AssertionError(f"rmsnorm_bwd ({n}, {width}): dx {ulps} "
                                 f"bf16 ulps (> 1) or dw rel err {dw_rel} "
                                 f"(> 1e-5)")
        main = (n, width) == cases[0]
        again = rmsnorm_bwd_triton(x0, w0, dy, eps)
        same = (torch.equal(again[0].view(torch.int16),
                            x.grad.view(torch.int16))
                and torch.equal(again[1].view(torch.int32),
                                w.grad.view(torch.int32)))
        if not same:
            raise AssertionError(f"rmsnorm_bwd ({n}, {width}): a second "
                                 f"call gave other bits")
        # read x, dy; write dx; read w, write dw (and its per-program
        # partials are the kernel's own traffic, not the function's)
        nbytes = 3 * n * width * 2 + 2 * width * 4
        b_ms, b_by = bound(nbytes, 10 * n * width, FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: rmsnorm_bwd_triton(x0, w0, dy, eps))
        xl = x0.clone().requires_grad_()
        wl = w0.to(torch.bfloat16).requires_grad_()
        yl = F.rms_norm(xl, (width,), wl, eps)
        shape = {"shape": [n, width], "tokens": n, "dtype": "bfloat16",
                 "main": main, "max_abs_err": err, "max_row_ulps": ulps,
                 "dw_rel_err": dw_rel, "forward_max_row_ulps": fwd_ulps,
                 "same_bits_again": same,
                 "tol": "dx 1 bf16 ulp per row; dw 1e-5 relative; forward "
                        "1 bf16 ulp per row; a second call the same bits",
                 "ms": ms, "host_ms": host_ms,
                 "plain_ms": cuda_ms(grad_timer(yr, (xr, wr), dy)),
                 "library_ms": cuda_ms(grad_timer(yl, (xl, wl), dy)),
                 "library": "autograd backward of F.rms_norm",
                 "bound_ms": b_ms, "bound_by": b_by}
        if main:
            _, partial = rmsnorm_bwd_rows(x0, w0, dy, eps)
            shape["rows_pass_ms"] = cuda_ms(
                lambda: rmsnorm_bwd_rows(x0, w0, dy, eps))
            shape["dw_pass_ms"] = cuda_ms(lambda: rmsnorm_bwd_dw(partial))
            shape["partial_rows"] = partial.shape[0]
            log(f"[kernels] rmsnorm_bwd ({n}, {width}): row pass "
                f"{shape['rows_pass_ms']:.5f} ms, dw pass "
                f"{shape['dw_pass_ms']:.5f} ms ({partial.shape[0]} partial "
                f"rows)")
        shapes.append(shape)
        worst = max(worst, err)
        del x, w, y, xr, wr, yr, xl, wl, yl, again
    return {"name": "rmsnorm_bwd", "route": "triton",
            "source": "src/repro_torch/kernels/rmsnorm.py",
            "replaces": "src/repro/kernels/rmsnorm.py:44",
            "max_abs_err": worst, "shapes": shapes}


def check_flash_bwd(cfg, cases, dtypes=("bfloat16", "float32")) -> dict:
    """K2-bwd at each ``(batch, seq)`` of ``cases`` (the first is the
    training shape, the main one), in each of ``dtypes``, against autograd
    through the plain version: fp32 dq/dk/dv within 1e-4 x max|ref| per
    tensor; bf16 within 2 bf16 ulps of each row's largest |ref| (fp32
    math in another order, then one rounding). The forward at each shape,
    as the training path calls it (it also writes the LSE and the fp32
    output for the backward), within 1 bf16 ulp per row in bf16 and
    1e-5 in fp32."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, flash_attention_ref)

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes, worst = [], 0.0
    for (batch, seq), dtype in ((c, getattr(torch, dt)) for c in cases
                                for dt in dtypes):
        # the model's (B, S, H, D) activations, passed transposed
        base = [torch.randn((batch, seq, n, dh), generator=gen,
                            device="cuda").to(dtype) for n in (h, kv, kv)]
        dout = torch.randn((batch, seq, h, dh), generator=gen,
                           device="cuda").to(dtype).transpose(1, 2)
        leaves = [t.clone().requires_grad_() for t in base]
        out = ops.flash_attention(*(t.transpose(1, 2) for t in leaves))
        out.backward(dout)
        ref_leaves = [t.clone().requires_grad_() for t in base]
        ref_in = [t.transpose(1, 2) for t in ref_leaves]
        ref_out = flash_attention_ref(*ref_in)
        refs = torch.autograd.grad(ref_out, ref_in, dout, retain_graph=True)
        torch.cuda.synchronize()
        fwd_err = (out.float() - ref_out.float()).abs().max().item()
        if dtype == torch.bfloat16:
            fwd_ulps = bf16_ulps(out, ref_out)
            fwd_ok, fwd_tol = fwd_ulps <= 1.0, "1 bf16 ulp per row"
        else:
            fwd_ulps, fwd_ok, fwd_tol = None, fwd_err <= 1e-5, 1e-5
        if not (fwd_ok and torch.isfinite(out).all()):
            raise AssertionError(
                f"flash_attention (training forward) B={batch} S={seq} "
                f"{dtype}: max err {fwd_err}, {fwd_ulps} bf16 ulps; tol "
                f"{fwd_tol}")
        errs, ulps = [], []
        for t, r in zip(leaves, refs):
            got = t.grad.transpose(1, 2)
            errs.append((got.float() - r.float()).abs().max().item())
            if dtype == torch.bfloat16:
                ulps.append(bf16_ulps(got, r))
            else:
                # one token's dq is exactly 0: no scale to divide by
                ulps.append(errs[-1] / max(r.float().abs().max().item(),
                                           1e-30))
        if dtype == torch.bfloat16:
            ok, tol = max(ulps) <= 2.0, "2 bf16 ulps per row"
        else:
            ok, tol = max(ulps) <= 1e-4, "1e-4 x max|ref| per tensor"
        if not ok or not all(torch.isfinite(t.grad).all() for t in leaves):
            raise AssertionError(f"flash_attention_bwd B={batch} S={seq} "
                                 f"{dtype}: dq/dk/dv {ulps} against {tol}")
        q, k, v = (t.transpose(1, 2) for t in base)
        _, lse, o32 = flash_attention_cuda(q, k, v, for_backward=True)
        again = flash_attention_bwd_cuda(q, k, v, o32, dout, lse)
        if not all(same_bits(a.float(), b.float()) for a, b in zip(
                again, flash_attention_bwd_cuda(q, k, v, o32, dout, lse))):
            raise AssertionError(f"flash_attention_bwd B={batch} S={seq} "
                                 f"D={dh} {dtype}: a second call gave other "
                                 f"bits")
        del again
        esize = q.element_size()
        # the forward as the training path calls it: it also writes the
        # fp32 output and the LSE for the backward
        fwd_bytes = (2 * batch * seq * h * dh + 2 * batch * seq * kv * dh) \
            * esize + batch * seq * h * dh * 4 + batch * h * seq * 4
        fwd_flops = batch * 4 * h * dh * seq * (seq + 1) / 2
        fwd_b_ms, fwd_b_by = bound(fwd_bytes, fwd_flops, BF16_FLOPS_PER_S
                                   if dtype == torch.bfloat16
                                   else FP32_FLOPS_PER_S)
        fwd_ms, fwd_host_ms = timed(lambda: flash_attention_cuda(
            q, k, v, for_backward=True))
        with torch.no_grad():
            fwd_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        # read q, k, v, dO, the fp32 output and LSE; write dq, dk, dv
        nbytes = (3 * batch * seq * h * dh + 4 * batch * seq * kv * dh) \
            * esize + batch * seq * h * dh * 4 + batch * h * seq * 4
        # recomputed scores, dP, dV, dK, dQ: five products over the
        # causal triangle
        flops = batch * 5 * 2 * h * dh * seq * (seq + 1) / 2
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: flash_attention_bwd_cuda(q, k, v, o32,
                                                             dout, lse))
        lib_leaves = [t.clone().requires_grad_() for t in base]
        lib_in = [t.transpose(1, 2) for t in lib_leaves]
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                                 enable_gqa=True)
        dname = str(dtype).replace("torch.", "")
        shapes.append({
            "shape": {"B": batch, "S": seq, "H": h, "KV": kv, "D": dh},
            "tokens": batch * seq, "dtype": dname,
            "dtype_route": FLASH_ROUTES[dname],
            "main": (batch, seq) == tuple(cases[0])
            and dtype == torch.bfloat16,
            "max_abs_err": max(errs), "dq_dk_dv_errs": errs,
            "max_row_ulps" if dtype == torch.bfloat16 else "rel_errs": ulps,
            "tol": tol, "forward_max_abs_err": fwd_err,
            "forward_max_row_ulps": fwd_ulps, "forward_tol": fwd_tol,
            "same_bits_again": True,
            "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(grad_timer(ref_out, ref_in, dout)),
            "library_ms": cuda_ms(grad_timer(lib_out, lib_in, dout)),
            "library": "autograd backward of scaled_dot_product_attention "
                       "(enable_gqa)",
            "bound_ms": b_ms, "bound_by": b_by,
            "forward": {"ms": fwd_ms, "host_ms": fwd_host_ms,
                        "library_ms": fwd_lib_ms,
                        "library": "scaled_dot_product_attention "
                                   "(enable_gqa), forward",
                        "bound_ms": fwd_b_ms, "bound_by": fwd_b_by,
                        "what": "flash_attention_cuda(for_backward=True): "
                                "the output, its fp32 copy and the LSE"}})
        worst = max(worst, max(errs))
        del out, leaves, ref_leaves, lib_leaves, ref_out, lib_out, refs
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:98",
            "dtype_routes": FLASH_ROUTES, "max_abs_err": worst,
            "shapes": shapes}


def check_ssd_scan(cfg, cases=None) -> dict:
    """K4 at the mamba2-1.3b prefill shapes and at the training microbatch
    (B 8, S 512), or at ``cases`` ((B, H, G, S, P, N, dtype) each; the
    model's (B, S, H, P) and
    (B, S, G, N) activations, passed transposed, dt as the model's
    softplus makes it, a_log = log(1..H) as the init makes it) against
    the plain version on the same inputs. y: in bf16 within one bf16 ulp
    of each (head, position) row's largest |ref| (fp32 accumulation of
    products whose fp32 operands enter the tensor cores as bf16 parts,
    then one rounding); in fp32 within 1e-5 of it (summation order of the
    dot products; cum is summed in fp64 by both, so the decays agree to
    the last bit or two of ``exp``). The final state (fp32 in both) within
    1e-5 of its largest |ref|. A second call gives the same bits."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_ref

    s = cfg.ssm
    h, p, n, g = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.n_groups
    bf16, fp32 = torch.bfloat16, torch.float32
    micro = SSM_TRAIN["n_groups"] * SSM_TRAIN["per_type_batch"]
    cases = cases or [
             (1, h, g, 512, p, n, bf16),     # the 512 bucket: 2 chunks
             (1, h, g, 128, p, n, bf16),     # the 128 bucket: 1 chunk
             (micro, h, g, SSM_TRAIN["seq"], p, n, bf16),  # training
             (1, h, g, 512, p, n, fp32),
             (1, h, g, 159, p, n, bf16),     # ragged: one chunk of 159
             (2, h, 4, 256, p, 16, bf16)]    # G > 1, N 16
    gen = torch.Generator(device="cuda").manual_seed(8)
    shapes, worst = [], 0.0
    for b, h_, g_, seq, p_, n_, dtype in cases:
        x = torch.randn((b, seq, h_, p_), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        dt = (torch.rand((b, seq, h_), generator=gen, device="cuda")
              * 0.099 + 0.001).transpose(1, 2)
        a_log = torch.log(torch.arange(1, h_ + 1, dtype=fp32,
                                       device="cuda"))
        bb, cc = (torch.randn((b, seq, g_, n_), generator=gen,
                              device="cuda").to(dtype).transpose(1, 2)
                  for _ in range(2))
        q = min(s.chunk, seq)
        a = -torch.exp(a_log)
        y, st = ops.ssd_scan(x, dt, a_log, bb, cc, chunk=s.chunk)
        y_ref, st_ref = ssd_scan_ref(x, dt, a, bb, cc, q)
        torch.cuda.synchronize()
        err = (y.float() - y_ref.float()).abs().max().item()
        st_rel = ((st - st_ref).abs().max() / st_ref.abs().max()).item()
        # bf16_ulps is the row's error over 2**-7 of its largest |ref|
        ulps = bf16_ulps(y, y_ref)
        if dtype == bf16:
            ok, tol = ulps <= 1.0, "y 1 bf16 ulp per row; state 1e-5"
        else:
            ok, tol = ulps * 2 ** -7 <= 1e-5, "y 1e-5 per row; state 1e-5"
        y2, st2 = ops.ssd_scan(x, dt, a_log, bb, cc, chunk=s.chunk)
        ibits = torch.int16 if dtype == bf16 else torch.int32
        same = (torch.equal(y2.view(ibits), y.view(ibits))
                and torch.equal(st2.view(torch.int32), st.view(torch.int32)))
        if not (ok and st_rel <= 1e-5 and same and torch.isfinite(y).all()
                and torch.isfinite(st).all()):
            raise AssertionError(
                f"ssd_scan B={b} H={h_} G={g_} S={seq} N={n_} {dtype}: y "
                f"{ulps} bf16 ulps per row (max err {err}), state rel err "
                f"{st_rel}, a second call the same bits {same}; tol {tol}")
        esize = x.element_size()
        # read x, dt, b, c, a; write y and the fp32 final state
        nbytes = (2 * b * h_ * seq * p_ + 2 * b * g_ * seq * n_) * esize \
            + b * h_ * seq * 4 + h_ * 4 + b * h_ * p_ * n_ * 4
        # per (batch, head, chunk): C B^T and W X over the causal
        # triangle, C S and X^T (B u) in full
        flops = b * h_ * (seq // q) * (q * (q + 1) * (n_ + p_)
                                       + 4 * q * n_ * p_)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dtype == bf16 else FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: ops.ssd_scan(x, dt, a_log, bb, cc,
                                                 chunk=s.chunk))
        shapes.append({
            "shape": {"B": b, "H": h_, "G": g_, "S": seq, "Q": q, "P": p_,
                      "N": n_},
            "tokens": b * seq, "dtype": str(dtype).replace("torch.", ""),
            "dtype_route": SSD_ROUTES[str(dtype).replace("torch.", "")],
            "main": (b, seq) == (1, max(SERVE["buckets"]))
            and dtype == bf16,
            "max_abs_err": err, "max_row_ulps": ulps,
            "state_rel_err": st_rel, "same_bits_again": same,
            "tol": tol + "; a second call the same bits", "ms": ms,
            "host_ms": host_ms,
            # ~50 launches a call: 10 calls stay within the card's queue
            # of pending launches, so the spin still covers the queueing
            "plain_ms": timed(lambda: ssd_scan_ref(x, dt, a, bb, cc, q),
                              iters=10)[0],
            "library_ms": None,
            "library": "none: no PyTorch call computes it",
            "bound_ms": b_ms, "bound_by": b_by})
        worst = max(worst, err)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:98",
            "dtype_routes": SSD_ROUTES, "max_abs_err": worst,
            "shapes": shapes}


def _ssd_bwd_errors(got, want) -> dict:
    """Per output of K4-bwd (dx, ddt, da_log, db, dc): in bf16 the largest
    row error in bf16 ulps at that row's largest |ref| (dx's rows are
    (head, position), db's and dc's (group, position)); in fp32 the
    largest error over the tensor's largest |ref|."""
    import torch

    out = {}
    for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc"), got, want):
        if g.dtype == w.dtype == torch.bfloat16:
            out[name] = ("bf16_ulps", bf16_ulps(g, w))
        else:
            out[name] = ("rel", ((g.float() - w.float()).abs().max()
                                 / w.float().abs().max()).item())
    return out


def check_ssd_scan_bwd(cfg) -> dict:
    """K4-bwd against the plain backward (``ssd_scan_bwd_ref``, the spec)
    and against autograd of the plain forward, on the same inputs: at
    the training microbatch (B 8, S 512, bf16, no d_final: the training
    path's final state is unused), at the train CLI's smoke shape (P 8,
    N 16, Q 32), with G 2 of H 8, with a chunk of 48, and in fp32 at the
    training widths (B 2); the last three with a non-zero d_final. x, B,
    C and dy as the model's transposed (B, S, ...) activations, dt as
    the model's softplus makes it, a_log = log(1..H) as the init makes
    it.

    Tolerances: the kernel's math is fp32 (the plain versions' too), in
    another summation order, so fp32 outputs (ddt and da_log always, all
    five in an fp32 run) within 1e-5 of each tensor's largest |ref|; bf16
    outputs (dx, db, dc) differ only by that fp32 noise before one
    rounding, so within one bf16 ulp of each row's largest |ref|, as
    K4's forward gate. The bf16 route feeds its fp32 operands to the
    tensor cores as two or three bf16 parts, which puts every output
    within 0.04 of its gate of the unrounded backward
    (``tools/ssd_bwd_rounding.py``): the gates stay those of the fp32
    math. One exception: da_log against autograd within
    1e-4, since autograd differentiates ``cum_i - cum_j`` entry by entry
    and so cancels the intra-chunk term's diagonal in fp32, which puts
    its own da_log 7.2e-6 (this dt) to 7.1e-5 (dt up to 0.1) from an
    fp64 evaluation, against the spec's 1.3e-6 and 4.2e-6
    (``tools/ssd_bwd_numerics.py``). A second call gives the same
    bits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import (bwd_heads_per_block,
                                              ssd_scan_bwd_cuda,
                                              ssd_scan_bwd_ref, ssd_scan_ref)
    from repro_torch.configs import smoke_config

    s = cfg.ssm
    h, p, n, g = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.n_groups
    smoke = smoke_config(SSM_ARCH)
    sm = smoke.ssm
    bf16, fp32 = torch.bfloat16, torch.float32
    micro = SSM_TRAIN["n_groups"] * SSM_TRAIN["per_type_batch"]
    # (B, H, G, S, P, N, Q, dtype, d_final)
    cases = [(micro, h, g, SSM_TRAIN["seq"], p, n, s.chunk, bf16, False),
             (micro, sm.n_heads(smoke.d_model), sm.n_groups, 64,
              sm.head_dim, sm.d_state, sm.chunk, bf16, False),
             (2, 8, 2, 256, p, n, 128, bf16, True),
             (2, 8, 1, 144, 32, 32, 48, bf16, True),
             (2, h, g, SSM_TRAIN["seq"], p, n, s.chunk, fp32, True)]
    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes, worst = [], 0.0
    for b, h_, g_, seq, p_, n_, q, dtype, final in cases:
        q = min(q, seq)

        def act(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                dtype).transpose(1, 2)
        x, bb, cc, dy = (act(b, seq, h_, p_), act(b, seq, g_, n_),
                         act(b, seq, g_, n_), act(b, seq, h_, p_))
        dt = F.softplus(torch.randn((b, seq, h_), generator=gen,
                                    device="cuda") * 0.5 - 4.6).transpose(1, 2)
        a_log = torch.log(torch.arange(1, h_ + 1, dtype=fp32, device="cuda"))
        d_final = (torch.randn((b, h_, p_, n_), generator=gen, device="cuda")
                   if final else None)
        inputs = (x, dt, a_log, bb, cc)
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        y, fin = ops.ssd_scan(*leaves, chunk=q)
        outs, grads_out = [y], [dy]
        if final:
            outs.append(fin)
            grads_out.append(d_final)
        got = torch.autograd.grad(outs, leaves, grads_out)
        spec = ssd_scan_bwd_ref(*inputs, dy, d_final, q)
        ref_leaves = [t.detach().clone().requires_grad_() for t in inputs]
        y_r, fin_r = ssd_scan_ref(ref_leaves[0], ref_leaves[1],
                                  -torch.exp(ref_leaves[2]), *ref_leaves[3:],
                                  q)
        ref_outs = [y_r, fin_r][:len(outs)]
        auto = torch.autograd.grad(ref_outs, ref_leaves, grads_out,
                                   retain_graph=True)
        again = ssd_scan_bwd_cuda(*inputs, dy, d_final, q)
        torch.cuda.synchronize()
        errs = {"spec": _ssd_bwd_errors(got, spec),
                "autograd": _ssd_bwd_errors(got, auto)}
        ok = all(v <= (1.0 if kind == "bf16_ulps" else
                       1e-4 if (ref, out) == ("autograd", "da_log") else 1e-5)
                 for ref, e in errs.items() for out, (kind, v) in e.items())
        ints = {2: torch.int16, 4: torch.int32}
        same = all(torch.equal(a.view(ints[a.element_size()]),
                               w.view(ints[w.element_size()]))
                   for a, w in zip(again, got))
        finite = all(torch.isfinite(t).all() for t in got)
        if not (ok and same and finite):
            raise AssertionError(
                f"ssd_scan_bwd B={b} H={h_} G={g_} S={seq} P={p_} N={n_} "
                f"Q={q} {dtype} d_final={final}: {errs} (bf16 outputs 1 "
                f"ulp per row, fp32 1e-5 of the largest |ref|, da_log 1e-4 "
                f"against autograd), a second call the same bits {same}, "
                f"finite {finite}")
        esize = x.element_size()
        hw = bwd_heads_per_block(dtype, b, h_, g_, seq, q)
        # read x, dy, dt, b, c, a_log (and d_final); write dx, ddt, da_log,
        # db, dc
        nbytes = (3 * b * h_ * seq * p_ + 4 * b * g_ * seq * n_) * esize \
            + 2 * b * h_ * seq * 4 + 2 * h_ * 4 \
            + (b * h_ * p_ * n_ * 4 if final else 0)
        # per (batch, head, chunk): C B^T, dY X^T, W^T dY, dCB B, dCB^T C
        # over the causal triangle; the state recompute, the dS sweep,
        # dY S_prev, B dS^T and X dS in full
        flops = b * h_ * (seq // q) * 2 * (q * (q + 1) // 2 * (3 * n_ + 2 * p_)
                                           + 5 * q * p_ * n_)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dtype == bf16 else FP32_FLOPS_PER_S)
        a32 = a_log.contiguous()
        ms, host_ms = timed(lambda: ssd_scan_bwd_cuda(x, dt, a32, bb, cc, dy,
                                                      d_final, q), iters=20)
        dname = str(dtype).replace("torch.", "")
        shapes.append({
            "shape": {"B": b, "H": h_, "G": g_, "S": seq, "Q": q, "P": p_,
                      "N": n_},
            "tokens": b * seq, "dtype": dname, "d_final": final,
            "dtype_route": (
                f"tensor cores (wgmma, bf16 parts of the fp32 operands), "
                f"four launches, {hw} heads a block" if dtype == bf16
                else "CUDA cores (fp32 fmaf), three launches"),
            "heads_per_block": hw,
            "main": b == micro and seq == SSM_TRAIN["seq"] and h_ == h
            and dtype == bf16,
            "max_abs_err": max((t.float() - r.float()).abs().max().item()
                               for t, r in zip(got, spec)),
            "errors_vs_spec": errs["spec"],
            "errors_vs_autograd": errs["autograd"],
            "max_row_ulps": max(v for e in errs.values()
                                for kind, v in e.values()
                                if kind == "bf16_ulps") if dtype == bf16
            else None,
            "same_bits_again": same,
            "tol": "bf16 outputs 1 bf16 ulp per row; fp32 outputs 1e-5 of "
                   "the largest |ref| (da_log against autograd 1e-4); a "
                   "second call the same bits",
            "ms": ms, "host_ms": host_ms,
            # ~100 launches a backward: 4 calls stay within the card's
            # queue of pending launches
            "plain_ms": timed(grad_timer(ref_outs, ref_leaves, grads_out),
                              iters=4)[0],
            "plain": "autograd backward of ssd_scan_ref",
            "library_ms": None,
            "library": "none: no PyTorch call computes it",
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes})
        worst = max(worst, shapes[-1]["max_abs_err"])
        del leaves, ref_leaves, y, fin, y_r, fin_r, got, spec, auto, again
        torch.cuda.empty_cache()
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:98",
            "dtype_routes": {"bfloat16": "tensor cores (wgmma)",
                             "float32": "CUDA cores (fp32 fmaf)"},
            "max_abs_err": worst, "shapes": shapes}


def train_layout(cfg, pad_to: int = 1, settings: dict = TRAIN):
    """The gradient layout that a train phase with ``settings`` gives
    ``cfg`` (its buckets padded to ``pad_to``: the data degree of a mesh
    executor's layout), built from storage-free (meta) parameters."""
    import torch

    from repro_torch.dist import bucket_layout
    from repro_torch.models.model import Model
    from repro_torch.train.step import accumulator_specs

    params = Model(cfg, torch.device("meta")).init(torch.Generator())
    return bucket_layout(accumulator_specs(params), max_bucket_elems=int(
        settings["bucket_mb"] * (1 << 20) // 4), pad_to=pad_to)


def int8_ef_cases(sizes) -> list[tuple]:
    """K3's cases at each distinct size of ``sizes``, fp32 grads."""
    import torch

    return [(n, torch.float32, None) for n in sorted(set(sizes))]


def check_int8_ef(cases) -> list[dict]:
    """K3a and K3b at each ``(n, dtype, special)`` of ``cases``, the first
    the main one (``special``: None for random grads, "zero" for an
    all-zero input, "nan" for one with a NaN and an infinity): q, scale
    and the residual bit-identical to the plain version (NaN where it has
    NaN)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_ef import (int8_ef_absmax_cuda,
                                             int8_ef_absmax_ref,
                                             int8_ef_quantize_cuda,
                                             int8_ef_quantize_ref,
                                             int8_ef_ref)

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {"int8_ef_absmax": [], "int8_ef_quantize": []}
    for n, dtype, special in cases:
        if special == "zero":
            g = torch.zeros(n, dtype=dtype, device="cuda")
            e = torch.zeros(n, device="cuda")
        else:
            g = (torch.randn(n, generator=gen, device="cuda") * 1e-3).to(
                dtype)
            e = torch.randn(n, generator=gen, device="cuda") * 1e-5
        if special == "nan":
            g[[17, n // 2]] = torch.tensor([float("nan"), float("inf")],
                                           dtype=dtype, device="cuda")
        q, scale, err = ops.int8_ef_quantize(g, e)
        q_ref, scale_ref, err_ref = int8_ef_ref(g, e)
        torch.cuda.synchronize()
        same = (torch.equal(q, q_ref) and same_bits(scale, scale_ref)
                and same_bits(err, err_ref))
        if special == "nan":
            same = same and bool(scale.isnan()) and bool(err.isnan().all())
        err_abs = (err - err_ref).abs().max().item()
        if not same:
            raise AssertionError(
                f"int8_ef n={n} {dtype} {special}: not bit-identical "
                f"(q equal {torch.equal(q, q_ref)}, scale {scale.item()} vs "
                f"{scale_ref.item()}, residual max diff {err_abs})")
        del q, err, q_ref, err_ref
        gsize = g.element_size()
        common = {"n": n, "dtype": str(dtype).replace("torch.", ""),
                  "input": special or "random", "bit_identical": True,
                  "max_abs_err": 0.0, "tol": "bit-identical",
                  "main": (n, dtype, special) == cases[0],
                  "tokens": n, "shape": [n], "library_ms": None,
                  "library": "none: no PyTorch call computes it"}
        amax = int8_ef_absmax_cuda(g, e)
        amax_ref = int8_ef_absmax_ref(g, e)
        b_ms, b_by = bound(n * (gsize + 4) + 4, 3 * n, FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: int8_ef_absmax_cuda(g, e), iters=20)
        rows["int8_ef_absmax"].append(dict(
            common, ms=ms, host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
            plain_ms=timed(lambda: int8_ef_absmax_ref(g, e), iters=20)[0]))
        b_ms, b_by = bound(n * (gsize + 4) + n * (1 + 4) + 8, 7 * n,
                           FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: int8_ef_quantize_cuda(g, e, amax),
                            iters=20)
        rows["int8_ef_quantize"].append(dict(
            common, ms=ms, host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
            plain_ms=timed(lambda: int8_ef_quantize_ref(g, e, amax_ref),
                           iters=20)[0]))
        del g, e, amax, amax_ref
        torch.cuda.empty_cache()
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/int8_ef.cu",
             "replaces": "src/repro/kernels/int8_ef.py:" + line,
             "max_abs_err": 0.0, "shapes": rows[name]}
            for name, line in (("int8_ef_absmax", "89"),
                               ("int8_ef_quantize", "101"))]


def kernel_phase(cfg, cfg_ssm) -> list[dict]:
    import torch

    from repro_torch.configs import get_config

    micro_rows = TRAIN["n_groups"] * TRAIN["per_type_batch"]
    rows = [(r, cfg.d_model) for r in (SERVE["slots"], *SERVE["buckets"])]
    # the mamba2 gated norm's width (d_inner) at the longest prompt, and
    # one training microbatch
    rows.append((max(SERVE["buckets"]), cfg_ssm.ssm.d_inner(
        cfg_ssm.d_model)))
    rows.append((micro_rows * TRAIN["seq"], cfg.d_model))
    # the mamba2 training microbatch: the block norm (d_model) and the
    # gated norm (d_inner)
    ssm_rows = SSM_TRAIN["n_groups"] * SSM_TRAIN["per_type_batch"] \
        * SSM_TRAIN["seq"]
    ssm_widths = (cfg_ssm.d_model, cfg_ssm.ssm.d_inner(cfg_ssm.d_model))
    rows += [(ssm_rows, w) for w in ssm_widths]
    seqs = [(1, s, torch.bfloat16) for s in SERVE["buckets"]]
    seqs += [(1, 200, torch.bfloat16),
             (1, SERVE["buckets"][-1], torch.float32)]
    # the campaign's live cells (phase 13) and the elastic ranks (phase
    # 14) at their own microbatches
    more = campaign_microbatches() + elastic_microbatches() \
        + tp_microbatches()
    rows += [(b * s, cfg.d_model) for b, s in more]
    seqs += [(b, s, torch.bfloat16) for b, s in more]
    # the elastic sync's K3 calls at its largest bucket: stage 1 on the
    # bucket (the layout padded to the full degree), stage 2 on a rank's
    # chunk of it at each degree
    layout = train_layout(cfg.scaled(n_layers=ELASTIC["depth"]),
                          pad_to=ELASTIC["n"])
    largest = max(layout.bucket_sizes)
    k3_sizes = [largest] + [largest // dp for dp in elastic_degrees()]
    # the tp phase's int8 arm (phase 19): its layout padded to the data
    # degree 2, stage 2 on half of each bucket
    k3_sizes += tp_k3_sizes(cfg)
    # the mamba2 training run's K3 calls: every bucket of its layout (the
    # stacked wz, wx and out_proj are the largest: 402,653,184 at 48
    # layers) at each depth of its ladder
    k3_sizes += [n for depth in SSM_TRAIN["depths"]
                 for n in train_layout(cfg_ssm.scaled(n_layers=depth),
                                       settings=SSM_TRAIN).bucket_sizes]
    # K3 at the largest bucket of the full-width layout (the main shape)
    # and a ragged 1,000,003 elements, bf16 and fp32 grads, an all-zero
    # input and one with a NaN and an infinity
    top = max(train_layout(cfg).bucket_sizes)
    k3 = [(top, torch.float32, None), (top, torch.bfloat16, None),
          (1_000_003, torch.float32, None),
          (1_000_003, torch.bfloat16, None),
          (1_000_003, torch.float32, "zero"),
          (1_000_003, torch.float32, "nan")]
    k3 += int8_ef_cases(n for n in k3_sizes if n not in (top, 1_000_003))
    # K1-bwd at the training shape (one microbatch's rows, the main one),
    # one row, one row short of it (a ragged last program), the mamba2
    # gated norm's width (4096), the campaign's and the elastic ranks'
    # microbatches, the mamba2 training microbatch at 2048 and 4096
    train_rows = micro_rows * TRAIN["seq"]
    bwd_rows = [(train_rows, cfg.d_model), (1, cfg.d_model),
                (train_rows - 1, cfg.d_model), (train_rows, 2 * cfg.d_model)]
    bwd_rows += [(b * s, cfg.d_model) for b, s in more]
    bwd_rows += [(ssm_rows, w) for w in ssm_widths]
    out = [check_rmsnorm(cfg, list(dict.fromkeys(rows))),
           check_flash(cfg, seqs), check_rmsnorm_bwd(cfg, bwd_rows),
           check_flash_bwd(cfg, [(micro_rows, TRAIN["seq"]), *more]),
           *check_int8_ef(k3), check_ssd_scan(cfg_ssm),
           check_ssd_scan_bwd(cfg_ssm)]
    out = merge_checks(out, family_kernel_checks(cfg))
    out = merge_checks(out, hybrid_kernel_checks(get_config(HYBRID_ARCH)))
    out = merge_checks(out, mla_kernel_checks(get_config(MLA_ARCH),
                                              get_config(MLA_V3_ARCH)))
    out = merge_checks(out, small_head_checks(cfg))
    out = merge_checks(out, v3_kernel_checks(get_config(V3_ARCH)))
    out = merge_checks(out, tp_kernel_checks(cfg))
    log_checks(out)
    return out


def log_checks(out: list[dict]) -> None:
    """One log line a shape of each kernel check."""
    for k in out:
        for sh in k["shapes"]:
            lib = sh["library_ms"]
            route = f" [{sh['dtype_route']}]" if "dtype_route" in sh else ""
            log(f"[kernels] {k['name']} {sh['shape']} {sh['dtype']}{route}: "
                f"err {sh['max_abs_err']:.3g} "
                f"({sh.get('max_row_ulps')} ulps) ms {sh['ms']:.5f} (host "
                f"{sh['host_ms']:.4f}) plain {sh['plain_ms']:.5f} library "
                f"{'none' if lib is None else f'{lib:.5f}'} "
                f"bound {sh['bound_ms']:.5f} ({sh['bound_by']})")
            if "launch_floor_ms" in sh:
                log(f"[kernels]   launch floor (an empty kernel): ms "
                    f"{sh['launch_floor_ms']:.5f} (host "
                    f"{sh['launch_floor_host_ms']:.4f})")
            if "forward" in sh:
                f = sh["forward"]
                log(f"[kernels]   its forward at that shape: ms "
                    f"{f['ms']:.5f} library {f['library_ms']:.5f} bound "
                    f"{f['bound_ms']:.5f} ({f['bound_by']})")


def family_kernel_checks(cfg) -> list[dict]:
    """K1, K1-bwd, K2, K2-bwd, K3a and K3b at the shapes the families
    phase (15) gives them, with the kernel phase's tolerances: K1 at each
    family width (4608, 3072, 1536, 4096) at the serving bucket and at
    one training microbatch, K1-bwd at the microbatch; K2 at each
    config's (H, KV, D) at the serving bucket and K2-bwd (with its
    training forward) at the microbatch, in bf16: groups of 9, 3, 6, 16
    and 1 (MHA at D 64); K3a and K3b at every distinct bucket size of
    each config's layout at its training depth (minitron-4b's embedding
    and head, 786,432,000 elements each, the largest). ``cfg`` (the main
    path's) gives the norm's eps. None of these shapes is a main one."""
    import torch

    from repro_torch.configs import get_config

    cfgs = [get_config(arch) for arch in FAMILY_DEPTHS]
    micro = FAMILY_TRAIN["n_groups"] * FAMILY_TRAIN["per_type_batch"]
    tokens = micro * FAMILY_TRAIN["seq"]
    widths = list(dict.fromkeys(c.d_model for c in cfgs))
    rows = [(r, w) for w in widths
            for r in (max(FAMILY_SERVE["buckets"]), tokens)]
    out = [check_rmsnorm(cfg, rows),
           check_rmsnorm_bwd(cfg, [(tokens, w) for w in widths])]
    for c in cfgs:
        out.append(check_flash(c, [(1, max(FAMILY_SERVE["buckets"]),
                                    torch.bfloat16)]))
        out.append(check_flash_bwd(c, [(micro, FAMILY_TRAIN["seq"])],
                                   dtypes=("bfloat16",)))
    out += check_int8_ef(int8_ef_cases(
        n for arch, depth in FAMILY_DEPTHS.items()
        for n in train_layout(get_config(arch).scaled(n_layers=depth),
                              settings=FAMILY_TRAIN).bucket_sizes))
    for k in out:
        for sh in k["shapes"]:
            sh["main"] = False
            sh["path"] = "families"
    return out


def merge_checks(kernels: list[dict], more: list[dict]) -> list[dict]:
    """``kernels`` with the shapes of ``more`` added to the entry of the
    same kernel (a new entry where there is none)."""
    by_name = {k["name"]: k for k in kernels}
    for k in more:
        if k["name"] in by_name:
            into = by_name[k["name"]]
            into["shapes"] += k["shapes"]
            into["max_abs_err"] = max(into["max_abs_err"], k["max_abs_err"])
        else:
            kernels.append(k)
            by_name[k["name"]] = k
    return kernels


# ------------------------------------------------------------------ #
# reference phase: card (kernels) vs CPU (plain versions), fp32       #
# ------------------------------------------------------------------ #
def serve_tokens(model, params, cfg, n_requests, **kw):
    from repro_torch.data import RequestStream
    from repro_torch.serve import ServeEngine, pool_pages_for

    buckets, max_new, ps = kw["buckets"], kw["max_new"], kw["page_size"]
    eng = ServeEngine(model, params, n_slots=kw["slots"], page_size=ps,
                      max_new=max_new, buckets=buckets,
                      n_pages=pool_pages_for(kw["slots"],
                                             max(buckets) + max_new, ps))
    eng.warmup()
    for r in RequestStream(cfg, buckets=buckets, max_new=max_new,
                           seed=3).requests(n_requests):
        eng.submit(r)
    return {d.req_id: d.tokens for d in eng.run()}


def reference_models(cfg):
    """``cfg`` in fp32 on the CPU (plain versions) and on the card
    (kernels), from the same parameters, drawn on the card (at published
    width the card draws them in a moment, the CPU in tens of seconds):
    ``(cpu model, cpu params, card model, card params)``."""
    import torch

    from repro_torch.models import build_model, cast_params

    cuda = build_model(cfg, device="cuda")
    params_gpu = cast_params(cuda.init(0), dtype=torch.float32)
    return (build_model(cfg, device="cpu"),
            cast_params(params_gpu, device="cpu"), cuda, params_gpu)


def logits_reference(models, cfg, prompt_len: int, tag: str) -> dict:
    """The prefill logits of a ``prompt_len`` prompt through the
    ``reference_models`` on the card and on the CPU within 1e-4
    (summation order through two layers and the head)."""
    import numpy as np
    import torch

    cpu, params_cpu, cuda, params_gpu = models
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, prompt_len)))
    with torch.no_grad():
        l_cpu, _ = cpu.prefill(params_cpu, toks)
        l_gpu, _ = cuda.prefill(params_gpu, toks.to("cuda"))
    err = (l_gpu.cpu() - l_cpu).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"{tag}: fp32 prefill logits differ by "
                             f"{err} > 1e-4")
    log(f"[{tag}] fp32 logits max err {err:.3g} (prompt of {prompt_len})")
    return {"prefill_logits_max_abs_err": err, "tol": 1e-4,
            "prompt_len": prompt_len, "n_layers": cfg.n_layers}


def serve_reference(cfg, prompt_len: int, buckets, tag: str) -> dict:
    """``logits_reference``, and the greedy tokens of 5 requests served
    on the card and on the CPU identical."""
    import numpy as np

    models = reference_models(cfg)
    out = logits_reference(models, cfg, prompt_len, tag)
    cpu, params_cpu, cuda, params_gpu = models
    kw = dict(slots=2, page_size=16, buckets=buckets, max_new=6)
    t_cpu = serve_tokens(cpu, params_cpu, cfg, 5, **kw)
    t_gpu = serve_tokens(cuda, params_gpu, cfg, 5, **kw)
    same = all(np.array_equal(t_cpu[r], t_gpu[r]) for r in t_cpu)
    if t_cpu.keys() != t_gpu.keys() or not same:
        raise AssertionError(f"{tag}: greedy tokens on the card differ "
                             f"from the CPU's")
    log(f"[{tag}] tokens identical over {len(t_cpu)} requests")
    return {**out, "buckets": list(buckets), "requests": len(t_cpu),
            "tokens_identical": True}


def reference_phase(cfg_full) -> dict:
    cfg = cfg_full.scaled(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=128, d_ff=512, vocab=1000)
    return serve_reference(cfg, 96, (32, 80), "reference")


def ssm_reference_phase(cfg_full) -> dict:
    """Full-width heads (head_dim 64, d_state 128) in chunks of 64, so
    the 128-token prompt carries the state across a chunk boundary."""
    from dataclasses import replace

    cfg = cfg_full.scaled(n_layers=2, d_model=256, vocab=1000,
                          ssm=replace(cfg_full.ssm, chunk=64))
    return serve_reference(cfg, 128, (64, 128), "ssm reference")


# ------------------------------------------------------------------ #
# slice phase: the main path                                         #
# ------------------------------------------------------------------ #
def run_server(model, params, cfg, kill: str | None, ckpt_dir=None,
               settings: dict = SERVE):
    """Build the server through the launcher's ``build_server`` (``kill``
    a ``STEP:R[,R]`` script or None; ``ckpt_dir`` enables the wipe-out
    reload, after a blocking save of the params at construction), warm
    it up and drain the request set of ``settings`` (``SERVE`` or
    ``FAMILY_SERVE``). The reloads are timed."""
    import torch

    from repro_torch.data import RequestStream
    from repro_torch.launch.serve import build_server, serve_and_measure
    from repro_torch.obs import Telemetry

    args = argparse.Namespace(
        replicas=settings["replicas"], slots=settings["slots"],
        page_size=settings["page_size"], max_new=settings["max_new"],
        buckets=",".join(str(b) for b in settings["buckets"]), kill=kill,
        failure_model=None, ckpt_dir=ckpt_dir)
    tel = Telemetry(trace=False)
    t0 = time.perf_counter()
    srv = build_server(args, model, params, telemetry=tel)
    build_s = time.perf_counter() - t0
    reload_s: list[float] = []
    if srv.ckpt is not None:
        restore = srv.ckpt.restore_latest

        def timed_restore(tree_like):
            t0 = time.perf_counter()
            out = restore(tree_like)
            torch.cuda.synchronize()
            reload_s.append(time.perf_counter() - t0)
            return out
        srv.ckpt.restore_latest = timed_restore
    srv.warmup()
    frozen = srv.recompiles
    stream = RequestStream(cfg, buckets=settings["buckets"],
                           max_new=settings["max_new"],
                           seed=settings["seed"])
    done, wall = serve_and_measure(srv,
                                   stream.requests(settings["requests"]))
    torch.cuda.synchronize()
    hist = tel.snapshot()["histograms"]
    calls = {"prefills": hist["serve.prefill_latency_s"]["count"],
             "decode_steps": hist["serve.token_latency_s"]["count"]}
    return {"srv": srv, "done": done, "wall": wall, "frozen": frozen,
            "calls": calls, "build_s": build_s, "reload_s": reload_s}


def serve_run_record(run, settings: dict = SERVE) -> dict:
    """What a serving run reports, for its gates and the JSON."""
    from repro_torch.obs.metrics import latency_stats

    srv, done, wall = run["srv"], run["done"], run["wall"]
    stats = latency_stats(done)
    return {**run["calls"], "completed": len(done), "dropped": srv.dropped,
            "requests": settings["requests"],
            "misses_after_warmup": srv.recompiles - run["frozen"],
            "events": srv.report()["events"], "wall_s": wall,
            "tokens_per_s": stats["tokens"] / wall, **stats,
            "n_tokens": stats["tokens"],
            "tokens": {d.req_id: d.tokens for d in done}}


def mixer_counts(cfg) -> dict:
    """Layers per mixer kernel: K2 (``flash_attention``) for each GQA
    attention block, K4 (``ssd_scan``) for each Mamba block. MLA runs
    no mixer kernel: the JAX package's is plain products."""
    kinds = cfg.block_kinds()
    gqa = cfg.attn_kind == "gqa"
    return {"flash_attention": gqa * sum(k.startswith("attn")
                                         for k in kinds),
            "ssd_scan": sum(k.startswith("mamba") for k in kinds)}


def norms_per_pass(cfg) -> int:
    """K1 launches of one prefill or decode step: each block's ln1, a
    Mamba mixer's gated norm, an MLA mixer's ``kv_norm`` (and ``q_norm``
    where its queries are compressed), ln2 where the block has an MLP
    (every kind but the SSM family's ``mamba``), and the final norm: 2L
    + 1 for the dense and SSM families, 3 a Mamba block and 2 an
    attention block in the hybrid's, 3L + 1 for deepseek-v2-lite (4L + 1
    for deepseek-v3)."""
    mla = (cfg.attn_kind == "mla") * (1 + bool(cfg.q_lora_rank))
    return 1 + sum(1 + k.startswith("mamba") + ("_" in k)
                   + k.startswith("attn") * mla
                   for k in cfg.block_kinds())


def mla_widths(cfg) -> dict:
    """MLA's widths, for a run's record (nothing for GQA)."""
    if cfg.attn_kind != "mla":
        return {}
    return {"attn_kind": "mla", "kv_lora_rank": cfg.kv_lora_rank,
            "q_lora_rank": cfg.q_lora_rank, "mla_d_nope": cfg.mla_d_nope,
            "mla_d_rope": cfg.mla_d_rope, "mla_d_v": cfg.mla_d_v}


def serve_launches_want(launches, runs, cfg) -> dict:
    """The launch counts the serving runs imply: every prefill runs the
    RMSNorms of :func:`norms_per_pass` and one mixer kernel per layer;
    every decode step the same RMSNorms; serving runs no backward and no
    gradient sync."""
    prefills = sum(r["prefills"] for r in runs)
    steps = sum(r["decode_steps"] for r in runs)
    want = dict.fromkeys(launches, 0)
    want["rmsnorm"] = (prefills + steps) * norms_per_pass(cfg)
    for mixer, n in mixer_counts(cfg).items():
        want[mixer] = prefills * n
    return want


def wipeout_run(model, params, cfg, healthy: dict, tag: str) -> dict:
    """The third serving run: the same set-up with a
    ``CheckpointManager`` (the params saved at construction under
    ``chiprun_out/``, removed after) and a ``ScriptedInjector`` that
    kills both replicas at ``kill_step``: the wipe-out reloads the
    params from the checkpoint onto the card and rebuilds the engines.
    Every request completes with the healthy run's tokens, nothing is
    dropped or rebuilt, the reload restores the params' bits, and the
    launch counters (set to 0 just before, read just after) match the
    prefills and decode steps run."""
    import shutil

    import numpy as np

    from repro_torch.dist import tree_leaves
    from repro_torch.kernels import ops

    ckpt_dir = ROOT / "chiprun_out" / "serve_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    victims = ",".join(str(r) for r in range(SERVE["replicas"]))
    try:
        ops.reset_launches()
        run = run_server(model, params, cfg, f"{SERVE['kill_step']}:"
                         f"{victims}", ckpt_dir=str(ckpt_dir))
        launches = dict(ops.launches)
        ckpt_gib = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                       if f.is_file()) / GIB
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    rec = serve_run_record(run)
    srv = run["srv"]
    if rec["completed"] != SERVE["requests"] or rec["dropped"]:
        raise AssertionError(f"{tag} wipeout: {rec['completed']} of "
                             f"{SERVE['requests']} completed, "
                             f"{rec['dropped']} dropped")
    if rec["misses_after_warmup"]:
        raise AssertionError(f"{tag} wipeout: rebuilt after warmup")
    if not any(e[1] == "wipeout" for e in rec["events"]) \
            or len(run["reload_s"]) != 1:
        raise AssertionError(f"{tag} wipeout: events {rec['events']}, "
                             f"{len(run['reload_s'])} reloads")
    for rid, toks in healthy.items():
        if not np.array_equal(toks, rec["tokens"][rid]):
            raise AssertionError(f"{tag} wipeout: request {rid}'s tokens "
                                 f"differ from the healthy run's")
    if checksums(tree_leaves(srv.params)) != checksums(tree_leaves(params)):
        raise AssertionError(f"{tag} wipeout: the reloaded params differ")
    want = serve_launches_want(launches, [rec], cfg)
    if launches != want:
        raise AssertionError(f"{tag} wipeout: launches {launches} != "
                             f"{want}")
    log(f"[{tag}] wipeout: both replicas killed at server step "
        f"{SERVE['kill_step']}; {rec['completed']}/{SERVE['requests']} "
        f"requests, tokens identical to the healthy run's; params "
        f"({ckpt_gib:.2f} GiB on disk) saved at construction, server "
        f"built in {run['build_s']:.2f} s; reload from the checkpoint "
        f"{run['reload_s'][0]:.2f} s; {rec['tokens_per_s']:.1f} tok/s")
    rec.update(reload_s=run["reload_s"][0], build_s=run["build_s"],
               ckpt_gib=ckpt_gib, launches=launches)
    return rec


def slice_phase(cfg, tag: str = "slice", settings: dict = SERVE,
                model=None, params=None, spellings: bool = True,
                check_decode=None) -> dict:
    """The serving main path on ``cfg`` at full width with ``settings``,
    with its gates (see the module doc); ``model`` and ``params`` are
    built here unless given. A GQA attention block launches K2 once per
    prefill, a Mamba block K4 (:func:`mixer_counts`); K1 runs
    :func:`norms_per_pass` times per prefill and per decode step.
    ``spellings``: a dense model also runs the builders' default
    spellings and the serving wipe-out. ``check_decode`` is the
    decode-against-prefill gate (:func:`decode_vs_prefill` unless
    given)."""
    import numpy as np
    import torch

    from repro_torch.data import RequestStream
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    if model is None:
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda")
        params = model.init(settings["seed"])
        torch.cuda.synchronize()
        log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, init {time.perf_counter() - t0:.1f} s")

    ops.reset_launches()
    runs = {}
    for name, kill in (("healthy", None),
                       ("burst", f"{settings['kill_step']}:0")):
        r = runs[name] = serve_run_record(
            run_server(model, params, cfg, kill, settings=settings),
            settings)
        log(f"[{tag}] {name}: {r['completed']}/{settings['requests']} "
            f"requests, {r['n_tokens']} tokens in {r['wall_s']:.2f} s = "
            f"{r['tokens_per_s']:.1f} tok/s, p50 {r['p50_ms']} ms, "
            f"p99 {r['p99_ms']} ms, events {r['events']}")
    launches = dict(ops.launches)

    for name, r in runs.items():
        if r["completed"] != settings["requests"] or r["dropped"]:
            raise AssertionError(f"{tag} {name}: {r['completed']} of "
                                 f"{settings['requests']} completed, "
                                 f"{r['dropped']} dropped")
        if r["misses_after_warmup"]:
            raise AssertionError(f"{tag} {name}: rebuilt after warmup")
    if not any(e[1] == "kill" for e in runs["burst"]["events"]):
        raise AssertionError(f"{tag}: burst run delivered no kill")
    for rid, toks in runs["healthy"]["tokens"].items():
        if not np.array_equal(toks, runs["burst"]["tokens"][rid]):
            raise AssertionError(f"{tag} request {rid}: burst tokens "
                                 f"differ")
    mixers = [m for m, n in mixer_counts(cfg).items() if n]
    for name in ("rmsnorm", *mixers):
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} never launched "
                                 f"on the serving path")
    want = serve_launches_want(launches, runs.values(), cfg)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want} for "
                             f"{sum(r['prefills'] for r in runs.values())} "
                             f"prefills, "
                             f"{sum(r['decode_steps'] for r in runs.values())}"
                             f" decode steps")

    # output sanity on the main path's model: finite logits of the
    # expected shape, and the paged decode agreeing with the prefill on
    # the generated continuation. An SSM prefill takes a length that its
    # chunk divides: a request of the 128 bucket (128 + 31 = 159 tokens,
    # one chunk), not of the 512 bucket (543 tokens)
    rid = 0
    if cfg.ssm is not None:
        stream = RequestStream(cfg, buckets=settings["buckets"],
                               max_new=settings["max_new"],
                               seed=settings["seed"])
        rid = next(i for i in range(settings["requests"])
                   if stream.request(i).prompt_len
                   == min(settings["buckets"]))
    check = (check_decode or decode_vs_prefill)(
        model, params, cfg, rid, runs["healthy"]["tokens"][rid], tag,
        settings)
    dense = wipeout = None
    if cfg.family != "ssm" and spellings:
        dense = default_spellings(model, params, cfg, rid,
                                  runs["healthy"]["tokens"][rid], tag)
        wipeout = runs["wipeout"] = wipeout_run(
            model, params, cfg, runs["healthy"]["tokens"], tag)
    for r in runs.values():
        r["tokens"] = {k: v.tolist() for k, v in r["tokens"].items()}
    config = {"arch": cfg.name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "vocab": cfg.vocab,
              "dtype": "bfloat16"}
    for sub in ("ssm", "moe"):
        if getattr(cfg, sub) is not None:
            config[sub] = dataclasses.asdict(getattr(cfg, sub))
    if cfg.family != "ssm":
        config.update(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                      head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
                      mlp_kind=cfg.mlp_kind, frontend=cfg.frontend,
                      **mla_widths(cfg))
    return {"config": config,
            "serve": dict(settings, buckets=list(settings["buckets"])),
            "launches": launches, "runs": runs, "check": check,
            "default_spellings": dense,
            "wipeout_launches": None if wipeout is None
            else wipeout.pop("launches")}


def default_spellings(model, params, cfg, rid, generated,
                      tag="slice") -> dict:
    """The builders' default spellings at full width, on request
    ``rid``'s prompt, with the launch counters set to 0 just before and
    read just after: ``make_prefill(model)`` (last-position logits of
    the training forward) against the last position of the cache-filling
    prefill, within one bf16 ulp per row (both run the same kernels, so
    the same bits are expected); then ``make_serve_step(model)`` (the
    dense step at a scalar position) over dense caches filled from that
    prefill, fed the paged engine's tokens: at each position the paged
    engine's next token must be within 0.25 of the dense step's best
    logit, the gap :func:`decode_vs_prefill` allows."""
    import numpy as np
    import torch

    from repro_torch.data import RequestStream
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill, make_serve_step

    req = RequestStream(cfg, buckets=SERVE["buckets"],
                        max_new=SERVE["max_new"],
                        seed=SERVE["seed"]).request(rid)
    prompt = torch.from_numpy(req.tokens.astype(np.int64))[None].cuda()
    s, n = prompt.shape[1], len(generated)
    ops.reset_launches()
    last = make_prefill(model)(params, prompt)
    full, cache = make_prefill(model, return_cache=True)(params, prompt)
    state = model.init_decode_state(1, s + n)
    for big, small in zip(_leaves(state), _leaves(cache)):
        big[:, :, :small.shape[2]].copy_(small)
    step = make_serve_step(model)
    logits = [last]
    for i in range(n - 1):
        tok = torch.tensor([[int(generated[i])]], device="cuda")
        out, state = step(params, state, s + i, tok)
        logits.append(out)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    want = dict.fromkeys(launches, 0)
    want.update({"rmsnorm": (2 + n - 1) * (2 * cfg.n_layers + 1),
                 "flash_attention": 2 * cfg.n_layers})
    if launches != want:
        raise AssertionError(f"{tag} default spellings: launches "
                             f"{launches} != {want}")
    ulps = bf16_ulps(last, full[:, -1, :])
    same = torch.equal(last.view(torch.int16),
                       full[:, -1, :].contiguous().view(torch.int16))
    if tuple(last.shape) != (1, cfg.padded_vocab) or not ulps <= 1.0:
        raise AssertionError(f"{tag}: make_prefill(model) {tuple(last.shape)}"
                             f", {ulps} bf16 ulps from the cached prefill")
    lg = torch.cat(logits)[:, :cfg.vocab].float()
    if not torch.isfinite(lg).all():
        raise AssertionError(f"{tag}: dense step logits not finite")
    chosen = torch.from_numpy(np.asarray(generated, np.int64)).cuda()
    agree = (lg.argmax(-1) == chosen).float().mean().item()
    gap = (lg.max(-1).values - lg.gather(1, chosen[:, None])[:, 0]).max(
        ).item()
    log(f"[{tag}] make_prefill(model): {ulps} bf16 ulps from the cached "
        f"prefill's last position (bit-identical: {same}); "
        f"make_serve_step(model) over {n - 1} dense steps: greedy "
        f"agreement with the paged engine {agree:.3f}, largest logit gap "
        f"{gap:.4f}")
    if not gap <= 0.25:
        raise AssertionError(f"{tag}: the paged engine chose a token {gap} "
                             f"below the dense step's best")
    return {"request": rid, "prompt_len": s, "prefill_max_row_ulps": ulps,
            "prefill_bit_identical": same, "dense_steps": n - 1,
            "greedy_agreement": agree, "max_logit_gap": gap, "tol": 0.25,
            "launches": launches}


def _leaves(tree) -> list:
    """The tensors of a tree of lists and tuples, in order."""
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


# ------------------------------------------------------------------ #
# training: reference (card vs CPU) and the main path                #
# ------------------------------------------------------------------ #
def _executor(cfg, device, **kw):
    from repro_torch.exec import MeshExecutor

    return MeshExecutor(cfg, n_groups=kw.pop("n_groups", 4),
                        redundancy=kw.pop("r", 2), device=device,
                        total_steps=50, **kw)


def record_sync(ex, out: list) -> None:
    """Record every bucket the executor's int8 EF sync handles: checksums
    of the residuals it reads, and host copies of the synced bucket and
    of the residuals it leaves."""
    inner = ex._grad_sync._sync_bucket

    def recorded(buf, e1, e2):
        read = checksums([e1, e2])
        inner(buf, e1, e2)
        out.append({"read": read, "synced": buf.detach().to("cpu", copy=True),
                    "err1": e1.to("cpu", copy=True),
                    "err2": e2.to("cpu", copy=True)})

    ex._grad_sync._sync_bucket = recorded


def train_reference_phase(cfg_full) -> dict:
    """The dense family's training reference: :func:`train_reference` at
    a small qwen configuration with head_dim 128."""
    cfg = cfg_full.scaled(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=128, d_ff=512, vocab=1000, grad_accum=1)
    return train_reference(cfg, 64, "reference")


def ssm_train_reference_phase(cfg_full) -> dict:
    """The SSM family's training reference: :func:`train_reference` at a
    small mamba2 configuration with full-width heads (head_dim 64,
    d_state 128) in chunks of 64, at seq 128: K4 and K4-bwd carry the
    state and its gradient across a chunk boundary."""
    from dataclasses import replace

    cfg = cfg_full.scaled(n_layers=2, d_model=256, vocab=1000, grad_accum=1,
                          ssm=replace(cfg_full.ssm, chunk=64))
    return train_reference(cfg, 128, "ssm reference")


def train_reference(cfg, seq: int, tag: str) -> dict:
    """Three MeshExecutor steps of a small fp32 configuration on the card
    (kernels) and on the CPU (plain versions), from the same parameters
    and batches. With fp32 buckets, losses within 1e-5 relative and
    params within 1e-5. With int8 EF, each step starts the CPU from the
    card's params, moments and EF residuals, so that the two differ by
    summation order only and a code that rounds the other way at one
    step does not carry into the next; at every step the losses are
    within 1e-5 relative, the synced gradients within one int8 quantum
    (max|g| / 127) of their bucket (codes of that quantum within 1,
    scales within 1e-5) and the residuals within one quantum (each is at
    most half of its own); and the card's sync reads, bit for bit, the
    residuals it wrote at the step before (zero at the first step,
    not zero after it)."""
    import copy

    import torch

    from repro_torch.dist import tree_leaves
    from repro_torch.models import cast_params
    from repro_torch.optim import adamw_init
    from repro_torch.ckpt.checkpoint import copy_into

    out = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, "seq": seq}}
    for compress in (None, "int8_ef"):
        kw = dict(seq=seq, per_type_batch=1, grad_compress=compress,
                  bucket_mb=0.25)
        cpu, gpu = _executor(cfg, "cpu", **kw), _executor(cfg, "cuda", **kw)
        params = cast_params(cpu.params, dtype=torch.float32)
        for ex in (cpu, gpu):
            # each its own copy: the step updates params in place
            ex.params = cast_params(copy.deepcopy(params), device=ex.device)
            ex.opt_state = adamw_init(ex.params)
        if compress is None:
            rc, rg = cpu.run(3), gpu.run(3)
            rel = max(abs(a - b) / abs(a)
                      for a, b in zip(rc.losses, rg.losses))
            perr = max((a - b.cpu()).abs().max().item() for a, b in zip(
                tree_leaves(cpu.params), tree_leaves(gpu.params)))
            if not (rel <= 1e-5 and perr <= 1e-5):
                raise AssertionError(f"{tag} train fp32: losses rel "
                                     f"{rel}, params {perr} (> 1e-5)")
            out["fp32"] = {"steps": 3, "losses_cpu": rc.losses,
                           "losses_card": rg.losses, "loss_rel_err": rel,
                           "param_max_abs_err": perr, "tol": 1e-5}
            log(f"[{tag}] train fp32: losses rel err {rel:.3g}, params "
                f"{perr:.3g} over 3 steps")
            continue
        rec_c, rec_g = [], []
        record_sync(cpu, rec_c)
        record_sync(gpu, rec_g)
        losses_c, losses_g, worst = [], [], dict.fromkeys(
            ("loss", "codes", "scales", "residual_quanta", "flipped"), 0.0)
        wrote = None          # the card's residuals after the step before
        for t in range(3):
            copy_into((cpu.params, cpu.opt_state, cpu._ef_state),
                      (gpu.params, gpu.opt_state, gpu._ef_state))
            rec_c.clear()
            rec_g.clear()
            losses_c += cpu.run(1).losses
            losses_g += gpu.run(1).losses
            worst["loss"] = max(worst["loss"], abs(losses_c[-1] - losses_g[-1])
                                / abs(losses_c[-1]))
            read = [r["read"] for r in rec_g]
            want = ([[0, 0]] * len(rec_g) if wrote is None else
                    [checksums([r["err1"], r["err2"]]) for r in wrote])
            carried = (read == want and [r["read"] for r in rec_c] == read
                       and (t == 0 or any(r["err1"].any() for r in wrote)))
            if not carried:
                raise AssertionError(
                    f"{tag} train int8_ef step {t}: the card's sync "
                    f"did not read the residuals it wrote at the step "
                    f"before (or the CPU did not start from them)")
            wrote = rec_g[:]
            # each bucket comes back as int8 codes times one scale (max|g|
            # / 127): the codes within one quantum, the scales within fp32
            # summation noise (the two gradients differ by summation order)
            for a, b in zip(rec_c, rec_g):
                ga, gb = a["synced"], b["synced"]
                sa, sb = ga.abs().max() / 127.0, gb.abs().max() / 127.0
                if sa == 0 or sb == 0:
                    worst["codes"] = max(worst["codes"], float(sa != sb) * 128)
                    continue
                diff = ((ga / sa).round() - (gb / sb).round()).abs()
                worst["codes"] = max(worst["codes"], diff.max().item())
                worst["flipped"] += int(diff.count_nonzero())
                worst["scales"] = max(worst["scales"], abs(sa / sb - 1).item())
                quantum = max(sa, sb).item()
                for key in ("err1", "err2"):
                    worst["residual_quanta"] = max(
                        worst["residual_quanta"],
                        (a[key] - b[key]).abs().max().item() / quantum)
            if not (worst["loss"] <= 1e-5 and worst["codes"] <= 1.0
                    and worst["scales"] <= 1e-5
                    and worst["residual_quanta"] <= 1.0 + 1e-5):
                raise AssertionError(f"{tag} train int8_ef step {t}: "
                                     f"{worst} (loss, scales > 1e-5; codes, "
                                     f"residuals > 1 quantum)")
        out["int8_ef"] = {
            "steps": 3, "buckets": len(rec_g), "losses_cpu": losses_c,
            "losses_card": losses_g, "loss_rel_err": worst["loss"],
            "max_code_diff": worst["codes"],
            "codes_flipped": int(worst["flipped"]),
            "max_scale_rel_diff": worst["scales"],
            "max_residual_diff_quanta": worst["residual_quanta"],
            "residuals_carried": True,
            "tol": "each step from the card's state: losses 1e-5 relative; "
                   "codes within 1 int8 quantum per element; scales 1e-5 "
                   "relative; residuals within 1 quantum; the card's "
                   "residuals carried bit for bit"}
        log(f"[{tag}] train int8_ef: 3 steps, losses rel err "
            f"{worst['loss']:.3g}, synced codes within {worst['codes']:g} "
            f"({int(worst['flipped'])} flipped), scales within "
            f"{worst['scales']:.3g}, residuals within "
            f"{worst['residual_quanta']:.3g} quanta over {len(rec_g)} "
            f"buckets; residuals carried")
    return out


def checksums(tensors) -> list[int]:
    """Bitwise checksums: the int64 sum of each tensor's bits."""
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [int(t.view(ints[t.element_size()]).sum(dtype=torch.int64))
            for t in tensors]


def _state_tensors(ex) -> list:
    from repro_torch.dist import tree_leaves

    return (tree_leaves(ex.params) + tree_leaves(ex.opt_state.mu)
            + tree_leaves(ex.opt_state.nu)
            + list(ex._ef_state["err1"]) + list(ex._ef_state["err2"]))


def instrument(ex, rec: dict, tag: str = "train") -> None:
    """Record, per executed step, its schedule, loss, host time, the
    sync's device time (CUDA events around each bucket) and whether a
    background checkpoint save ran through the whole step; time the
    snapshot and checksum the live state at the snapshot and just after
    the rollback."""
    import torch

    def saving() -> bool:
        t = None if ex.ckpt is None else ex.ckpt._thread
        return t is not None and t.is_alive()

    rec["waits"] = []           # waits for an in-flight background save
    if ex.ckpt is not None:
        join = ex.ckpt._join

        def timed_join():
            busy, t0 = saving(), time.perf_counter()
            join()
            if busy:
                rec["waits"].append(time.perf_counter() - t0)
        ex.ckpt._join = timed_join

    dispatch, snap, roll = ex._dispatch, ex._snapshot_now, ex._rollback
    sync_bucket = ex._grad_sync._sync_bucket
    events: list = []

    def timed_bucket(buf, e1, e2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        sync_bucket(buf, e1, e2)
        ev[1].record()
        events.append(ev)

    def timed_dispatch(report):
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, s_a, before = ex.step, ex.state.s_a, saving()
        out = dispatch(report)
        loss = float(out[2]["loss"])          # synchronises
        secs = time.perf_counter() - t0
        rec["steps"].append({
            "step": step, "s_a": s_a, "loss": loss, "seconds": secs,
            "sync_ms": sum(a.elapsed_time(b) for a, b in events),
            "save_in_flight": before and saving()})
        log(f"[{tag}] step {step} S_A={s_a}: loss {loss:.6f}, {secs:.3f} "
            f"s, sync {rec['steps'][-1]['sync_ms']:.1f} ms"
            + (", a save in flight" if rec["steps"][-1]["save_in_flight"]
               else ""))
        return out

    def timed_snapshot():
        torch.cuda.synchronize()
        waits, t0 = len(rec["waits"]), time.perf_counter()
        snap()
        secs = time.perf_counter() - t0
        wait = sum(rec["waits"][waits:])
        nbytes = sum(t.numel() * t.element_size()
                     for t in _state_tensors(ex))
        rec["snapshots"].append({"step": ex.step, "seconds": secs - wait,
                                 "wait_s": wait, "bytes": nbytes,
                                 "opt_step": ex.opt_state.step,
                                 "checksums": checksums(_state_tensors(ex))})
        log(f"[{tag}] snapshot at step {ex.step}: {nbytes / GIB:.2f} GiB "
            f"to the host in {secs - wait:.2f} s"
            + (f", after waiting {wait:.2f} s for the save in flight"
               if wait else ""))

    def checked_rollback():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = roll()
        torch.cuda.synchronize()
        rec["rollbacks"].append({"step": out[0],
                                 "seconds": time.perf_counter() - t0,
                                 "checksums": checksums(_state_tensors(ex))})
        return out

    ex._dispatch, ex._snapshot_now = timed_dispatch, timed_snapshot
    ex._rollback = checked_rollback
    ex._grad_sync._sync_bucket = timed_bucket


def train_script(n: int, r: int, settings: dict = TRAIN):
    """The scripted failures of ``settings``: group 0 at ``kill_poll``
    (maskable), then, unless ``wipe_poll`` is None, the first single
    group whose loss (with group 0 dead) wipes the system out, at
    ``wipe_poll``, and with ``rekill`` group 0 again at the poll after
    (so the replay runs at the masked ``S_A`` too); and the recovery
    events the report must show, from the same scheme run on the host
    alone."""
    import copy

    from repro_torch.core import SpareState
    from repro_torch.des import get_scheme

    state = SpareState(n, r)
    first = get_scheme("spare", r=r).recover(state, [0])
    if first.wipeout:
        raise AssertionError("killing group 0 alone wipes the system out")
    kill, wp = settings["kill_poll"], settings["wipe_poll"]
    if wp is None:
        return {kill: [0]}, {"s_a_masked": first.s_a_after,
                             "events": [([0], False, first.s_a_after, 0)]}
    for g in range(1, n):
        wipe = get_scheme("spare", r=r).recover(copy.deepcopy(state), [g])
        if wipe.wipeout:
            break
    else:
        raise AssertionError("no single kill wipes the system out")
    events = [([0], False, first.s_a_after, 0),
              ([g], True, wipe.s_a_after, wp)]
    script = {kill: [0], wp: [g]}
    if settings.get("rekill"):
        script[wp + 1] = [0]
        events.append(([0], False, first.s_a_after, 0))
    return script, {"s_a_masked": first.s_a_after, "events": events}


def train_run(cfg, depth: int, settings: dict = TRAIN,
              tag: str = "train", before=None) -> dict:
    """One run of the training path at ``depth`` layers with ``settings``
    (``TRAIN``, ``SSM_TRAIN``, ``FAMILY_TRAIN`` or ``V3_TRAIN``);
    ``before(ex)``, if given, runs on the built executor before the
    launch counts are set to 0 and the run starts, its result kept as
    the run's ``"before"``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.train import ScriptedInjector

    cfg = cfg.scaled(n_layers=depth, grad_accum=1)
    # the state fills most of the card: start from an empty cache, or the
    # blocks earlier phases left make the allocator free and re-map
    # memory (a device-wide synchronise) on every large allocation
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    t0 = time.perf_counter()
    ex = _executor(cfg, "cuda", n_groups=settings["n_groups"],
                   r=settings["r"], seq=settings["seq"],
                   per_type_batch=settings["per_type_batch"],
                   seed=settings["seed"], grad_compress="int8_ef",
                   bucket_mb=settings["bucket_mb"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[{tag}] {cfg.name}: {depth} layers, {ex._layout.n_buckets} "
        f"buckets, set up in {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / GIB:.2f} GiB allocated")
    script, expect = train_script(settings["n_groups"], settings["r"],
                                  settings)
    rec = {"steps": [], "snapshots": [], "rollbacks": []}
    instrument(ex, rec, tag)
    rec["before"] = None if before is None else before(ex)
    ops.reset_launches()
    t0 = time.perf_counter()
    report = ex.run(settings["steps"], injector=ScriptedInjector(script))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    return {"ex": ex, "cfg": cfg, "report": report, "rec": rec,
            "launches": launches, "peak_bytes": peak, "wall_s": wall,
            "init_s": init_s, "script": script, "expect": expect,
            "alloc_retries": retries,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved()}


#: the ``"dots"`` remat check (train phase): each model at ``depth``
#: layers, one training microbatch of the phase's (qwen2.5-3b 8 x 256
#: tokens, mamba2-1.3b 8 x 512), the loss's gradient under each policy,
#: timed as the median of ``timed_calls`` after one warm call each
DOTS = dict(depth=2, seed=0, policies=("nothing", "dots", "none"),
            timed_calls=3)


def dots_run(cfg_full, settings: dict, tag: str,
             device: str = "cuda") -> dict:
    """One model's ``"dots"`` check on the card: the gradient of the mean
    next-token loss of one microbatch (random bf16 weights and tokens
    from seed 0) under each policy of ``DOTS``, from one set of params.
    Gates: ``"dots"`` bit-identical to ``"nothing"`` and its launch counts
    equal; against ``"none"`` bit-identical, or the largest distance is
    printed. Returns each policy's launches and peak device memory (of
    its first call) and seconds (host time to a synchronise, the median
    of ``DOTS["timed_calls"]`` calls after it)."""
    import torch

    from repro_torch.dist import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.layers import cross_entropy

    cfg = cfg_full.scaled(n_layers=DOTS["depth"], grad_accum=1)
    params = build_model(cfg, device=device).init(DOTS["seed"])
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    b, s = settings["n_groups"] * settings["per_type_batch"], settings["seq"]
    gen = torch.Generator(device=device).manual_seed(DOTS["seed"])
    tokens = torch.randint(0, cfg.vocab, (b, s + 1), device=device,
                           generator=gen)
    out: dict = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                            "tokens": [b, s]}, "policies": {}}
    on_card = device == "cuda"

    def call(model):
        logits = model.forward(params, tokens=tokens[:, :-1])
        return torch.autograd.grad(cross_entropy(logits, tokens[:, 1:]),
                                   leaves)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    grads = {}
    for policy in DOTS["policies"]:
        model = build_model(cfg.scaled(remat_policy=policy), device=device)
        gc.collect()
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        got = call(model)
        sync()
        rec = {"launches": dict(ops.launches),
               "peak_gib": (torch.cuda.max_memory_allocated() / GIB
                            if on_card else None)}
        # kept on the host, so that each policy's peak holds its own
        grads[policy] = [g.cpu() for g in got]
        del got
        secs = []
        for _ in range(DOTS["timed_calls"]):
            t0 = time.perf_counter()
            call(model)
            sync()
            secs.append(time.perf_counter() - t0)
        rec["seconds"] = _median(secs)
        out["policies"][policy] = rec
    pol = out["policies"]
    if not all(torch.equal(a, b) for a, b in zip(grads["dots"],
                                                  grads["nothing"])):
        raise AssertionError(f"{tag}: the gradients under 'dots' are not "
                             f"those under 'nothing' bit for bit")
    if pol["dots"]["launches"] != pol["nothing"]["launches"]:
        raise AssertionError(f"{tag}: launches under 'dots' "
                             f"{pol['dots']['launches']} != 'nothing' "
                             f"{pol['nothing']['launches']}")
    dist_none = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(grads["dots"], grads["none"]))
    out["none_bit_identical"] = dist_none == 0.0
    out["none_max_abs"] = dist_none
    if dist_none:
        # "none" keeps the forward's outputs where the others recompute
        # them: a kernel or product that rounds differently on its
        # second call shows here
        log(f"[{tag}] 'none' differs from 'dots' by {dist_none:.3e} at "
            f"most: a recomputed op gives other bits than its first call")
    log(f"[{tag}] {cfg.name} at {cfg.n_layers} layers, {b} x {s} tokens: "
        f"'dots' bit-identical to 'nothing' (launches "
        f"{pol['dots']['launches']}), to 'none' "
        f"{out['none_bit_identical']}; peak GiB "
        f"{ {p: v['peak_gib'] for p, v in pol.items()} }, s "
        f"{ {p: round(v['seconds'], 3) for p, v in pol.items()} }")
    del grads, params, leaves
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def dots_phase(cfg, cfg_ssm) -> dict:
    """The ``"dots"`` check on qwen2.5-3b and mamba2-1.3b
    (:func:`dots_run`); ``launches`` sums the ``"dots"`` runs'."""
    t0 = time.perf_counter()
    out = {"qwen": dots_run(cfg, TRAIN, "dots"),
           "mamba2": dots_run(cfg_ssm, SSM_TRAIN, "dots")}
    launches: dict = {}
    for rec in out.values():
        for k, v in rec["policies"]["dots"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


def train_phase(cfg_full, settings: dict = TRAIN, tag: str = "train",
                before=None) -> dict:
    """The training main path of ``cfg_full``'s family with ``settings``,
    with its gates (see the module doc: phases 9, 11, 15 and 18;
    ``before`` as :func:`train_run` takes it). Without a wipe-out
    (``wipe_poll`` None) there is no rollback to check, and the step time
    is that of the ``S_A = 1`` steps after the first; with ``rekill`` the
    replayed steps run at the masked ``S_A``."""
    import math

    import torch

    readings = []
    run = None
    for depth in settings["depths"]:
        try:
            run = train_run(cfg_full, depth, settings, tag, before)
        except torch.OutOfMemoryError as exc:
            readings.append({"depth": depth, "oom": str(exc)[:200],
                             "peak_gib": torch.cuda.max_memory_allocated()
                             / GIB})
            log(f"[{tag}] depth {depth}: out of memory")
        else:
            readings.append({"depth": depth,
                             "peak_gib": run["peak_bytes"] / GIB})
            if run["peak_bytes"] / GIB <= settings["mem_limit_gib"]:
                break
            log(f"[{tag}] depth {depth}: peak "
                f"{run['peak_bytes'] / GIB:.2f} GiB over the limit")
        run = None
        gc.collect()
        torch.cuda.empty_cache()
    if run is None:
        raise AssertionError(f"no depth fits: {readings}")
    ex, cfg, rep, rec = run["ex"], run["cfg"], run["report"], run["rec"]
    expect, L = run["expect"], cfg.n_layers

    # gates
    losses = [s["loss"] for s in rec["steps"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: a loss is not finite: {losses}")
    kill, wipe = settings["kill_poll"], settings["wipe_poll"]
    if wipe is None:
        want_sa = [1] * kill + [expect["s_a_masked"]] * (settings["steps"]
                                                         - kill)
    else:
        after = expect["s_a_masked"] if settings.get("rekill") else 1
        want_sa = ([1] * kill + [expect["s_a_masked"]] * (wipe - kill)
                   + [after] * settings["steps"])
    got_sa = [s["s_a"] for s in rec["steps"]]
    events = [(e.victims, e.wipeout, e.s_a_after, e.rollback_depth)
              for e in rep.events]
    want_events = expect["events"]
    if (rep.failures != len(want_events)
            or rep.wipeouts != (wipe is not None) or got_sa != want_sa
            or events != want_events or rep.steps_done != len(want_sa)):
        raise AssertionError(
            f"{tag} report off script: failures {rep.failures}, wipeouts "
            f"{rep.wipeouts}, S_A {got_sa} (want {want_sa}), events "
            f"{events} (want {want_events})")
    if wipe is not None:
        if rec["snapshots"][0]["checksums"] != \
                rec["rollbacks"][0]["checksums"]:
            raise AssertionError(f"{tag}: the state after the rollback "
                                 f"differs from the snapshot")
        replay = rec["steps"][wipe]
        if replay["step"] != 0 or replay["loss"] != rec["steps"][0]["loss"]:
            raise AssertionError(f"{tag}: replayed step 0 loss {replay} != "
                                 f"first execution {rec['steps'][0]}")
    micro = sum(got_sa)
    executed = len(got_sa)
    nb = ex._layout.n_buckets
    # per microbatch, counting each block's remat recompute: a block's
    # norms (two; three with MLA's kv_norm) twice and the final norm
    # once, each norm's backward once; the block's mixer kernel (K2, or
    # K4 in the SSM family; none for MLA) twice and its backward once.
    # Every other counter stays at 0
    norms = norms_per_pass(cfg)
    want = dict.fromkeys(run["launches"], 0)
    want.update({"rmsnorm": micro * (2 * (norms - 1) + 1),
                 "rmsnorm_bwd": micro * norms,
                 "int8_ef_absmax": executed * 2 * nb,
                 "int8_ef_quantize": executed * 2 * nb})
    for mixer, n in mixer_counts(cfg).items():
        want.update({mixer: micro * 2 * n, f"{mixer}_bwd": micro * n})
    if run["launches"] != want:
        raise AssertionError(f"{tag} launches {run['launches']} != {want}")

    # measurements: the replayed steps after the first (warm: at S_A = 1,
    # or the masked S_A with ``rekill``); without a wipe-out, the S_A = 1
    # steps after the first
    steady = (rec["steps"][wipe + 1:] if wipe is not None else
              [s for s in rec["steps"][1:] if s["s_a"] == 1])
    step_s = sorted(s["seconds"] for s in steady)[len(steady) // 2]
    masked = sorted(s["seconds"] for s in rec["steps"] if s["s_a"] > 1)
    # the logical batch (vanilla DP's): at S_A > 1 the step computes S_A
    # microbatches of this size, the dead group's slots at weight 0
    tokens = (settings["n_groups"] * settings["per_type_batch"]
              * settings["seq"])
    sync_share = sorted(s["sync_ms"] / 1e3 / s["seconds"]
                        for s in steady)[len(steady) // 2]
    snap = rec["snapshots"][0]
    mem_total = next(int(line.split()[1]) * 1024 for line in
                     open("/proc/meminfo") if line.startswith("MemTotal"))
    widths = ({"ssm": dataclasses.asdict(cfg.ssm)} if cfg.family == "ssm"
              else {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                    "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                    "mlp_kind": cfg.mlp_kind, "frontend": cfg.frontend,
                    **mla_widths(cfg)})
    if cfg.moe is not None:
        widths["moe"] = dataclasses.asdict(cfg.moe)
    out = {"config": {"arch": cfg.name, "n_layers": L,
                      "d_model": cfg.d_model, **widths,
                      "vocab": cfg.vocab, "padded_vocab": cfg.padded_vocab,
                      "dtype": "bfloat16", **settings,
                      "depths": list(settings["depths"])},
           "depth_readings": readings, "script": {str(k): v for k, v in
                                                  run["script"].items()},
           "buckets": nb, "steps": rec["steps"], "launches": run["launches"],
           "launches_want": want, "failures": rep.failures,
           "wipeouts": rep.wipeouts, "recompiles": rep.recompiles,
           "rollback_depth": wipe or 0, "peak_gib": run["peak_bytes"] / GIB,
           "peak_reserved_gib": run["peak_reserved_bytes"] / GIB,
           "alloc_retries": run["alloc_retries"],
           "step_s_median": step_s, "steady_steps": len(steady),
           "step_s_masked_median": masked[len(masked) // 2] if masked
           else None, "tokens_per_step": tokens,
           "microbatches_per_steady_step": steady[0]["s_a"],
           "tokens_per_s": tokens / step_s, "sync_share_median": sync_share,
           "snapshot_gib": snap["bytes"] / GIB,
           "snapshot_s": snap["seconds"],
           "rollback_s": rec["rollbacks"][0]["seconds"]
           if rec["rollbacks"] else None,
           "host_mem_total_gib": mem_total / GIB, "init_s": run["init_s"],
           "wall_s": run["wall_s"], "before": rec["before"]}
    del ex, run
    return out


# ------------------------------------------------------------------ #
# the failure tiers: disk checkpoints, the straggler tier, a wipe-out #
# ------------------------------------------------------------------ #
def state_bytes(cfg) -> tuple[int, int]:
    """Bytes of the training state of the dense family at ``cfg``: the
    checkpoint (bf16 params with fp32 norms and QKV biases, fp32 AdamW
    moments, the int32 step) and the host snapshot (the checkpoint plus
    the int8 EF sync's two fp32 residual families, each of the
    gradient's size at one rank)."""
    n = cfg.param_count() + (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    bias = ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.resolved_head_dim
            if cfg.qkv_bias else 0)
    f32 = cfg.d_model + cfg.n_layers * (2 * cfg.d_model + bias)
    ckpt = 2 * n + 2 * f32 + 8 * n + 4
    return ckpt, ckpt + 8 * n


def _peak_rss() -> int:
    """The process's largest resident set so far, bytes (Linux counts
    ``ru_maxrss`` in KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def mem_total() -> int:
    return next(int(line.split()[1]) * 1024 for line in
                open("/proc/meminfo") if line.startswith("MemTotal"))


def failure_script(n: int, r: int):
    """The failure tiers' script: group ``slow_group`` at
    ``slow_factor``x over polls ``[slow_from, slow_until)`` (flagged,
    demoted and, once the episode ends, re-admitted), then group 0
    killed at ``kill_poll`` (masked) and, at ``wipe_poll``, the first
    single group whose loss then wipes the system out."""
    kill, _ = train_script(n, r)
    masked, wiping = list(kill.values())
    f = FAILURE
    script = {f["kill_poll"]: masked, f["wipe_poll"]: wiping}
    slow = {f["slow_from"]: [(f["slow_group"], f["slow_factor"],
                              f["slow_until"])]}
    return script, slow


def failure_executor(cfg, device, ckpt_dir, **kw):
    """The MeshExecutor of the failure tiers: int8 EF, a checkpoint
    directory whose Eq.-1 interval is due at every snapshot point, a
    StragglerDetector with its defaults, both stack depths registered."""
    from repro_torch.health import StragglerDetector

    ex = _executor(cfg, device, n_groups=TRAIN["n_groups"], r=TRAIN["r"],
                   per_type_batch=TRAIN["per_type_batch"],
                   seed=TRAIN["seed"], grad_compress="int8_ef",
                   ckpt_dir=str(ckpt_dir), mtbf=FAILURE["mtbf"],
                   t_save=FAILURE["t_save"], t_restart=FAILURE["t_restart"],
                   detector=StragglerDetector(TRAIN["n_groups"]), **kw)
    ex.ckpt.keep = FAILURE["keep"]
    ex.prewarm_depths(range(1, TRAIN["r"] + 1))
    return ex


def failure_events(rep) -> list:
    return [(e.step, e.victims, e.wipeout, e.reordered, e.patch_count,
             e.s_a_before, e.s_a_after, e.rollback_depth, e.demote,
             e.readmit, e.slow_factor) for e in rep.events]


def failure_cpu_run(cfg_full, ckpt_dir) -> dict:
    """The same script on a tiny configuration on the CPU: the events,
    ``health_log`` and saves the card's run must reproduce."""
    from repro_torch.train import ScriptedInjector

    cfg = cfg_full.scaled(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=128, d_ff=512, vocab=1000, grad_accum=1)
    ex = failure_executor(cfg, "cpu", ckpt_dir, seq=64, bucket_mb=0.25)
    script, slow = failure_script(TRAIN["n_groups"], TRAIN["r"])
    rep = ex.run(FAILURE["steps"], injector=ScriptedInjector(
        script, slow_schedule=slow, n_groups=TRAIN["n_groups"]),
        snapshot_every=FAILURE["snapshot_every"])
    return {"events": failure_events(rep), "health_log": ex.health_log,
            "ckpt_saves": rep.ckpt_saves,
            "committed": sorted(p.name for p in ckpt_dir.glob("step_*"))}


def _shape_like(tree):
    """``tree`` with each tensor replaced by a one-element tensor of its
    dtype and device expanded to its shape: what a restore reads of the
    tree it restores into, without the memory."""
    import torch

    from repro_torch.optim import AdamWState

    if isinstance(tree, dict):
        return {k: _shape_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shape_like(v) for v in tree)
    if isinstance(tree, AdamWState):
        return AdamWState(tree.step, _shape_like(tree.mu),
                          _shape_like(tree.nu))
    return torch.empty((), dtype=tree.dtype,
                       device=tree.device).expand(tree.shape)


def pick_failure_depth(cfg_full, train_depth: int, ckpt_dir) -> tuple:
    """The first of ``FAILURE["depths"]`` (up to the train phase's depth)
    whose two checkpoints (with ``keep`` 1 both are on disk at once while
    the second is staged) fit the disk's free space under the checkpoint
    directory and ``FAILURE["write_budget_gib"]``, and whose host
    snapshot fits ``MemTotal``. The readings are printed."""
    import shutil

    free, total = shutil.disk_usage(ckpt_dir.parent).free, mem_total()
    budget = min(free, FAILURE["write_budget_gib"] * GIB)
    readings = []
    for depth in [d for d in FAILURE["depths"] if d <= train_depth]:
        ckpt_b, snap_b = state_bytes(cfg_full.scaled(n_layers=depth))
        fits = 2 * ckpt_b <= budget and total >= snap_b
        readings.append({"depth": depth, "ckpt_gib": ckpt_b / GIB,
                         "snapshot_gib": snap_b / GIB, "fits": fits})
        log(f"[failure tiers] depth {depth}: checkpoint {ckpt_b / GIB:.2f} "
            f"GiB (written twice), host snapshot {snap_b / GIB:.2f} GiB; "
            f"disk free {free / GIB:.2f} GiB, write budget "
            f"{FAILURE['write_budget_gib']:.1f} GiB, MemTotal "
            f"{total / GIB:.2f} GiB: " + ("fits" if fits else "cut"))
        if fits:
            return depth, readings, free, total
    raise AssertionError(f"failure tiers: no depth fits: {readings}")


def failure_tiers_phase(cfg_full, train_depth: int) -> dict:
    """Full-width qwen2.5-3b through the ``MeshExecutor`` (one-rank NCCL
    group, int8 EF, the train phase's groups, tokens and buckets) with a
    checkpoint directory under ``chiprun_out/`` (removed at the end), a
    ``StragglerDetector`` with its defaults and a ``ScriptedInjector``
    holding a slow schedule and two kills (:func:`failure_script`).
    Gates: every loss finite; the events and ``health_log`` equal a tiny
    CPU run of the same script; a demote and a re-admit whose weight
    table equals an always-healthy run's bit for bit, with no rebuild;
    at least two saves commit, and the latest restores onto the card
    to the state recorded at its step, bit for bit; after the wipe-out
    the state equals the snapshot and the first replayed step's loss
    its first execution's, bit for bit; exact launch counts. Measures
    the host copy, the disk write, the restore, the step time while a
    save is in flight and the peak host RSS."""
    import math
    import shutil

    import numpy as np
    import torch

    import repro_torch.ckpt.checkpoint as ckpt_mod
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.core import SpareState
    from repro_torch.dist import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.train import ScriptedInjector

    base = ROOT / "chiprun_out" / "failure_tiers"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    ckpt_dir = base / "card"
    real_save = ckpt_mod.save_checkpoint
    try:
        cpu = failure_cpu_run(cfg_full, base / "cpu")
        log(f"[failure tiers] tiny CPU run: events {cpu['events']}, "
            f"health_log {cpu['health_log']}, saves {cpu['ckpt_saves']}")
        depth, readings, free, total = pick_failure_depth(
            cfg_full, train_depth, ckpt_dir)
        cfg = cfg_full.scaled(n_layers=depth, grad_accum=1)
        log(f"[failure tiers] Eq.-1 interval from mtbf {FAILURE['mtbf']} "
            f"s, t_save {FAILURE['t_save']} s, t_restart "
            f"{FAILURE['t_restart']} s: due at every snapshot point")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ex = failure_executor(cfg, "cuda", ckpt_dir, seq=TRAIN["seq"],
                              bucket_mb=TRAIN["bucket_mb"])
        torch.cuda.synchronize()
        log(f"[failure tiers] {cfg.name}: {depth} layers, set up in "
            f"{time.perf_counter() - t0:.1f} s, Eq.-1 interval "
            f"{ex.ckpt.interval:.3g} s")
        rec = {"steps": [], "snapshots": [], "rollbacks": [], "saves": [],
               "readmits": []}
        instrument(ex, rec, tag="failure tiers")
        run_t0 = time.perf_counter()

        def timed_save(directory, step, tree, *, clock):
            t0 = time.perf_counter()
            d = real_save(directory, step, tree, clock=clock)
            rec["saves"].append({
                "step": step, "seconds": time.perf_counter() - t0,
                "start_s": t0 - run_t0,
                "bytes": sum(f.stat().st_size for f in d.iterdir())})
            return d
        ckpt_mod.save_checkpoint = timed_save
        readmit = ex._readmit

        def checked_readmit(groups, hr, injector, report):
            readmit(groups, hr, injector, report)
            fresh = SpareState(TRAIN["n_groups"], TRAIN["r"])
            rec["readmits"].append(int(ex.state.s_a) == int(fresh.s_a) and all(
                np.array_equal(getattr(ex.state, f), getattr(fresh, f))
                for f in ("stacks", "alive", "supplier")))
        ex._readmit = checked_readmit

        script, slow = failure_script(TRAIN["n_groups"], TRAIN["r"])
        ops.reset_launches()
        rep = ex.run(FAILURE["steps"], injector=ScriptedInjector(
            script, slow_schedule=slow, n_groups=TRAIN["n_groups"]),
            snapshot_every=FAILURE["snapshot_every"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - run_t0
        launches = dict(ops.launches)
        events, health_log = failure_events(rep), ex.health_log
        committed = sorted(p.name for p in ckpt_dir.glob("step_*"))
        fs = subprocess.run(["stat", "-f", "-c", "%T", str(ckpt_dir)],
                            capture_output=True, text=True,
                            timeout=60).stdout.strip()
        n_ckpt = (len(tree_leaves(ex.params)) + len(tree_leaves(
            ex.opt_state.mu)) + len(tree_leaves(ex.opt_state.nu)))
        like = _shape_like((ex.params, ex.opt_state))
        nb, interval = ex._layout.n_buckets, ex.ckpt.interval
        del ex
        gc.collect()
        torch.cuda.empty_cache()
        # the latest checkpoint, restored onto the card
        t0 = time.perf_counter()
        step, (params, opt) = restore_checkpoint(ckpt_dir, like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored = checksums(tree_leaves(params) + tree_leaves(opt.mu)
                             + tree_leaves(opt.nu))
        restored_step = opt.step
        del params, opt, like
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        ckpt_mod.save_checkpoint = real_save
        shutil.rmtree(base, ignore_errors=True)
    peak_rss = _peak_rss()

    # gates
    L = depth
    losses = [s["loss"] for s in rec["steps"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"failure tiers: a loss is not finite: {losses}")
    if events != cpu["events"] or health_log != cpu["health_log"]:
        raise AssertionError(f"failure tiers: events {events}, health_log "
                             f"{health_log} differ from the tiny CPU run's "
                             f"{cpu['events']}, {cpu['health_log']}")
    if (rep.demotes != 1 or rep.readmits != 1 or rec["readmits"] != [True]
            or rep.recompiles != 0 or rep.wipeouts != 1
            or rep.failures != 2):
        raise AssertionError(
            f"failure tiers: demotes {rep.demotes}, readmits "
            f"{rep.readmits} (healthy table {rec['readmits']}), rebuilds "
            f"{rep.recompiles}, wipeouts {rep.wipeouts}, failures "
            f"{rep.failures}")
    saved = [sv["step"] for sv in rec["saves"]]
    if (rep.ckpt_saves < 2 or rep.ckpt_saves != cpu["ckpt_saves"]
            or committed != cpu["committed"]
            or committed != [f"step_{saved[-1]:08d}"]):
        raise AssertionError(f"failure tiers: saves {rep.ckpt_saves} "
                             f"(CPU {cpu['ckpt_saves']}), steps saved "
                             f"{saved}, committed {committed} (CPU "
                             f"{cpu['committed']})")
    snap = {sn["step"]: sn for sn in rec["snapshots"]}
    at_save = snap[step]
    if (step != saved[-1] or restored_step != at_save["opt_step"]
            or restored != at_save["checksums"][:n_ckpt]):
        raise AssertionError(f"failure tiers: the checkpoint of step "
                             f"{step} does not restore to the state "
                             f"recorded at its step")
    roll = rec["rollbacks"][0]
    if roll["checksums"] != snap[roll["step"]]["checksums"]:
        raise AssertionError("failure tiers: the state after the rollback "
                             "differs from the snapshot")
    first = {}
    for st in rec["steps"]:
        first.setdefault(st["step"], st)
    wipe_at = next(i for i, st in enumerate(rec["steps"])
                   if i and st["step"] <= rec["steps"][i - 1]["step"])
    replay = rec["steps"][wipe_at]
    if (replay["step"] != roll["step"]
            or replay["loss"] != first[roll["step"]]["loss"]
            or first[roll["step"]]["s_a"] != replay["s_a"]):
        raise AssertionError(f"failure tiers: replayed step {replay} != "
                             f"first execution {first[roll['step']]}")
    micro = sum(st["s_a"] for st in rec["steps"])
    executed = len(rec["steps"])
    want = dict.fromkeys(launches, 0)
    want.update({"rmsnorm": micro * (4 * L + 1),
                 "rmsnorm_bwd": micro * (2 * L + 1),
                 "flash_attention": micro * 2 * L,
                 "flash_attention_bwd": micro * L,
                 "int8_ef_absmax": executed * 2 * nb,
                 "int8_ef_quantize": executed * 2 * nb})
    if launches != want:
        raise AssertionError(f"failure tiers: launches {launches} != {want}")

    # measurements
    def median(xs):
        return sorted(xs)[len(xs) // 2] if xs else None
    # step times by stack depth (a step at S_A = 2 runs two
    # microbatches), with and without a save in flight; the first step
    # is a warm-up
    by_sa: dict = {}
    for st in rec["steps"][1:]:
        d = by_sa.setdefault(str(st["s_a"]), {"save_in_flight": [],
                                              "no_save": []})
        d["save_in_flight" if st["save_in_flight"] else "no_save"].append(
            st["seconds"])
    step_s = {sa: {k: {"median": median(v), "n": len(v)}
                   for k, v in d.items()} for sa, d in by_sa.items()}
    busy = by_sa.get("1", {}).get("save_in_flight", [])
    quiet = by_sa.get("1", {}).get("no_save", [])
    replayed = [st["seconds"] for st in rec["steps"][wipe_at:]
                if st["s_a"] == 1]
    last = rec["saves"][-1]
    out = {"config": {"arch": cfg.name, "n_layers": depth,
                      "dtype": "bfloat16", **FAILURE,
                      "depths": list(FAILURE["depths"]),
                      "script": {str(k): v for k, v in script.items()},
                      "slow_schedule": {str(k): v for k, v in slow.items()}},
           "depth_readings": readings, "disk_free_gib": free / GIB,
           "host_mem_total_gib": total / GIB, "filesystem": fs,
           "interval_s": interval, "events": events,
           "health_log": health_log, "cpu": cpu, "ckpt_saves": rep.ckpt_saves,
           "committed": committed, "steps": rec["steps"],
           "snapshots": [{k: v for k, v in sn.items() if k != "checksums"}
                         for sn in rec["snapshots"]],
           "save_waits_s": rec["waits"], "saves": rec["saves"],
           "rollback_s": roll["seconds"], "restore_s": restore_s,
           "restore_gb_per_s": last["bytes"] / 1e9 / restore_s,
           "save_s": last["seconds"], "save_gib": last["bytes"] / GIB,
           "save_gb_per_s": last["bytes"] / 1e9 / last["seconds"],
           "step_s_by_s_a": step_s,
           "step_s_save_in_flight_median": median(busy),
           "step_s_no_save_median": median(quiet),
           "step_s_replayed_median": median(replayed),
           "steps_save_in_flight": len(busy), "steps_no_save": len(quiet),
           "peak_rss_gib": peak_rss / GIB, "launches": launches,
           "launches_want": want, "wall_s": wall}
    log(f"[failure tiers] {depth} layers on {fs}: {rep.ckpt_saves} saves "
        f"committed ({committed}); checkpoint {last['bytes'] / GIB:.2f} "
        f"GiB written in {last['seconds']:.2f} s = "
        f"{out['save_gb_per_s']:.3f} GB/s; restored onto the card in "
        f"{restore_s:.2f} s; host copies "
        f"{[round(sn['seconds'], 2) for sn in rec['snapshots']]} s (waits "
        f"for a save in flight {[round(w, 2) for w in rec['waits']]} s); "
        f"rollback "
        f"{roll['seconds']:.2f} s; step seconds by S_A with and without "
        f"a save in flight {step_s}, replayed {median(replayed)} s; peak RSS "
        f"{peak_rss / GIB:.2f} of {total / GIB:.2f} GiB")
    return out


# ------------------------------------------------------------------ #
# the launchers as a user runs them                                  #
# ------------------------------------------------------------------ #
# ------------------------------------------------------------------ #
# the families: two-matrix MLPs and the embeds= frontends             #
# ------------------------------------------------------------------ #
def embeds_gate(model, params, cfg, settings: dict) -> dict:
    """(b) The frontend input on the card: the embedding rows of a
    prompt of the longest bucket, as float32 ``embeds``, through
    ``forward`` must give the token path's bf16 logits bit for bit (the
    same kernels on the same bf16 rows)."""
    import numpy as np
    import torch

    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, max(settings["buckets"])))).cuda()
    with torch.no_grad():
        want = model.forward(params, tokens)
        got = model.forward(params, embeds=params["embed"][tokens].float())
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    if not same or not torch.isfinite(got[..., :cfg.vocab]).all():
        raise AssertionError(f"{cfg.name}: forward(embeds=embed[tokens]) "
                             f"is not forward(tokens) bit for bit")
    log(f"[families] {cfg.name}: forward(embeds=embed[tokens]) equals "
        f"forward(tokens) bit for bit over {tokens.shape[1]} positions")
    return {"positions": tokens.shape[1], "bit_identical": True}


def families_phase() -> dict:
    """Phase 15: for each config of ``FAMILY_DEPTHS`` at published width,
    (a) the fp32 card-vs-CPU reference of the token path at 2 layers,
    (b) for a frontend config the embeds gate, (c) the serving path at
    full depth with ``FAMILY_SERVE`` (the slice phase's gates: no drop,
    no rebuild, the burst run's tokens the healthy run's, exact launch
    counts), (d) the training path at the config's depth with
    ``FAMILY_TRAIN`` (the train phase's gates; a frontend config's
    batches carry ``embeds``). Each config's seconds are logged."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    out = {}
    for arch, depth in FAMILY_DEPTHS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        small = cfg.scaled(n_layers=2)
        rec = out[arch] = {"reference": logits_reference(
            reference_models(small), small, 96, f"{arch} reference")}
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(cfg, device="cuda")
        params = model.init(FAMILY_SERVE["seed"])
        torch.cuda.synchronize()
        if cfg.frontend is not None:
            rec["embeds_gate"] = embeds_gate(model, params, cfg,
                                             FAMILY_SERVE)
        rec["serve"] = slice_phase(cfg, f"{arch} slice", FAMILY_SERVE,
                                   model=model, params=params,
                                   spellings=False)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        rec["train"] = train_phase(
            cfg, dict(FAMILY_TRAIN, depths=(depth,)), f"{arch} train")
        gc.collect()
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t0
        log(f"[families] {arch}: {rec['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ #
# the hybrid family: jamba, its MoE FFN and the period                #
# ------------------------------------------------------------------ #
def hybrid_kernel_checks(cfg) -> list[dict]:
    """K1, K2 and K4 at the shapes jamba's serving path gives them, with
    the kernel phase's tolerances: K1 at d_model 4096 (ln1, ln2, the final
    norm) and d_inner 8192 (the gated norm), at a decode step's 8 rows
    and a prefill's 128; K2 at GQA 32 / 8 heads of 128 (group 4) over a
    prefill of 128; K4 at H 128, P 64, N 16, G 1 over 128 positions (one
    chunk). None of these shapes is a main one."""
    import torch

    d_in = cfg.ssm.d_inner(cfg.d_model)
    bucket = max(FAMILY_SERVE["buckets"])
    s = cfg.ssm
    out = [check_rmsnorm(cfg, [(r, w) for w in (cfg.d_model, d_in)
                               for r in (FAMILY_SERVE["slots"], bucket)]),
           check_flash(cfg, [(1, bucket, torch.bfloat16)]),
           check_ssd_scan(cfg, [(1, s.n_heads(cfg.d_model), s.n_groups,
                                 bucket, s.head_dim, s.d_state,
                                 torch.bfloat16)])]
    for k in out:
        for sh in k["shapes"]:
            sh["main"] = False
            sh["path"] = "hybrid"
    return out


def _close_rows(got, want, rows) -> float:
    """The largest |got - want| over ``rows`` (token indices of the
    flattened (T, D) outputs), over the largest |want|."""
    g = got.reshape(-1, got.shape[-1])[rows].double()
    w = want.reshape(-1, want.shape[-1])[rows].double()
    return ((g - w).abs().max() / w.abs().max()).item()


def hybrid_block_reference(cfg) -> dict:
    """(a) One ``mamba_moe`` and one ``attn_dense`` block of ``cfg`` at
    published width in fp32, the card (kernels) against the CPU (plain
    versions) on the same parameters (drawn on the card) and the same
    ``HYBRID["ref_positions"]`` positions: each block's output within
    1e-4 of the largest |ref|. Both devices must route every token of the
    MoE layer to the same experts; a token routed otherwise is allowed
    only where the gap between its k-th and (k+1)-th gate is within twice
    the card-vs-CPU difference of its gates (fp32 rounding), and is then
    left out of the comparison."""
    import numpy as np
    import torch

    from repro_torch.models import build_model, cast_params
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.ssm import mamba_forward

    n = HYBRID["ref_positions"]
    k = cfg.moe.top_k
    x_np = np.random.default_rng(6).standard_normal(
        (1, n, cfg.d_model)).astype(np.float32)
    out = {}
    for i, kind in enumerate(("mamba_moe", "attn_dense")):
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(HYBRID["seed"] + i)
        bp = cast_params(model_mod._init_block(gen, kind, cfg, "cuda"),
                         dtype=torch.float32)
        per = {}
        for dev, params in (("cuda", bp), ("cpu", cast_params(bp, "cpu"))):
            model = build_model(cfg, device=dev)
            x = torch.from_numpy(x_np).to(dev)
            pos = torch.arange(n, device=dev)[None]
            with torch.no_grad():
                y = model._block(x, params, kind, pos)
                gates = None
                if kind.endswith("moe"):
                    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
                    x1 = x + mamba_forward(h, params["mamba"], cfg)
                    h2 = rmsnorm(x1, params["ln2"], cfg.norm_eps)
                    gates = torch.matmul(h2.reshape(n, -1).float(),
                                         params["moe"]["router"].float())
            per[dev] = (y.cpu(), None if gates is None else gates.cpu())
            del params
        del bp
        gc.collect()
        torch.cuda.empty_cache()
        (y_gpu, g_gpu), (y_cpu, g_cpu) = per["cuda"], per["cpu"]
        rows = list(range(n))
        flips = []
        if g_cpu is not None:
            chosen = [torch.topk(g, k).indices.sort(-1).values
                      for g in (g_gpu, g_cpu)]
            differ = (chosen[0] != chosen[1]).any(-1)
            srt = torch.sort(g_cpu, -1, descending=True).values
            for t in differ.nonzero()[:, 0].tolist():
                gap = (srt[t, k - 1] - srt[t, k]).item()
                rounding = (g_gpu[t] - g_cpu[t]).abs().max().item()
                flips.append({"token": t, "gap": gap, "rounding": rounding})
                log(f"[hybrid reference] token {t} routed otherwise on the "
                    f"card: gate gap {gap:.3g}, card-vs-CPU gate "
                    f"difference {rounding:.3g}")
                if not gap <= 2 * rounding:
                    raise AssertionError(
                        f"hybrid reference: token {t} routed otherwise with "
                        f"a gate gap {gap} beyond fp32 rounding ({rounding})")
                rows.remove(t)
        err = _close_rows(y_gpu, y_cpu, rows)
        if not (err <= 1e-4 and torch.isfinite(y_gpu).all()):
            raise AssertionError(f"hybrid reference {kind}: card vs CPU "
                                 f"{err} of the largest |ref| > 1e-4")
        secs = time.perf_counter() - t0
        log(f"[hybrid reference] {kind}: fp32 card vs CPU {err:.3g} of the "
            f"largest |ref| over {len(rows)} of {n} positions "
            f"({len(flips)} routed otherwise); {secs:.1f} s")
        out[kind] = {"rel_err": err, "tol": 1e-4, "positions": n,
                     "compared": len(rows), "routing_flips": flips,
                     "seconds": secs}
    return out


def moe_reference(cfg) -> dict:
    """(b) One MoE layer of ``cfg`` at published width on the card: the
    grouped dispatch (``moe_ffn``) against the dense oracle
    (``moe_ffn_reference``) on the same ``HYBRID["moe_tokens"]`` tokens.
    fp32: the output, and the gradients of x, the router and the experts
    of <y, cot>, within 1e-5 of each one's largest element; bf16 (the
    model's dtypes: bf16 experts, fp32 router): the output within 2^-7 of
    the largest |ref|, the CPU tests' tolerance. Both routes run the same
    router on the same input, so they route alike. Also times both in
    bf16 at the prefill's tokens and at a decode step's 8, with a
    synchronise (the grouped dispatch reads its expert counts back to the
    host, so the spin of :func:`timed` cannot hold the stream)."""
    import torch

    from repro_torch.models import cast_params
    from repro_torch.models import model as model_mod
    from repro_torch.models.moe import moe_ffn, moe_ffn_reference

    t = HYBRID["moe_tokens"]
    gen = torch.Generator(device="cuda").manual_seed(HYBRID["seed"] + 7)
    p16 = model_mod._init_moe(gen, cfg, "cuda")
    x = torch.randn((1, t, cfg.d_model), generator=gen, device="cuda")
    cot = torch.randn((1, t, cfg.d_model), generator=gen, device="cuda")
    out = {"tokens": t}

    p32 = cast_params(p16, dtype=torch.float32)
    leaves = {"x": x.requires_grad_(), "router": p32["router"],
              **{f"experts.{n}": w for n, w in p32["experts"].items()}}
    for w in leaves.values():
        w.requires_grad_()
    ys, grads = [], []
    for fn in (moe_ffn, moe_ffn_reference):
        y = fn(x, p32, cfg)
        (y * cot).sum().backward()
        ys.append(y.detach())
        grads.append({n: w.grad for n, w in leaves.items()})
        for w in leaves.values():
            w.grad = None
    def rel(a, b) -> float:
        return ((a - b).abs().max() / b.abs().max()).item()
    errs = {"y": rel(*ys), **{f"d{n}": rel(grads[0][n], grads[1][n])
                              for n in leaves}}
    del p32, leaves, grads, ys, y
    gc.collect()
    torch.cuda.empty_cache()
    if not all(e <= 1e-5 for e in errs.values()):
        raise AssertionError(f"moe reference fp32: {errs} > 1e-5")
    log(f"[hybrid moe] fp32 grouped vs dense oracle over {t} tokens: "
        f"{ {n: f'{e:.3g}' for n, e in errs.items()} } (tol 1e-5)")
    out["fp32_rel_err"] = errs

    x16 = x.detach().to(torch.bfloat16)
    with torch.no_grad():
        y = moe_ffn(x16, p16, cfg)
        want = moe_ffn_reference(x16, p16, cfg)
        err = rel(y.float(), want.float())
        if not (err <= 2.0 ** -7 and torch.isfinite(y).all()):
            raise AssertionError(f"moe reference bf16: {err} > 2^-7")
        times = {}
        for tokens in (t, FAMILY_SERVE["slots"]):
            xs = x16[:, :tokens]
            for name, fn in (("grouped", moe_ffn),
                             ("dense_oracle", moe_ffn_reference)):
                fn(xs, p16, cfg)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn(xs, p16, cfg)
                torch.cuda.synchronize()
                times[f"{name}_{tokens}_ms"] = \
                    (time.perf_counter() - t0) / 10 * 1e3
    # the experts' bytes, read once: the least a layer can take
    nbytes = sum(w.numel() * w.element_size()
                 for w in p16["experts"].values())
    times["experts_read_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    del p16
    log(f"[hybrid moe] bf16 grouped vs dense oracle {err:.3g} of the "
        f"largest |ref| (tol 2^-7); ms a layer {times}")
    out.update(bf16_rel_err=err, bf16_tol=2.0 ** -7, **times)
    return out


def hybrid_phase(clis: bool = True) -> dict:
    """Phase 16: jamba-v0.1-52b at published width. (a) the fp32 block
    references (:func:`hybrid_block_reference`); (b) the MoE layer
    against its dense oracle (:func:`moe_reference`); (c) serving at
    ``HYBRID["depth"]`` layers with ``FAMILY_SERVE`` (the slice phase's
    gates; per prefill K1 3 a Mamba block, 2 an attention block and 1,
    K2 once an attention block and K4 once a Mamba block); (e) both
    launchers on jamba's smoke configuration, the train launcher through
    ``--mesh --grad-compress int8_ef`` (the MoE backward, K2-bwd, K4-bwd
    at N 16 and K3 on the card; ``clis`` False leaves them to the cli
    phase, which starts every launcher run together). (d), the kernels
    at jamba's shapes, is :func:`hybrid_kernel_checks` in the kernel
    phase."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import tree_leaves
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    full = get_config(HYBRID_ARCH)
    out = {"reference": hybrid_block_reference(full),
           "moe": moe_reference(full)}
    cfg = full.scaled(n_layers=HYBRID["depth"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(HYBRID["seed"])
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / GIB
    log(f"[hybrid] {cfg.name}: {cfg.n_layers} layers, "
        f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.2f}B "
        f"parameters, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / GIB:.2f} GiB allocated, "
        f"{init_peak:.2f} GiB at the init's peak (a stacked leaf drawn "
        f"in fp32)")
    torch.cuda.reset_peak_memory_stats()
    out["serve"] = slice_phase(cfg, "hybrid slice", FAMILY_SERVE,
                               model=model, params=params, spellings=False)
    out["serve"].update(peak_gib=torch.cuda.max_memory_allocated() / GIB,
                        init_peak_gib=init_peak)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    if clis:
        out["cli"] = run_clis(launcher_runs(HYBRID_CLIS),
                              dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                              ROOT / "chiprun_out" / "hybrid_cli")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[hybrid] phase {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ #
# MLA and the moe family: deepseek-v2-lite-16b (and deepseek-v3's     #
# compressed queries)                                                 #
# ------------------------------------------------------------------ #
def mla_kernel_checks(cfg, cfg_v3) -> list[dict]:
    """K1, K1-bwd, K3a and K3b at the shapes the MLA phase (17) gives
    them, with the kernel phase's tolerances: K1 on the latent (kv_lora
    512) at a decode step's 8 rows, a prefill's 128 and a training
    microbatch's 2,048, at d_model 2048 at 8 rows, and at deepseek-v3's
    q_norm width (1536) at the reference's 32 positions and 128; K1-bwd
    at the microbatch at 512 (its 2048 is the main shape's); K3a and K3b
    at the 4-layer training layout's two largest bucket sizes (the three
    MoE layers' stacked experts, 553,648,128 elements each, and the
    embedding's and the head's, 209,715,200) and its smallest (2,048).
    None of these shapes is a main one."""
    tokens = FAMILY_TRAIN["n_groups"] * FAMILY_TRAIN["per_type_batch"] \
        * FAMILY_TRAIN["seq"]
    r = cfg.kv_lora_rank
    rows = [(FAMILY_SERVE["slots"], r), (max(FAMILY_SERVE["buckets"]), r),
            (tokens, r), (FAMILY_SERVE["slots"], cfg.d_model),
            (MLA["ref_positions"], cfg_v3.q_lora_rank),
            (max(FAMILY_SERVE["buckets"]), cfg_v3.q_lora_rank)]
    sizes = sorted(set(train_layout(cfg.scaled(n_layers=MLA["train_depth"]),
                                    settings=FAMILY_TRAIN).bucket_sizes))
    out = [check_rmsnorm(cfg, rows), check_rmsnorm_bwd(cfg, [(tokens, r)]),
           *check_int8_ef(int8_ef_cases(sizes[-2:] + sizes[:1]))]
    for k in out:
        for sh in k["shapes"]:
            sh["main"] = False
            sh["path"] = "mla"
    return out


def _route_sets(gates, k: int):
    """Each token's top-k experts, as sorted index rows."""
    import torch

    return torch.topk(gates, k).indices.sort(-1).values


def mla_block_reference(cfg, cfg_v3) -> dict:
    """(a) deepseek-v2-lite's ``attn_dense`` and ``attn_moe`` blocks and
    deepseek-v3's MLA mixer with its ln1 (kind ``attn``: d 7168, 128
    heads, q_lora 1536) at published width in fp32, the card (kernels)
    against the CPU (plain versions) on the same parameters (drawn on
    the card) and the same ``MLA["ref_positions"]`` positions: each
    output within 1e-5 of the largest |ref|, and every token of the MoE
    layer routed to the same experts on both."""
    import numpy as np
    import torch

    from repro_torch.models import build_model, cast_params
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import rmsnorm

    n = MLA["ref_positions"]
    out = {}
    for i, (c, kind) in enumerate(((cfg, "attn_dense"), (cfg, "attn_moe"),
                                   (cfg_v3, "attn"))):
        t0 = time.perf_counter()
        x_np = np.random.default_rng(8 + i).standard_normal(
            (1, n, c.d_model)).astype(np.float32)
        gen = torch.Generator(device="cuda").manual_seed(MLA["seed"] + i)
        bp = cast_params(model_mod._init_block(gen, kind, c, "cuda"),
                         dtype=torch.float32)
        per = {}
        for dev, params in (("cuda", bp), ("cpu", cast_params(bp, "cpu"))):
            model = build_model(c, device=dev)
            x = torch.from_numpy(x_np).to(dev)
            pos = torch.arange(n, device=dev)[None]
            with torch.no_grad():
                y = model._block(x, params, kind, pos)
                gates = None
                if kind.endswith("moe"):
                    h = rmsnorm(x, params["ln1"], c.norm_eps)
                    x1 = x + model._attn_forward(h, params["attn"], pos)
                    h2 = rmsnorm(x1, params["ln2"], c.norm_eps)
                    gates = torch.matmul(h2.reshape(n, -1).float(),
                                         params["moe"]["router"].float())
            per[dev] = (y.cpu(), None if gates is None else gates.cpu())
            del params
        del bp
        gc.collect()
        torch.cuda.empty_cache()
        (y_gpu, g_gpu), (y_cpu, g_cpu) = per["cuda"], per["cpu"]
        err = ((y_gpu.double() - y_cpu.double()).abs().max()
               / y_cpu.double().abs().max()).item()
        rec = {"arch": c.name, "rel_err": err, "tol": 1e-5, "positions": n}
        if g_cpu is not None:
            k = c.moe.top_k
            differ = (_route_sets(g_gpu, k) != _route_sets(g_cpu, k)).any(-1)
            srt = torch.sort(g_cpu, -1, descending=True).values
            rec.update(routed_otherwise=int(differ.sum()),
                       min_gate_gap=(srt[:, k - 1] - srt[:, k]).min().item(),
                       gate_diff=(g_gpu - g_cpu).abs().max().item())
            if differ.any():
                raise AssertionError(
                    f"mla reference {kind}: {int(differ.sum())} tokens "
                    f"routed otherwise on the card ({rec})")
        if not (err <= 1e-5 and torch.isfinite(y_gpu).all()):
            raise AssertionError(f"mla reference {c.name} {kind}: card vs "
                                 f"CPU {err} of the largest |ref| > 1e-5")
        rec["seconds"] = time.perf_counter() - t0
        log(f"[mla reference] {c.name} {kind}: fp32 card vs CPU {err:.3g} "
            f"of the largest |ref| over {n} positions"
            + (f", no token routed otherwise (smallest top-{c.moe.top_k} "
               f"gate gap {rec['min_gate_gap']:.3g}, card-vs-CPU gates "
               f"{rec['gate_diff']:.3g})" if g_cpu is not None else "")
            + f"; {rec['seconds']:.1f} s")
        out[f"{c.name}:{kind}"] = rec
    return out


def mla_phase(clis: bool = True) -> dict:
    """Phase 17: deepseek-v2-lite-16b at published width. (a) the fp32
    block references (:func:`mla_block_reference`); (b) serving at full
    depth with ``FAMILY_SERVE`` (the slice phase's gates; per prefill
    and decode step K1 3L + 1 = 82: ln1, the latent's kv_norm, ln2 and
    the final norm; no K2, no K4), with the init's and serving's peak
    device memory apart, each within ``MLA["mem_limit_gib"]``; (c)
    training at ``MLA["train_depth"]`` layers with ``FAMILY_TRAIN`` (the
    train phase's gates: K1-bwd 3L + 1 a microbatch, K3a and K3b twice a
    bucket a step); (d) both launchers on deepseek-v2-lite's smoke
    configuration (the train launcher through ``--mesh --grad-compress
    int8_ef``), started together (``clis`` False leaves them to the cli
    phase). Decode against prefill is
    :func:`decode_vs_prefill_pinned`: at 26 MoE layers in bf16 the two
    paths route every position to other experts somewhere. The kernels
    at its shapes are :func:`mla_kernel_checks` in the kernel phase."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import tree_leaves
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = get_config(MLA_ARCH)
    out = {"reference": mla_block_reference(cfg, get_config(MLA_V3_ARCH))}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(MLA["seed"])
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / GIB
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[mla] {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.2f}B "
        f"parameters, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / GIB:.2f} GiB allocated, "
        f"{init_peak:.2f} GiB at the init's peak")
    torch.cuda.reset_peak_memory_stats()
    out["serve"] = slice_phase(cfg, "mla slice", FAMILY_SERVE, model=model,
                               params=params, spellings=False,
                               check_decode=decode_vs_prefill_pinned)
    peak = torch.cuda.max_memory_allocated() / GIB
    out["serve"].update(peak_gib=peak, init_peak_gib=init_peak,
                        n_params=n_params)
    if not max(peak, init_peak) <= MLA["mem_limit_gib"]:
        raise AssertionError(f"mla: peak device memory {peak:.2f} GiB "
                             f"serving, {init_peak:.2f} GiB at the init: "
                             f"over {MLA['mem_limit_gib']} GiB")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = train_phase(
        cfg, dict(FAMILY_TRAIN, depths=(MLA["train_depth"],)), "mla train")
    gc.collect()
    torch.cuda.empty_cache()
    if clis:
        out["cli"] = run_clis(launcher_runs(MLA_CLIS),
                              dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                              ROOT / "chiprun_out" / "mla_cli")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mla] phase {out['seconds']:.1f} s")
    return out


def small_head_checks(cfg) -> list[dict]:
    """K2 and K2-bwd at head dims 16 and 32 (the zero-filled tiles of the
    bf16 route, the fp32 route's narrow rows), with the kernel phase's
    gates and a second call's bits: the launchers' smoke heads (H 4, KV
    2, D 16) at the cli train run's microbatch (8 rows of 64 tokens), a
    ragged last tile (S 200) and one token; ``cfg``'s heads (qwen2.5-3b:
    H 16, KV 2) at a training microbatch (B 8, S 256) at D 16 and D 32,
    and at D 32 a ragged last tile and one token; bf16 and fp32. None of
    these shapes is a main one."""
    import torch

    from repro_torch.configs import smoke_config

    smoke = smoke_config(ARCH)
    micro, seq = TRAIN["n_groups"] * TRAIN["per_type_batch"], TRAIN["seq"]
    d16, d32 = cfg.scaled(head_dim=16), cfg.scaled(head_dim=32)
    bf16, fp32 = torch.bfloat16, torch.float32
    out = [check_flash(smoke, [(8, 64, bf16), (8, 64, fp32), (1, 200, bf16),
                               (1, 1, bf16), (1, 1, fp32)]),
           check_flash(d16, [(micro, seq, bf16), (micro, seq, fp32)]),
           check_flash(d32, [(micro, seq, bf16), (micro, seq, fp32),
                             (1, 200, bf16), (1, 1, bf16)]),
           check_flash_bwd(smoke, [(8, 64), (1, 200), (1, 1)]),
           check_flash_bwd(d16, [(micro, seq)]),
           check_flash_bwd(d32, [(micro, seq), (1, 200), (1, 1)])]
    for k in out:
        for sh in k["shapes"]:
            sh["main"] = False
            sh["path"] = "head dims 16 and 32"
    return out


def v3_kernel_checks(cfg) -> list[dict]:
    """K1, K1-bwd, K3a and K3b at the shapes the v3 training phase (18)
    gives them, with the kernel phase's tolerances: K1 and K1-bwd at one
    microbatch's 2,048 rows at d_model 7168, q_norm's 1536 and kv_norm's
    512; K3a and K3b at the two largest bucket sizes of the training
    layout at ``V3_TRAIN``'s first depth (the embedding's and the head's,
    928,514,048 elements each, then a dense block's stacked MLP leaf)
    and its smallest. None of these shapes is a main one."""
    tokens = V3_TRAIN["n_groups"] * V3_TRAIN["per_type_batch"] \
        * V3_TRAIN["seq"]
    rows = [(tokens, w) for w in (cfg.d_model, cfg.q_lora_rank,
                                  cfg.kv_lora_rank)]
    sizes = sorted(set(train_layout(cfg.scaled(
        n_layers=V3_TRAIN["depths"][0]), settings=V3_TRAIN).bucket_sizes))
    out = [check_rmsnorm(cfg, rows), check_rmsnorm_bwd(cfg, rows),
           *check_int8_ef(int8_ef_cases(sizes[-2:] + sizes[:1]))]
    for k in out:
        for sh in k["shapes"]:
            sh["main"] = False
            sh["path"] = "v3_train"
    return out


def v3_state_bytes(cfg) -> dict:
    """The v3 training state on the card at ``cfg``'s depth, reckoned
    from storage-free (meta) parameters: the params (bf16, fp32 norms),
    the bf16 accumulator, the two bf16 moments, the int8 EF sync's fp32
    residuals err1 and err2 (each the layout's padded size at one rank)
    and its fp32 scratch bucket (the largest), in bytes."""
    import torch

    from repro_torch.dist import tree_leaves
    from repro_torch.models.model import Model

    leaves = tree_leaves(Model(cfg, torch.device("meta")).init(
        torch.Generator()))
    n = sum(t.numel() for t in leaves)
    layout = train_layout(cfg, settings=V3_TRAIN)
    out = {"params": sum(t.numel() * t.element_size() for t in leaves),
           "accumulator": 2 * n, "moments": 2 * 2 * n,
           "ef_residuals": 2 * 4 * layout.n_elems,
           "sync_scratch": 4 * max(layout.bucket_sizes)}
    out["total"] = sum(out.values())
    out["n_params"] = n
    return out


def v3_gates(ex, adamw_update) -> dict:
    """The bf16 accumulator's gates, armed on the built executor before
    its run. (a) Now, at the initial params: the step's own accumulator
    (``step.accumulate``) over the masked schedule's batch (S_A 2: two
    microbatches) equals, bit for bit, each microbatch's gradient rounded
    to bf16 and the two added in order in bf16; an fp32 accumulator
    gives another dtype and their fp32 sum rounded once. (b) On the first
    step the run dispatches: the gradients AdamW receives are bf16, and
    each bucket's leaves are the bf16 rounding of what the sync left in
    that bucket (checksums: the sync's cast back); the snapshot's
    moments and the live accumulator are bf16. Returns the record, (b)'s
    part filled during the run; ``adamw_update`` is the step module's
    own, which (b) wraps."""
    import copy

    import numpy as np
    import torch

    import repro_torch.train.step as step_mod
    from repro_torch.des import get_scheme
    from repro_torch.dist import tree_leaves

    state = copy.deepcopy(ex.state)
    get_scheme("spare", r=state.r).recover(state, [0])
    batch = ex._device_batch(0, state)
    n_micro = int(batch["weights"].shape[0])
    step = ex._step_fn
    chain = None
    for j in range(n_micro):
        one = {k: v[j:j + 1] for k, v in batch.items()}
        leaves = tree_leaves(step.accumulate(ex.params, one)[2])
        if chain is None:
            chain = [t.clone() for t in leaves]
        else:
            for c, t in zip(chain, leaves):
                c.add_(t)
    got = tree_leaves(step.accumulate(ex.params, batch)[2])
    rec = {"microbatches": n_micro,
           "accumulator_dtypes": sorted({str(t.dtype) for t in got})}
    rec["accumulator_is_bf16_chain"] = (
        rec["accumulator_dtypes"] == ["torch.bfloat16"] and all(
            torch.equal(a.view(torch.int16), b.view(torch.int16))
            for a, b in zip(got, chain)))
    del chain, got, batch
    gc.collect()
    torch.cuda.empty_cache()

    lay = ex._layout
    fills = [0] * lay.n_buckets
    for i, b in enumerate(lay.bucket_of):
        fills[b] = lay.offsets[i] + int(np.prod(lay.shapes[i],
                                                dtype=np.int64))
    synced: list[int] = []
    inner = ex._grad_sync._sync_bucket

    def recorded(buf, *rest):
        inner(buf, *rest)
        if "grad_dtypes" not in rec:         # the first step only
            synced.append(checksums(
                [buf[:fills[len(synced)]].to(torch.bfloat16)])[0])

    def checked(grads, *args, **kwargs):
        if "grad_dtypes" not in rec:
            leaves = tree_leaves(grads)
            per = [0] * lay.n_buckets
            for i, leaf in enumerate(leaves):
                per[lay.bucket_of[i]] += checksums([leaf])[0]
            snap = ex._snapshot[1][1]
            rec.update(
                grad_dtypes=sorted({str(t.dtype) for t in leaves}),
                buckets_synced=len(synced), cast_back=per == synced,
                snapshot_moment_dtypes=sorted({str(t.dtype) for t in (
                    tree_leaves(snap.mu) + tree_leaves(snap.nu))}),
                live_accumulator=sorted(ex._step_fn.buckets),
                live_accumulator_dtypes=sorted({str(t.dtype) for t in
                                                tree_leaves(
                    ex._step_fn.buckets["tree"])}))
        return adamw_update(grads, *args, **kwargs)

    ex._grad_sync._sync_bucket = recorded
    step_mod.adamw_update = checked
    return rec


def v3_train_phase() -> dict:
    """Phase 18: deepseek-v3-671b trained at published width with its
    own settings (``V3_TRAIN``): the state reckoned at each depth first
    (a depth whose reckoning passes the limit is not tried), then the
    train phase's gates (finite losses, the report equal to the script,
    the rollback bit-identical to the snapshot, the replayed step's loss
    bit-identical to its first execution, exact K1, K1-bwd, K3a and K3b
    counts and K2 at 0) and :func:`v3_gates`."""
    import torch

    import repro_torch.train.step as step_mod
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = get_config(V3_ARCH)
    reckoned = {d: v3_state_bytes(cfg.scaled(n_layers=d))
                for d in V3_TRAIN["depths"]}
    for d, r in reckoned.items():
        log(f"[v3 train] {d} layers: {r['n_params'] / 1e9:.3f}B parameters, "
            f"state reckoned at {r['total'] / GIB:.2f} GiB ("
            + ", ".join(f"{k} {v / GIB:.2f}" for k, v in r.items()
                        if k not in ("total", "n_params")) + ")")
    depths = tuple(d for d in V3_TRAIN["depths"]
                   if reckoned[d]["total"] / GIB <= V3_TRAIN["mem_limit_gib"])
    if not depths:
        raise AssertionError(f"v3 train: no depth's state fits "
                             f"{V3_TRAIN['mem_limit_gib']} GiB")
    original = step_mod.adamw_update
    try:
        out = train_phase(cfg, dict(V3_TRAIN, depths=depths), "v3 train",
                          before=lambda ex: v3_gates(ex, original))
    finally:
        step_mod.adamw_update = original
    gates = out["before"]
    bf16 = ["torch.bfloat16"]
    if not (gates["microbatches"] >= 2 and gates["accumulator_is_bf16_chain"]
            and gates["grad_dtypes"] == bf16 and gates["cast_back"]
            and gates["buckets_synced"] == out["buckets"]
            and gates["snapshot_moment_dtypes"] == bf16
            and gates["live_accumulator"] == ["tree"]
            and gates["live_accumulator_dtypes"] == bf16):
        raise AssertionError(f"v3 train: the bf16 settings' gates: {gates}")
    if not all(s["s_a"] >= 2 for s in out["steps"]):
        raise AssertionError("v3 train: a step ran one microbatch")
    torch.cuda.empty_cache()
    out["reckoned_gib"] = {str(d): {k: v / GIB for k, v in r.items()
                                    if k != "n_params"}
                           for d, r in reckoned.items()}
    out["n_params"] = reckoned[out["config"]["n_layers"]]["n_params"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[v3 train] phase {out['seconds']:.1f} s; gates {gates}")
    return out


CLI_FAILURE = {"kind": "correlated", "scope": "rack", "burst_prob": 1.0,
               "mtbf": 400.0}


def cli_phase(more: dict | None = None) -> dict:
    """Both launchers as subprocesses on the card at the smoke
    configuration, with ``--failure-model``, ``--topology`` and
    ``--ckpt-dir`` (under ``chiprun_out/``, removed after); the train
    launcher through ``--mesh --grad-compress int8_ef``, also on mamba2
    (its smoke widths: K4 and K4-bwd at P 8, N 16, Q 32) with
    ``--mtbf-steps``; and ``more`` (``python -m`` arguments by name: the
    hybrid and MLA phases' launcher runs in a whole run), all started
    together, with the train launcher's command also run with ``--device
    cpu``. Gates: exit code 0 and the report parsed; the card's train
    launcher prints the CPU run's ``params``, head dim, steps and failure
    counts (the JAX launchers' smoke configuration on both: a widened
    head dim would change ``params``), and its first loss within
    ``CLI_FIRST_LOSS_TOL`` of the CPU run's."""
    import shutil

    base = ROOT / "chiprun_out" / "cli"
    shutil.rmtree(base, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def train(where: str) -> list:
        return [sys.executable, "-m", "repro_torch.launch.train",
                "--arch", ARCH, "--steps", "8", "--n-groups", "8", "-r",
                "2", "--seq", "64", "--per-type-batch", "1", "--mesh",
                "--grad-compress", "int8_ef", "--failure-model",
                json.dumps(CLI_FAILURE), "--topology",
                json.dumps({"n_groups": 8, "hosts_per_group": 2,
                            "hosts_per_rack": 4}),
                "--seconds-per-step", "64", "--ckpt-dir", str(base / where)]

    runs = {
        "train": train("train"),
        "train_cpu": [*train("train_cpu"), "--device", "cpu"],
        "train_ssm": [sys.executable, "-m", "repro_torch.launch.train",
                      "--arch", SSM_ARCH, "--steps", "4", "--n-groups", "8",
                      "-r", "2", "--seq", "64", "--per-type-batch", "1",
                      "--mtbf-steps", "2", "--mesh", "--grad-compress",
                      "int8_ef"],
        "serve": [sys.executable, "-m", "repro_torch.launch.serve",
                  "--arch", ARCH, "--replicas", "2", "--requests", "8",
                  "--failure-model", json.dumps(CLI_FAILURE), "--topology",
                  json.dumps({"n_groups": 2, "hosts_per_group": 1,
                              "hosts_per_rack": 2}),
                  "--ckpt-dir", str(base / "serve")]}
    runs.update(launcher_runs(more or {}))
    try:
        out = run_clis(runs, env, base / "logs")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    card, cpu = out["train"]["report"], out["train_cpu"]["report"]
    # the checkpoint count follows the wall clock (the Eq.-1 interval)
    same = [k for k in cpu if k not in ("device", "first_loss", "ckpts")]
    diff = {k: (card.get(k), cpu[k]) for k in same if card.get(k) != cpu[k]}
    gap = abs(card["first_loss"] - cpu["first_loss"])
    if diff or cpu["device"] != "cpu" or card["device"] == "cpu":
        raise AssertionError(f"cli: the card's train launcher against the "
                             f"CPU run (card, cpu): {diff}")
    if not gap <= CLI_FIRST_LOSS_TOL:
        raise AssertionError(f"cli: first loss {card['first_loss']} on the "
                             f"card, {cpu['first_loss']} on the CPU: gap "
                             f"{gap} > {CLI_FIRST_LOSS_TOL}")
    out["train_vs_cpu"] = {"same": same, "first_loss_gap": gap,
                           "tol": CLI_FIRST_LOSS_TOL}
    log(f"[cli] the card's train launcher prints the CPU run's {same} "
        f"(params {card['params']}, head_dim {card['head_dim']}); first "
        f"loss {card['first_loss']} vs {cpu['first_loss']}")
    return out


def run_clis(runs: dict, env: dict, logs: Path) -> dict:
    """The launcher commands of ``runs`` as subprocesses, all started at
    once (smoke-sized runs that each hold a sliver of the card: together
    they take about as long as the longest alone), their output in files
    under ``logs``; each must exit 0 with its report parsed (the train
    launcher's ``[train]`` lines, the serve launcher's JSON, every
    request completed). A process still running when this returns, on
    a failure, is killed."""
    import re

    logs.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    try:
        for name, cmd in runs.items():
            with open(logs / f"{name}.out", "w") as fo, \
                    open(logs / f"{name}.err", "w") as fe:
                procs[name] = subprocess.Popen(cmd, stdout=fo, stderr=fe,
                                               text=True, env=env, cwd=ROOT)
        for name, proc in procs.items():
            rc = proc.wait(timeout=max(1.0, 600 - (time.perf_counter()
                                                   - t0)))
            secs = time.perf_counter() - t0
            stdout = (logs / f"{name}.out").read_text()
            if rc != 0:
                raise AssertionError(
                    f"cli {name}: exit {rc}: "
                    f"{(logs / f'{name}.err').read_text()[-2000:]}")
            if name.startswith("train"):
                done = re.search(r"\[train\] done: (\d+) steps .* on (.+)",
                                 stdout)
                lines = "\n".join(
                    line for line in stdout.splitlines()
                    if line.startswith(("[train] loss", "[train] recovery")))
                fields = dict(re.findall(r"(\w+)=(\d+)", lines))
                head = re.search(r"\[train\] arch=.* params=([\d,]+) "
                                 r"head_dim=(\d+)", stdout)
                first = re.search(r"\[train\] loss (\S+) ->", stdout)
                if done is None or "failures" not in fields or None in (
                        head, first):
                    raise AssertionError(f"cli {name}: no report line in "
                                         f"{stdout[-2000:]}")
                report = {"steps": int(done.group(1)),
                          "device": done.group(2).strip(),
                          "params": int(head.group(1).replace(",", "")),
                          "head_dim": int(head.group(2)),
                          "first_loss": float(first.group(1)),
                          **{k: int(v) for k, v in fields.items()}}
            else:
                rep = json.loads(stdout)
                if rep["completed_requests"] != rep["requests"]:
                    raise AssertionError(f"cli serve: {rep}")
                report = {k: rep[k] for k in (
                    "device", "completed_requests", "requests", "events",
                    "recompiles", "tokens_per_s")}
            out[name] = {"seconds_from_start": secs, "report": report}
            log(f"[cli] {name}: exit 0, {secs:.1f} s after the runs "
                f"started; {report}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# ------------------------------------------------------------------ #
# the campaign runner: DES grid, live trainer sweep, gray arms        #
# ------------------------------------------------------------------ #
#: the live cells as the JAX package's presets make them (N 8, r 3, 40
#: steps, seq 32, one example a type, the rack-dominated topology; the
#: gray arms: N 8, r 2, 32 steps, group 0 at 3x over polls 4-15), at
#: the full width of qwen2.5-3b at ``depth`` layers, whose training
#: state (below) must fit ``mem_limit_gib``. 2 layers: 36 fit the card
#: (63 GiB) but the phase took 600 s there on one H100, and at 24 and 18
#: layers (~395 and ~400 s) the script took 1,018 s of its 1,200 once the
#: SSM training phase came; 12 (~270 s) left no room for the families
#: phase (~10 s a layer), 6 (178-195 s) none for the hybrid phase (~80
#: s), and 4 (173-201 s) none for the MLA phase (~95 s)
CAMPAIGN = dict(preset="smoke", jobs=(1, 2), n=8, r=3, steps=40, seq=32,
                per_type_batch=1, gray_steps=32, depth=2,
                mem_limit_gib=75.0, coverage=0.95, equivalence_tol=1e-2)
#: the counts a trainer cell's report must share with the same cell at
#: smoke size on the CPU (the injector and the scheme are host-side)
TRAINER_COUNTS = ("steps_done", "failures", "wipeouts", "reorders",
                  "patches", "recovery_events", "multi_group_events",
                  "rollback_steps", "final_s_a")
GRAY_SAME = ("flag_step", "demote_step", "readmit_step", "health_actions",
             "ttt_s")


def campaign_cells(trace_dir: str | None = None) -> tuple[list, list]:
    """The live trainer cells and the gray arms, as the JAX package's
    presets make them with ``CAMPAIGN``'s sizes."""
    from repro_torch.scenarios.campaign import (gray_regime_cells,
                                                trainer_regime_cells)

    c = CAMPAIGN
    cells = trainer_regime_cells(n=c["n"], r=c["r"], steps=c["steps"],
                                 seq=c["seq"],
                                 per_type_batch=c["per_type_batch"],
                                 trace_dir=trace_dir)
    return cells, gray_regime_cells(steps=c["gray_steps"],
                                    trace_dir=trace_dir)


def campaign_microbatches() -> list[tuple[int, int]]:
    """The ``(examples, seq)`` of one microbatch on the campaign's live
    paths: every group's per-type batch, stacked (N x per-type batch
    rows of seq tokens; the §3.1 check's two gradients take the same
    batch)."""
    cells, gray = campaign_cells()
    return sorted({(x["n"] * x["per_type_batch"], x["seq"])
                   for x in (*cells, *gray)})


def elastic_degrees() -> list[int]:
    """The data degrees the elastic phase's ranks run at: the full
    degree and, for an arm on the elastic executor, the degree its kill
    shrinks to (the bit run visits the same two)."""
    from repro_torch.elastic import shrink_degree
    from repro_torch.scenarios.campaign import elastic_regime_cells

    out = set()
    for c in elastic_regime_cells(n=ELASTIC["n"]):
        out.add(c["n"])
        if c["elastic"]:
            out.add(shrink_degree(c["n"], c["n"] - len(c["victims"])))
    return sorted(out)


def elastic_microbatches() -> list[tuple[int, int]]:
    """The ``(examples, seq)`` of one rank's microbatch in the elastic
    phase: N x per-type batch / DP rows of seq tokens at each of
    :func:`elastic_degrees`."""
    from repro_torch.scenarios.campaign import elastic_regime_cells

    c = elastic_regime_cells(n=ELASTIC["n"])[0]
    return sorted({(c["n"] * c["per_type_batch"] // dp, c["seq"])
                   for dp in elastic_degrees()})


def campaign_bytes(cfg) -> dict:
    """What a live trainer cell holds on the card at ``cfg``, from the
    leaves (as :func:`state_bytes`): the params (bf16, fp32 norms and
    QKV biases), the AdamW moments (fp32), the step's fp32 accumulator
    and the two fp32 gradient trees that the §3.1 check holds at once
    (``spare_grads`` and ``vanilla_reference_grads``)."""
    n = cfg.param_count() + (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    ckpt, _ = state_bytes(cfg)
    moments = 8 * n
    out = {"params": ckpt - moments - 4, "moments": moments,
           "accumulator": 4 * n, "two_grad_trees": 8 * n}
    out["total"] = sum(out.values())
    return out


def campaign_fits(cfg) -> dict:
    """:func:`campaign_bytes` at ``cfg`` (``CAMPAIGN["depth"]`` layers),
    printed, in GiB; raises if the total passes ``mem_limit_gib``."""
    b = campaign_bytes(cfg)
    fits = b["total"] <= CAMPAIGN["mem_limit_gib"] * GIB
    log(f"[campaign] depth {cfg.n_layers}: params {b['params'] / GIB:.2f} + "
        f"AdamW moments {b['moments'] / GIB:.2f} + accumulator "
        f"{b['accumulator'] / GIB:.2f} + two gradient trees "
        f"{b['two_grad_trees'] / GIB:.2f} = {b['total'] / GIB:.2f} GiB "
        f"against {CAMPAIGN['mem_limit_gib']:.0f}: "
        + ("fits" if fits else "over"))
    if not fits:
        raise AssertionError(f"campaign: {cfg.n_layers} layers do not fit: "
                             f"{b}")
    return {k: v / GIB for k, v in b.items()}


def des_grid() -> dict:
    """(a) The ``smoke`` preset through the port's campaign runner at
    each of ``CAMPAIGN["jobs"]`` (several: spawned workers): artifacts
    byte-identical; rankings printed."""
    import shutil

    from repro_torch.scenarios import (CAMPAIGN_PRESETS, ranking_by_regime,
                                       run_campaign, save_artifacts)

    spec = CAMPAIGN_PRESETS[CAMPAIGN["preset"]]
    base = ROOT / "chiprun_out" / "campaign" / "des"
    shutil.rmtree(base, ignore_errors=True)
    runs = {}
    for jobs in CAMPAIGN["jobs"]:
        t0 = time.perf_counter()
        results = run_campaign(spec.cells(), jobs=jobs)
        secs = time.perf_counter() - t0
        paths = save_artifacts(f"{spec.name}_jobs{jobs}", results,
                               outdir=base)
        runs[jobs] = {"seconds": secs,
                      "bytes": [p.read_bytes() for p in paths],
                      "ranking": ranking_by_regime(results)}
        log(f"[campaign] DES grid {spec.name}: {len(results)} cells at "
            f"jobs {jobs} in {secs:.2f} s")
    first = runs[CAMPAIGN["jobs"][0]]
    for jobs, run in runs.items():
        if run["bytes"] != first["bytes"]:
            raise AssertionError(f"campaign: the DES artifacts at jobs "
                                 f"{jobs} differ from jobs "
                                 f"{CAMPAIGN['jobs'][0]}")
    for regime, ranking in first["ranking"].items():
        log(f"[campaign] {regime}: " + " > ".join(
            f"{e['scheme']}({e['mean_ttt_norm']:.2f})" for e in ranking))
    return {"preset": spec.name, "cells": len(spec.cells()),
            "seconds": {str(j): r["seconds"] for j, r in runs.items()},
            "csv_bytes": len(first["bytes"][0]),
            "json_bytes": len(first["bytes"][1]),
            "identical": True, "ranking": first["ranking"]}


class _Losses:
    """While active, keeps every trainer run's losses (``runs``, one list
    a run): a cell's row carries only the first and the last."""

    def __enter__(self):
        from repro_torch.train.trainer import SpareTrainer

        self.runs, self._cls, run = [], SpareTrainer, SpareTrainer.run
        self._run = run

        def recorded_run(trainer, *a, **kw):
            rep = run(trainer, *a, **kw)
            self.runs.append(list(rep.losses))
            return rep

        SpareTrainer.run = recorded_run
        return self

    def __exit__(self, *exc):
        self._cls.run = self._run
        return False


def _trace_seconds(trace_path) -> tuple[dict, list]:
    """From a cell's trace: the seconds of each step's ``compute`` span
    (dispatch through the loss read, which synchronises) by the step's
    ``S_A``, the first step of the run left out (warm-up); and the
    seconds of each ``ckpt_save`` span (a host snapshot, in place)."""
    from repro_torch.obs import load_trace

    view = load_trace(trace_path)
    computes = view.named("compute")
    by_sa: dict = {}
    for s in view.named("step")[1:]:
        inner = [c.dur for c in computes if s.ts <= c.ts and c.end <= s.end]
        by_sa.setdefault(str(s.args["s_a"]), []).extend(
            d / 1e6 for d in inner)
    return by_sa, [c.dur / 1e6 for c in view.named("ckpt_save")]


def _median(xs):
    return sorted(xs)[len(xs) // 2] if xs else None


def _live_cell(run, cell, cfg, losses: _Losses, tag: str) -> dict:
    """One live cell on the card: launch counts from 0 just before and
    read just after, seconds, peak device memory, the process's peak
    RSS so far, the run's losses, and step and snapshot seconds from
    its trace; then everything it held is freed."""
    import torch

    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    row = run(cell, device="cuda", cfg=cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.launches)
    gc.collect()
    torch.cuda.empty_cache()
    steps, snaps = _trace_seconds(cell["trace"])
    out = {"row": row, "seconds": secs, "launches": launches,
           "losses": losses.runs[-1], "snapshot_s": snaps,
           "peak_gib": torch.cuda.max_memory_allocated() / GIB,
           "peak_rss_gib": _peak_rss() / GIB,
           "step_s_by_s_a": {sa: {"median": _median(v), "n": len(v)}
                             for sa, v in steps.items()}}
    log(f"[campaign] {tag} on the card: {secs:.1f} s, peak "
        f"{out['peak_gib']:.2f} GiB, peak RSS {out['peak_rss_gib']:.2f} GiB, "
        f"snapshots {[round(s, 2) for s in out['snapshot_s']]} s, step s "
        f"by S_A {out['step_s_by_s_a']}; {row}")
    return out


def _obs_gate(trace, *flags) -> dict:
    """The port's trace analyzer on ``trace``, as a user runs it; its
    report is printed and parsed, and a non-zero exit fails."""
    out_json = Path(str(trace) + ".obs.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.obs", str(trace),
           "--json", str(out_json), *flags]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          cwd=ROOT)
    log(f"[campaign] python -m repro_torch.launch.obs {Path(trace).name} "
        f"{' '.join(flags)}: exit {proc.returncode}\n{proc.stdout}"
        f"{proc.stderr}")
    if proc.returncode != 0:
        raise AssertionError(f"campaign: launch.obs {flags} failed on "
                             f"{trace}: {proc.stderr[-1000:]}")
    return json.loads(out_json.read_text())


def campaign_phase(cfg_full) -> dict:
    """The campaign runner (see the module doc, phase 13): (a) the DES
    grid; (b) the three live trainer cells at full width, against the
    same cells at smoke size on the CPU; (c) the gray arms the same way;
    (d) ``launch.obs`` over their traces."""
    import shutil

    out = {"des": des_grid()}
    cfg = cfg_full.scaled(n_layers=CAMPAIGN["depth"], grad_accum=1)
    memory_gib = campaign_fits(cfg)
    # the trace path is part of a cell's key, so of its seed: relative to
    # the checkout's root, the cells are the same wherever it lies
    traces = Path("chiprun_out") / "campaign" / "traces"
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        shutil.rmtree(traces, ignore_errors=True)
        traces.mkdir(parents=True)
        return {**out, **_campaign_live(cfg, memory_gib, traces)}
    finally:
        os.chdir(cwd)


def _campaign_live(cfg, memory_gib: dict, traces: Path) -> dict:
    """Phase 12 (b)-(d), from the checkout's root."""
    import math

    from repro_torch.scenarios.campaign import (run_gray_cell,
                                                run_trainer_cell)

    c = CAMPAIGN
    cells, gray = campaign_cells(str(traces))
    trainer, arms = {}, {}
    with _Losses() as losses:
        # the CPU runs first: each writes the trace its card run then
        # overwrites (the trace path is part of the cell, so of its seed)
        for cell in cells:
            label = cell["model"]["label"]
            t0 = time.perf_counter()
            cpu = run_trainer_cell(cell, device="cpu")
            log(f"[campaign] {label} at smoke size on the CPU in "
                f"{time.perf_counter() - t0:.1f} s: {cpu}")
            trainer[label] = {"cpu": cpu, **_live_cell(
                run_trainer_cell, cell, cfg, losses, label)}
        for cell in gray:
            cpu = run_gray_cell(cell, device="cpu")
            log(f"[campaign] gray {cell['arm']} on the CPU: {cpu}")
            arms[cell["arm"]] = {"cpu": cpu, **_live_cell(
                run_gray_cell, cell, cfg, losses, f"gray {cell['arm']}")}

    # gates: (b) the trainer cells
    for label, t in trainer.items():
        row, cpu = t["row"], t["cpu"]
        counts = {k: row[k] for k in TRAINER_COUNTS}
        if counts != {k: cpu[k] for k in TRAINER_COUNTS}:
            raise AssertionError(f"campaign {label}: counts {counts} "
                                 f"differ from the CPU run's {cpu}")
        if not (t["losses"] and all(math.isfinite(x) for x in t["losses"])):
            raise AssertionError(f"campaign {label}: a loss is not finite")
        if not row["max_grad_check_err"] <= c["equivalence_tol"]:
            raise AssertionError(f"campaign {label}: §3.1 error "
                                 f"{row['max_grad_check_err']}")
    multi = sum(t["row"]["multi_group_events"] for t in trainer.values())
    if multi < 1:
        raise AssertionError("campaign: no multi-group event in the sweep")
    # (c) the gray arms
    for arm, a in arms.items():
        row, cpu = a["row"], a["cpu"]
        same = {k: row[k] for k in GRAY_SAME}
        if same != {k: cpu[k] for k in GRAY_SAME}:
            raise AssertionError(f"campaign gray {arm}: {same} differ from "
                                 f"the CPU run's {cpu}")
        if not row["readmit_identical"] or row["recompiles"] != 0:
            raise AssertionError(f"campaign gray {arm}: {row}")
        if not all(math.isfinite(x) for x in a["losses"]):
            raise AssertionError(f"campaign gray {arm}: a loss is not "
                                 f"finite")
    if not arms["demote"]["row"]["ttt_s"] < arms["tolerate"]["row"]["ttt_s"]:
        raise AssertionError("campaign: demotion did not beat tolerating")
    # kernels on the campaign path
    by_path = {"campaign_trainer": {}, "campaign_gray": {}}
    for path, runs in (("campaign_trainer", trainer), ("campaign_gray",
                                                      arms)):
        for r in runs.values():
            for k, v in r["launches"].items():
                by_path[path][k] = by_path[path].get(k, 0) + v
    for k in ("rmsnorm", "rmsnorm_bwd", "flash_attention",
              "flash_attention_bwd"):
        if not all(p[k] > 0 for p in by_path.values()):
            raise AssertionError(f"campaign: {k} never launched: {by_path}")
    # (d) the trace gates
    flags = ("--assert-coverage", str(c["coverage"]))
    obs = {}
    for cell in cells:
        obs[cell["model"]["label"]] = _obs_gate(
            cell["trace"], *flags, "--assert-recovery-markers")
    # a gray episode kills nobody, so its trace carries straggler
    # markers and demote/readmit recoveries but no failure marker:
    # coverage is gated, and the attribution rows must show both edits
    demote = _obs_gate(gray[1]["trace"], *flags)
    kinds = [r["kind"] for r in demote["recovery_events"]]
    if kinds != ["demote", "readmit"]:
        raise AssertionError(f"campaign: the demote arm's attribution "
                             f"rows are {kinds}")
    obs["gray_demote"] = demote
    gauges = json.loads(Path(gray[1]["trace"] + ".metrics.json")
                        .read_text())
    wire = {k: v for sec in ("gauges", "counters")
            for k, v in gauges.get(sec, {}).items() if k.startswith("sync.")}
    log(f"[campaign] wire gauges of the demote arm (one rank, fp32 "
        f"buckets): {wire}")
    return {"depth": cfg.n_layers, "memory_gib": memory_gib,
            "config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                       "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                       "n_kv_heads": cfg.n_kv_heads,
                       "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                       "padded_vocab": cfg.padded_vocab, **c,
                       "jobs": list(c["jobs"])},
            "trainer": trainer, "gray": arms, "launches": by_path,
            "multi_group_events": multi, "wire": wire,
            "obs": {k: {"coverage": v["coverage"],
                        "failure_markers": v["failure_markers"],
                        "recovery_events": [
                            {f: e[f] for f in ("step", "kind", "victims",
                                               "rollback_depth")}
                            for e in v["recovery_events"]]}
                    for k, v in obs.items()},
            "peak_rss_gib": max(r["peak_rss_gib"] for r in
                                [*trainer.values(), *arms.values()])}


# ------------------------------------------------------------------ #
# the elastic tier: four ranks on the one card                        #
# ------------------------------------------------------------------ #
#: the JAX package's elastic arms at N 4 (``arms`` of its three, r 2,
#: ``steps`` of its 24, the kill at step 8, seq 32, two examples a type,
#: the int8 EF sync), one rank a group, the four ranks on the one card
#: over gloo (NCCL refuses two ranks on one device); full-width
#: qwen2.5-3b at ``depth`` layers.
#: Four ranks, not the JAX default of 8: eight full-width replicas on
#: one card leave at most one layer. The depth is fixed at 2 for the
#: script's 1,200 s (on one H100 the phase took 249-281 s at 4 layers and
#: 195 s at 2); the arm's steps (12, the kill at 8, to 6, the kill at 4)
#: and the bit run's (3 and 3 to 2 and 2) were cut for the time the tp
#: phase's part (d) adds; :func:`elastic_fits` asserts that its four ranks' state
#: and CUDA contexts fit ``mem_limit_gib`` on the card and their host
#: snapshots and processes fit the host. The bit-transparency run takes
#: ``bit_steps`` steps at DP 4, reshapes, then ``degraded_steps`` at DP 2.
#: ``rank_process_gib`` is what each rank's process holds on the host
#: besides its snapshot: torch, CUDA and the kernels loaded, gloo's
#: pinned staging of the largest bucket (the embedding's int8 payloads
#: in the sync), which the caching host allocator keeps, and the
#: transients of a step and a reshape (on one H100 the mask arm's ranks
#: peaked at 16.41 GiB at 4 layers, with 8.66 of snapshot);
#: ``host_limit_gib`` is the chip machine's limit (its ``MemTotal``
#: reads 101 GiB), of which ``host_headroom_gib`` stays free for the
#: page cache and the transients a rank's RSS at the end of its run
#: leaves out (a fresh snapshot's copies, gloo's staging in flight)
ELASTIC = dict(n=4, depth=2, steps=6, fail_step=4, arms=("reshape",),
               cpu_arms=("reshape", "restart"), mem_limit_gib=75.0,
               context_gib=0.5, rank_process_gib=9.0, host_limit_gib=96.0,
               host_headroom_gib=8.0, bit_steps=2, degraded_steps=2)
#: the row fields an arm on the card shares with the same cell at smoke
#: size on the CPU
ELASTIC_SAME = ("failures", "wipeouts", "reshapes", "dp_final",
                "steps_done", "recompiles", "compiled_entries",
                "rollback_steps", "outage_s", "elapsed_model_s",
                "work_units", "ttt_s")


def elastic_bytes(cfg) -> dict:
    """What one of ``ELASTIC["n"]`` ranks holds at ``cfg``, from the
    leaves (as :func:`state_bytes`): on the card the params (bf16, fp32
    norms and QKV biases), the AdamW moments and the accumulator (fp32),
    ``err1`` (fp32, the gradient's size) and ``err2`` (fp32, its share of
    the gradient); on the host the snapshot of all but the accumulator."""
    n = cfg.param_count() + (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    ckpt, _ = state_bytes(cfg)
    out = {"params": ckpt - 8 * n - 4, "moments": 8 * n,
           "accumulator": 4 * n, "err1": 4 * n,
           "err2": 4 * n // ELASTIC["n"]}
    out["device"] = sum(out.values())
    out["host_snapshot"] = out["device"] - out["accumulator"]
    return out


def _rss_now() -> int:
    """The process's resident set now, bytes."""
    return next(int(line.split()[1]) * 1024 for line in
                open("/proc/self/status") if line.startswith("VmRSS"))


def elastic_fits(cfg) -> dict:
    """The reckoning at ``cfg`` (``ELASTIC["depth"]`` layers), printed:
    the four ranks' state and CUDA contexts against ``mem_limit_gib`` on
    the card, their host snapshots and processes against the host (the
    smaller of ``MemTotal`` and ``host_limit_gib``) less what this
    process holds and the headroom; raises if either is over."""
    ranks = ELASTIC["n"]
    limit = min(mem_total(), ELASTIC["host_limit_gib"] * GIB)
    avail = limit - _rss_now() - ELASTIC["host_headroom_gib"] * GIB
    b = elastic_bytes(cfg)
    card = ranks * (b["device"] + ELASTIC["context_gib"] * GIB)
    host = ranks * (b["host_snapshot"] + ELASTIC["rank_process_gib"] * GIB)
    log(f"[elastic] depth {cfg.n_layers}: a rank holds params "
        f"{b['params'] / GIB:.2f} + moments {b['moments'] / GIB:.2f} + "
        f"accumulator {b['accumulator'] / GIB:.2f} + err1 "
        f"{b['err1'] / GIB:.2f} + err2 {b['err2'] / GIB:.2f} = "
        f"{b['device'] / GIB:.2f} GiB; {ranks} ranks with a "
        f"{ELASTIC['context_gib']} GiB context each: {card / GIB:.2f} "
        f"GiB on the card against {ELASTIC['mem_limit_gib']:.0f}; "
        f"{ranks} host snapshots of {b['host_snapshot'] / GIB:.2f} "
        f"and processes of {ELASTIC['rank_process_gib']} GiB: "
        f"{host / GIB:.2f} GiB against {avail / GIB:.2f} (the host's "
        f"{limit / GIB:.2f} less this process's RSS and "
        f"{ELASTIC['host_headroom_gib']:.0f} of headroom)")
    reading = {"depth": cfg.n_layers, "card_gib": card / GIB,
               "host_gib": host / GIB, "host_avail_gib": avail / GIB,
               **{k: v / GIB for k, v in b.items()}}
    if card > ELASTIC["mem_limit_gib"] * GIB or host > avail:
        raise AssertionError(f"elastic: {cfg.n_layers} layers do not fit: "
                             f"{reading}")
    return reading


def elastic_bits_rank(rank: int, world: int, cfg, bit_steps: int,
                      degraded_steps: int) -> dict | None:
    """(b) on one rank, with a deep telemetry: ``bit_steps`` steps at DP
    4, ``reshape([0, 1])``, ``degraded_steps`` at DP 2 (a snapshot at
    their start), then ``restore_full_mesh`` and the rollback; the
    state's checksums at each point, the wall seconds of the reshape,
    the restore and the rollback, and what the rank's spans show
    (:func:`_bit_spans`); rank 0 returns every rank's record."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import tree_leaves
    from repro_torch.elastic import ElasticMeshExecutor
    from repro_torch.obs import Telemetry
    from repro_torch.scenarios.campaign import rss_gib

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tel = Telemetry(deep=True)
    ex = ElasticMeshExecutor(cfg, n_groups=world, redundancy=2, seq=32,
                             per_type_batch=2, total_steps=24,
                             grad_compress="int8_ef", telemetry=tel,
                             device="cuda")
    rec: dict = {"rank": rank}

    def sums() -> dict:
        return {"state": checksums(tree_leaves(ex.params)
                                   + tree_leaves(ex.opt_state.mu)
                                   + tree_leaves(ex.opt_state.nu)),
                "opt_step": int(ex.opt_state.step),
                "err1": checksums(list(ex._ef_state["err1"])),
                "err1_zero": all(not bool(e.any())
                                 for e in ex._ef_state["err1"]),
                "err2": [checksums(list(e.view(2, -1))) + checksums([e])
                         for e in ex._ef_state["err2"]]}

    def wall(name: str, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec[name] = time.perf_counter() - t0
        return out

    rss = []
    ex.run(bit_steps)
    rss.append(rss_gib())
    rec["before"] = sums()
    rec["reshape"] = wall("reshape_s", lambda: ex.reshape([0, 1]))
    # also what the next run snapshots at its start
    rec["after_reshape"] = sums()
    ex.run(degraded_steps)
    rss.append(rss_gib())
    wall("restore_s", ex.restore_full_mesh)
    rec["rollback_step"] = wall("rollback_s", ex._rollback)[0]
    rss.append(rss_gib())
    rec["after_rollback"] = sums()
    rec["n_buckets"] = ex._layout.n_buckets
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
    rec["rss_gib"] = max(rss)
    ex.close()
    rec.update(_bit_spans(tel, bit_steps))
    rec["seconds"] = time.perf_counter() - t_start
    every = [None] * world
    dist.all_gather_object(every, rec)
    return every if rank == 0 else None


def _bit_spans(tel, bit_steps: int, dps=(4, 2)) -> dict:
    """From one rank's spans in the bit run: each step (the first
    ``bit_steps`` at DP ``dps[0]``, the rest at ``dps[1]``) with the
    seconds of its ``compute`` span and of the ``grad_sync`` and
    ``param_gather`` spans inside it (none on a retired rank; gloo's
    collectives block the host, so a host span holds the sync's
    transfers), and the seconds of each part the
    elastic executor spans in the reshape, the restore and the rollback
    (``reshape/group``, ``restore/broadcast``, ``rollback/ef_move``...)."""
    from repro_torch.obs import load_trace

    view = load_trace(tel.tracer.to_chrome())
    computes = view.named("compute")
    syncs = view.named("grad_sync") + view.named("param_gather")
    steps = []
    for s in view.named("step"):
        c = next(c for c in computes if s.ts <= c.ts and c.end <= s.end)
        inner = [g.dur for g in syncs if c.ts <= g.ts and g.end <= c.end]
        steps.append({"step": s.args["step"],
                      "dp": dps[0] if s.args["step"] < bit_steps
                      else dps[1],
                      "seconds": c.dur / 1e6, "synced": bool(inner),
                      "sync_s": sum(inner) / 1e6})
    parts: dict = {}
    for sp in view.spans:
        what, _, part = sp.name.partition("/")
        if what in ("reshape", "restore", "rollback") and part:
            got = parts.setdefault(what, {})
            got[f"{part}_s"] = got.get(f"{part}_s", 0.0) + sp.dur / 1e6
    return {"steps": steps, "parts": parts}


def elastic_card_rank(rank: int, world: int, cells: list, cfg,
                      bit_steps: int, degraded_steps: int, tp_cfg=None):
    """The card's ranks, spawned once: the arms (each rank as
    ``run_elastic_cells`` runs it), then (b), then, given ``tp_cfg``, the
    tp phase's ranks (phase 19, :func:`tp_card_rank`); rank 0 returns
    all three."""
    from repro_torch.scenarios.campaign import elastic_cells_on_ranks

    rows = elastic_cells_on_ranks(rank, world, cells, cfg, "cuda")
    gc.collect()          # the last arm's executor and its host snapshot
    bits = elastic_bits_rank(rank, world, cfg, bit_steps, degraded_steps)
    tp = None
    if tp_cfg is not None:
        gc.collect()
        tp = tp_card_rank(rank, world, tp_cfg)
    return (rows, bits, tp) if rank == 0 else None


def _elastic_bit_gates(ranks: list) -> None:
    """(b)'s gates: survivors' replicas untouched, ``err1`` kept, ``err2``
    re-sliced (each half of a survivor's chunk checksums as the old
    chunk it came from); after the restore and the rollback every rank
    holds the snapshot of rank 2 (active when it was taken: the state
    right after the reshape), and ranks 0 and 1 start from zero
    ``err1``."""
    before = [r["before"] for r in ranks]
    for p in (2, 3):
        after = ranks[p]["after_reshape"]
        if after["state"] != before[p]["state"] or \
                after["err1"] != before[p]["err1"]:
            raise AssertionError(f"elastic (b): rank {p}'s state moved in "
                                 f"the reshape")
        i = p - 2
        for b, halves in enumerate(after["err2"]):
            want = [before[2 * i]["err2"][b][2], before[2 * i + 1]["err2"][b][2]]
            if halves[:2] != want:
                raise AssertionError(f"elastic (b): rank {p}'s err2[{b}] is "
                                     f"not the re-sliced gather")
    snap = [r["after_reshape"] for r in ranks]
    for p, r in enumerate(ranks):
        got = r["after_rollback"]
        if got["state"] != snap[2]["state"] or \
                got["opt_step"] != snap[2]["opt_step"]:
            raise AssertionError(f"elastic (b): rank {p} after the rollback "
                                 f"differs from rank 2's snapshot")
        if p < 2 and not got["err1_zero"]:
            raise AssertionError(f"elastic (b): rejoining rank {p}'s err1 is "
                                 f"not zero")
        if p >= 2 and got["err1"] != snap[p]["err1"]:
            raise AssertionError(f"elastic (b): rank {p}'s err1 after the "
                                 f"rollback is not its snapshot's")
        src = snap[2 + p // 2]["err2"]
        if [h[2] for h in got["err2"]] != [h[p % 2] for h in src]:
            raise AssertionError(f"elastic (b): rank {p}'s err2 after the "
                                 f"rollback is not the re-sliced snapshot")


def _elastic_bits_summary(bits: list) -> dict:
    """(b)'s readings from every rank's record: the median step seconds
    and sync share at DP 4 and DP 2 over the ranks that ran those steps
    (each rank's first step at a degree left out: warm-up), the reshape,
    the restore and the rollback on rank 2 (active throughout), each
    with its parts, and every rank's peak device memory and RSS."""
    out = {"seconds": bits[0]["seconds"], "ranks": bits}
    for dp in (4, 2):
        steps = [s for r in bits
                 for s in [s for s in r["steps"]
                           if s["dp"] == dp and s["synced"]][1:]]
        out[f"dp{dp}"] = {
            "step_s": _median([s["seconds"] for s in steps]),
            "sync_share": _median([s["sync_s"] / s["seconds"]
                                   for s in steps]), "n": len(steps)}
    r2 = bits[2]
    for what in ("reshape", "restore", "rollback"):
        out[what] = {"wall_s": r2[f"{what}_s"],
                     **r2["parts"].get(what, {})}
    out["restore_s"] = r2["restore_s"]
    out["rollback_s"] = r2["rollback_s"]
    out["peak_gib"] = [r["peak_gib"] for r in bits]
    out["rss_gib"] = [r["rss_gib"] for r in bits]
    return out


def _elastic_trace(trace, fail_step: int) -> dict:
    """From an arm's trace (written by its final logical rank 0): the
    median seconds of the ``compute`` spans of the steps before the kill
    (DP 4, the run's first step left out) and after it, and the wall
    seconds of each reshape's ``recover`` span."""
    from repro_torch.obs import load_trace

    view = load_trace(trace)
    computes = view.named("compute")
    before, after = [], []
    for s in view.named("step")[1:]:
        inner = [c.dur / 1e6 for c in computes
                 if s.ts <= c.ts and c.end <= s.end]
        (before if s.args["step"] < fail_step else after).extend(inner)
    return {"step_s_before_kill": _median(before),
            "step_s_after_kill": _median(after),
            "reshape_wall_s": [r.dur / 1e6 for r in view.named("recover")
                               if r.args.get("reshape")]}


def elastic_phase(cfg_full, tp: bool = False) -> dict:
    """The elastic tier (see the module doc, phase 14); with ``tp`` its
    spawned ranks then run the tp phase's (phase 19), the CPU's tp arms
    after its elastic arms, and the result holds their records
    (``tp_records``, ``tp_cpu``) for :func:`tp_phase`."""
    import shutil

    import torch

    from repro_torch.kernels import ops

    cfg = cfg_full.scaled(n_layers=ELASTIC["depth"], grad_accum=1)
    reading = elastic_fits(cfg)
    # Triton compiles K1-bwd for a new shape at its first launch: do it
    # here, once, at each microbatch a rank runs (the ranks then load it
    # from Triton's cache)
    for b, s in elastic_microbatches():
        x = torch.ones((b * s, cfg.d_model), dtype=torch.bfloat16,
                       device="cuda", requires_grad=True)
        w = torch.ones(cfg.d_model, device="cuda", requires_grad=True)
        ops.rmsnorm(x, w).sum().backward()
    del x, w
    tp_cfg = dry = None
    if tp:
        tp_cfg = cfg_full.scaled(n_layers=TP["depth"], grad_accum=1)
        tp_fits(tp_cfg)
        tp_prewarm(tp_cfg)
        # (d)'s and (e)'s dry runs, in a process of their own meanwhile
        dry = start_fsdp_dry_runs(tp_cfg)
    # the ranks need the card: give back what this process has cached
    gc.collect()
    torch.cuda.empty_cache()
    # the trace path is part of a cell's key: relative to the checkout
    traces = Path("chiprun_out") / "elastic" / "traces"
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        shutil.rmtree(traces, ignore_errors=True)
        traces.mkdir(parents=True)
        out = _elastic_run(cfg, reading, traces, tp_cfg)
        if dry is not None:
            out["tp_dry"] = dry[0].result()
        return out
    finally:
        if dry is not None:
            dry[1].shutdown()
        os.chdir(cwd)


def elastic_cells(trace_dir: str, arms) -> list[dict]:
    """The elastic phase's cells: ``elastic_regime_cells`` at N
    ``ELASTIC["n"]``, ``ELASTIC["steps"]`` and ``ELASTIC["fail_step"]``,
    the arms of ``arms``. Cut
    for the script's time: the mask arm runs nowhere
    (masking on several ranks runs in the tp phase and the campaign), the
    restart arm on the CPU ranks only (its TTT is modeled, and the card's
    counts equal the CPU's; the wipe-out and rollback on four card ranks
    run in the tp phase)."""
    from repro_torch.scenarios.campaign import elastic_regime_cells

    return [c for c in elastic_regime_cells(n=ELASTIC["n"],
                                            steps=ELASTIC["steps"],
                                            fail_step=ELASTIC["fail_step"],
                                            trace_dir=trace_dir)
            if c["arm"] in arms]


def _elastic_run(cfg, reading: dict, traces: Path, tp_cfg=None) -> dict:
    """Phase 13 (a)-(c), from the checkout's root."""
    import math

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.scenarios.campaign import run_elastic_cells

    n = ELASTIC["n"]
    cells = elastic_cells(str(traces), ELASTIC["arms"])
    # the CPU's cells write their traces apart, so the CPU arms run
    # meanwhile (no seed of an elastic cell depends on its trace path);
    # the card's ranks are spawned once, for the arms and the bit run
    # (and the tp phase's ranks)
    (traces / "cpu").mkdir()
    cpu_cells = elastic_cells(str(traces / "cpu"), ELASTIC["cpu_arms"])

    def cpu_arms():
        t = time.perf_counter()
        rows = run_elastic_cells(cpu_cells, device="cpu")
        elapsed = time.perf_counter() - t
        return rows, elapsed, None if tp_cfg is None else tp_cpu_run()

    with ThreadPoolExecutor(1) as pool:
        cpu_run = pool.submit(cpu_arms)
        t0 = time.perf_counter()
        (rows, bits, tp_records), backend = spawn_ranks(
            elastic_card_rank, n, device="cuda",
            args=(cells, cfg, ELASTIC["bit_steps"],
                  ELASTIC["degraded_steps"], tp_cfg))
        card_s = time.perf_counter() - t0
        cpus, cpu_s, tp_cpu = cpu_run.result()
    cpus = {c["arm"]: row for c, row in zip(cpu_cells, cpus)}
    arms = {}
    for cell, row in zip(cells, rows):
        arm = cell["arm"]
        cpu = cpus[arm]
        per = row["run"]["per_rank"]
        arms[arm] = {"cpu": cpu, "row": row, "seconds": row["elapsed_s"],
                     **_elastic_trace(cell["trace"], cell["fail_step"]),
                     "peak_gib": [r["peak_gib"] for r in per],
                     "rss_gib": [r["rss_gib"] for r in per]}
        log(f"[elastic] {arm} at smoke size on {n} CPU ranks: "
            f"{ {k: cpu[k] for k in ELASTIC_SAME} }; on the card "
            f"({backend}): { {k: row[k] for k in ELASTIC_SAME} }; "
            f"{ {k: v for k, v in arms[arm].items() if k not in ('cpu', 'row')} }")
    log(f"[elastic] the arms on the CPU in {cpu_s:.1f} s, meanwhile "
        f"the card's ranks: the arms and the bit run in {card_s:.1f} s, "
        f"the spawn included")

    # (a) the arms against the CPU
    for arm, a in arms.items():
        row, cpu = a["row"], a["cpu"]
        same = {k: row[k] for k in ELASTIC_SAME}
        if same != {k: cpu[k] for k in ELASTIC_SAME}:
            raise AssertionError(f"elastic {arm}: {same} differ from the "
                                 f"CPU run's {cpu}")
        if not all(math.isfinite(x) for x in row["run"]["losses"]):
            raise AssertionError(f"elastic {arm}: a loss is not finite")
    rs = arms["reshape"]["row"]
    if (rs["wipeouts"] != 0 or rs["dp_final"] != 2
            or (rs["policy"]["dp_full"], rs["policy"]["dp_new"]) != (4, 2)
            or sorted({tuple(k[:2]) for k in rs["run"]["cache_keys"]})
            != [(2, 1), (4, 1)]
            or not rs["ttt_s"] < cpus["restart"]["ttt_s"]):
        raise AssertionError(f"elastic reshape arm: {rs}")
    # (b) bit-transparency
    _elastic_bit_gates(bits)
    # (c) the kernels on every rank that ran steps: K3a and K3b once per
    # bucket and stage, per step the rank ran
    nb = bits[0]["n_buckets"]
    by_path: dict = {}
    for cell in cells:
        row = arms[cell["arm"]]["row"]
        for p, r in enumerate(row["run"]["per_rank"]):
            ran = row["steps_done"]
            if cell["arm"] == "reshape" and p in cell["victims"]:
                ran = cell["fail_step"]
            want = 2 * nb * ran
            k = r["launches"]
            if k["int8_ef_absmax"] != want or k["int8_ef_quantize"] != want \
                    or not all(k[x] > 0 for x in (
                        "rmsnorm", "rmsnorm_bwd", "flash_attention",
                        "flash_attention_bwd")):
                raise AssertionError(f"elastic {cell['arm']} rank {p}: "
                                     f"launches {k}, K3 want {want}")
            for name, v in k.items():
                by_path[name] = by_path.get(name, 0) + v

    out = {"depth": cfg.n_layers, "reading": reading, "backend": backend,
           "config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                      "padded_vocab": cfg.padded_vocab, **ELASTIC},
           "arms": arms, "cpu_seconds": cpu_s, "card_seconds": card_s,
           "launches": by_path, "n_buckets": nb,
           "bits": _elastic_bits_summary(bits), "tp_records": tp_records,
           "tp_cpu": tp_cpu}
    b = out["bits"]
    log(f"[elastic] (b) in {b['seconds']:.1f} s: {b['dp4']} at DP 4, "
        f"{b['dp2']} at DP 2, reshape {b['reshape']}, restore "
        f"{b['restore']}, rollback {b['rollback']}, peak {b['peak_gib']} "
        f"GiB, RSS {b['rss_gib']} GiB")
    return out


# ------------------------------------------------------------------ #
# tensor and expert parallelism on a (data 2, model 2) grid (phase 19)#
# ------------------------------------------------------------------ #
#: the tp phase: four ranks sharing the card, a grid of data 2 x model
#: 2; qwen2.5-3b at published width cut to ``depth`` layers; N 4, r 2;
#: group 0 killed at ``kill_poll`` (masked), a wipe-out at
#: ``wipe_poll`` rolled back to the snapshot of step ``snapshot_every``;
#: the CPU's arms at smoke size with ``cpu_seq``
TP = dict(n=4, model_degree=2, depth=2, n_groups=4, r=2, seq=256,
          per_type_batch=1, steps=5, kill_poll=2, wipe_poll=4,
          snapshot_every=3, bucket_mb=32.0, seed=0, cpu_seq=32,
          mem_limit_gib=75.0)
#: (name, sync, grad_compress) of the two arms
TP_ARMS = (("shard_map+int8_ef", "shard_map", "int8_ef"),
           ("gspmd", "gspmd", None))
#: the first step's whole gradient against a one-rank executor's (fp32
#: buckets): the fp32 arm within the JAX package's mesh-vs-host
#: tolerance (tests/test_exec.py: bf16 activations and fp32 sums in
#: another grouping), the int8 arm within the §3.1 sweep's oracle at
#: data degree 2 (one step of the quantised sync)
TP_GRAD_TOL = 5e-3
#: the replayed step's loss against its first execution at another
#: ``S_A`` (the same logical batch): fp32 summation order, relative
TP_REPLAY_TOL = 1e-5
#: the report fields an arm shares with the same script on four CPU
#: ranks at smoke size
TP_SAME = ("failures", "wipeouts", "steps_done", "rollback_steps",
           "s_a_by_step", "events")
#: the expert-parallel checks: deepseek-v2-lite-16b's MoE layer at
#: published width on a model group of two ranks against the same body
#: on one rank; then its first two blocks (dense, MoE) as a model
#: tolerances, of the largest |one-rank| element of each tensor: fp32
#: summation order; in bf16 the two ranks' partial outputs are each
#: rounded before their sum, a few ulps of the largest; the model (fp32,
#: two blocks) carries the layer's order through the backward
EP = dict(arch="deepseek-v2-lite-16b", tokens=(128, 8), seed=0,
          model_tokens=(1, 128), tol={"float32": 1e-5,
                                      "bfloat16": 2.0 ** -5},
          model_tol=1e-4)


#: (c) the elastic tier on the tp phase's grid (data 2 x model 2). The
#: cell is the JAX package's ``elastic_regime_cells(**cell)``, its
#: ``arm`` (group 0 killed at step 8, unmaskable at r 1: the policy
#: reshapes DP 2 -> 1 onto row 1's two ranks), under ``shard_map`` with
#: the int8 EF sync; N 2, r 1, because six or eight ranks at full width
#: do not fit the host and r 2 needs N >= 3. The bit run, in both syncs:
#: ``bit_steps`` steps, ``reshape(victims)``, ``degraded_steps`` at DP 1
#: (a snapshot at their start), ``restore_full_mesh``, the rollback
TP_ELASTIC = dict(cell=dict(n=2, r=1, model_degree=2, steps=12),
                  arm="mask", n_groups=2, r=1, per_type_batch=2, seq=256,
                  bucket_mb=32.0, bit_steps=2, degraded_steps=2,
                  victims=(0,), syncs=("shard_map", "gspmd"))


def tp_elastic_cell(trace_dir: str | None = None) -> dict:
    """(c)'s campaign cell (``TP_ELASTIC``)."""
    from repro_torch.scenarios.campaign import elastic_regime_cells

    return next(c for c in elastic_regime_cells(**TP_ELASTIC["cell"],
                                                trace_dir=trace_dir)
                if c["arm"] == TP_ELASTIC["arm"])


def tp_elastic_bits_rank(rank: int, world: int, cfg, sync: str,
                         device: str) -> dict:
    """(c)'s bit run under ``sync`` on this rank, with a deep telemetry:
    the state's checksums (params and moments: the rank's replicas or
    blocks; the EF residuals, ``err2`` also by halves) after
    ``bit_steps`` steps, after the reshape, and after the restore and the
    rollback; the wall seconds of the reshape, the restore and the
    rollback, what the spans show (:func:`_bit_spans`), and the launches
    counted from 0 just before the run."""
    import torch

    from repro_torch.dist import tree_leaves
    from repro_torch.elastic import ElasticMeshExecutor
    from repro_torch.kernels import ops
    from repro_torch.obs import Telemetry
    from repro_torch.scenarios.campaign import rss_gib

    te = TP_ELASTIC
    on_card = torch.device(device).type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    tel = Telemetry(deep=True)
    ex = ElasticMeshExecutor(
        cfg, n_groups=te["n_groups"], redundancy=te["r"],
        model_degree=TP["model_degree"], sync=sync,
        grad_compress="int8_ef" if sync == "shard_map" else None,
        seq=te["seq"], per_type_batch=te["per_type_batch"], total_steps=24,
        bucket_mb=te["bucket_mb"], telemetry=tel, device=device)
    rec: dict = {"rank": rank, "row": rank // TP["model_degree"],
                 "sync": sync, "n_buckets": ex._layout.n_buckets}

    def sums() -> dict:
        out = {"state": checksums(tree_leaves(ex.params)
                                  + tree_leaves(ex.opt_state.mu)
                                  + tree_leaves(ex.opt_state.nu)),
               "opt_step": int(ex.opt_state.step)}
        if ex._ef_state is not None:
            out.update(
                err1=checksums(list(ex._ef_state["err1"])),
                err1_zero=all(not bool(e.any())
                              for e in ex._ef_state["err1"]),
                err2=[checksums(list(e.view(2, -1))) + checksums([e])
                      for e in ex._ef_state["err2"]])
        return out

    def wall(name: str, fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        rec[name] = time.perf_counter() - t0
        return out

    ops.reset_launches()
    ex.run(te["bit_steps"])
    rec["before"] = sums()
    wall("reshape_s", lambda: ex.reshape(list(te["victims"])))
    rec["after_reshape"] = sums()
    ex.run(te["degraded_steps"])
    rec["ran"] = te["bit_steps"] + (te["degraded_steps"]
                                    if ex.rank is not None else 0)
    wall("restore_s", ex.restore_full_mesh)
    rec["rollback_step"] = wall("rollback_s", ex._rollback)[0]
    rec["after_rollback"] = sums()
    rec["launches"] = dict(ops.launches)
    rec["cache_keys"] = [list(k) for k in ex.cache_keys]
    if on_card:
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
    rec["rss_gib"] = rss_gib()
    ex.close()
    del ex
    gc.collect()
    rec.update(_bit_spans(tel, te["bit_steps"], dps=(2, 1)))
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def tp_elastic_rank(rank: int, world: int, cfg, device: str) -> dict:
    """(c) on this rank: the cell (each rank as ``run_elastic_cells`` runs
    it), then the bit run in each sync."""
    import torch

    from repro_torch.scenarios.campaign import elastic_cells_on_ranks

    t0 = time.perf_counter()
    row = elastic_cells_on_ranks(rank, world, [tp_elastic_cell()], cfg,
                                 device)[0]
    cell_s = time.perf_counter() - t0
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    bits = {sync: tp_elastic_bits_rank(rank, world, cfg, sync, device)
            for sync in TP_ELASTIC["syncs"]}
    return {"cell": row, "cell_s": cell_s, "bits": bits}


def _tp_elastic_gates(records: list, cpu_row: dict, L: int) -> dict:
    """(c)'s gates (the module doc, phase 19) over every card rank's
    record; returns the readings and the launches by path."""
    import math

    te, m_deg = TP_ELASTIC, TP["model_degree"]
    cell = tp_elastic_cell()
    row = records[0]["elastic"]["cell"]
    same = {k: row[k] for k in ELASTIC_SAME}
    if same != {k: cpu_row[k] for k in ELASTIC_SAME}:
        raise AssertionError(f"tp elastic cell: {same} differ from the "
                             f"CPU run's {cpu_row}")
    if not all(math.isfinite(x) for x in row["run"]["losses"]):
        raise AssertionError("tp elastic cell: a loss is not finite")
    keys = sorted({tuple(k[:2]) for k in row["run"]["cache_keys"]})
    if keys != [(1, m_deg), (2, m_deg)] or row["reshapes"] != 1 or \
            row["dp_final"] != 1 or row["wipeouts"] != 0:
        raise AssertionError(f"tp elastic cell: {row}")
    bits = {sync: [r["elastic"]["bits"][sync] for r in records]
            for sync in te["syncs"]}
    nb = bits["shard_map"][0]["n_buckets"]
    want_k = {"rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1,
              "flash_attention": 2 * L, "flash_attention_bwd": L}
    by_path = {"tp_elastic_int8": {}, "tp_elastic_gspmd": {}}

    def add(path, counts):
        for k, v in counts.items():
            by_path[path][k] = by_path[path].get(k, 0) + v

    # the cell's kernels: each rank's exact counts for the steps its row
    # ran (r 1: one microbatch a step)
    for p, r in enumerate(row["run"]["per_rank"]):
        ran = cell["fail_step"] if p // m_deg in cell["victims"] \
            else row["steps_done"]
        want = dict.fromkeys(r["launches"], 0)
        want.update({k: v * ran for k, v in want_k.items()})
        want.update(int8_ef_absmax=2 * nb * ran, int8_ef_quantize=2 * nb * ran)
        if r["launches"] != want:
            raise AssertionError(f"tp elastic cell rank {p}: launches "
                                 f"{r['launches']} != {want}")
        add("tp_elastic_int8", r["launches"])
    for sync, ranks in bits.items():
        int8 = sync == "shard_map"
        col = lambda r: r["rank"] % m_deg          # noqa: E731
        at = {(r["row"], col(r)): r for r in ranks}
        for r in ranks:
            # the survivors' state untouched by the reshape; err1 kept
            if r["row"] == 1 and (
                    r["after_reshape"]["state"] != r["before"]["state"] or
                    (int8 and r["after_reshape"]["err1"]
                     != r["before"]["err1"])):
                raise AssertionError(f"tp elastic {sync} rank {r['rank']}: "
                                     f"the state moved in the reshape")
            if int8 and r["row"] == 1:
                # err2 re-sliced: the whole array is the old chunks of
                # rows 0 and 1 of the rank's column, in order
                for b, halves in enumerate(r["after_reshape"]["err2"]):
                    want = [at[(d, col(r))]["before"]["err2"][b][2]
                            for d in (0, 1)]
                    if halves[:2] != want:
                        raise AssertionError(
                            f"tp elastic rank {r['rank']}: err2[{b}] is not "
                            f"the re-sliced gather")
            # after the restore and the rollback: the column's snapshot
            # of row 1 (active when it was taken)
            snap = at[(1, col(r))]["after_reshape"]
            got = r["after_rollback"]
            if got["state"] != snap["state"] or \
                    got["opt_step"] != snap["opt_step"]:
                raise AssertionError(f"tp elastic {sync} rank {r['rank']}: "
                                     f"after the rollback not its column's "
                                     f"snapshot")
            if int8:
                if r["row"] == 0 and not got["err1_zero"]:
                    raise AssertionError(f"tp elastic rank {r['rank']}: "
                                         f"rejoining err1 not zero")
                if r["row"] == 1 and got["err1"] != snap["err1"]:
                    raise AssertionError(f"tp elastic rank {r['rank']}: "
                                         f"err1 not its snapshot's")
                if [h[2] for h in got["err2"]] != \
                        [h[r["row"]] for h in snap["err2"]]:
                    raise AssertionError(f"tp elastic rank {r['rank']}: "
                                         f"err2 not the re-sliced snapshot")
            want = dict.fromkeys(r["launches"], 0)
            want.update({k: v * r["ran"] for k, v in want_k.items()})
            k3 = 2 * nb * r["ran"] if int8 else 0
            want.update(int8_ef_absmax=k3, int8_ef_quantize=k3)
            if r["launches"] != want:
                raise AssertionError(f"tp elastic {sync} rank {r['rank']}: "
                                     f"launches {r['launches']} != {want}")
            add("tp_elastic_int8" if int8 else "tp_elastic_gspmd",
                r["launches"])
        # a row's two ranks: replicas under shard_map, blocks under gspmd
        for d in range(2):
            for key in ("before", "after_reshape", "after_rollback"):
                a, b = at[(d, 0)][key]["state"], at[(d, 1)][key]["state"]
                if int8 and a != b:
                    raise AssertionError(f"tp elastic row {d}: replicas "
                                         f"differ {key}")
                if not int8 and a == b:
                    raise AssertionError(f"tp elastic row {d}: the same "
                                         f"blocks {key}")
    readings = {"cell": {k: row[k] for k in ELASTIC_SAME},
                "cell_s": max(r["elastic"]["cell_s"] for r in records),
                "cell_peak_gib": [r["peak_gib"]
                                  for r in row["run"]["per_rank"]],
                "cell_rss_gib": [r["rss_gib"]
                                 for r in row["run"]["per_rank"]]}
    for sync, ranks in bits.items():
        out = {}
        for dp in (2, 1):
            steps = [st for r in ranks for st in r["steps"]
                     if st["dp"] == dp and st["synced"]]
            out[f"dp{dp}"] = {
                "step_s": _median([st["seconds"] for st in steps]),
                "sync_share": _median([st["sync_s"] / st["seconds"]
                                       for st in steps]), "n": len(steps)}
        lead = next(r for r in ranks if r["rank"] == m_deg)   # row 1, m 0
        for what in ("reshape", "restore", "rollback"):
            out[what] = {"wall_s": lead[f"{what}_s"],
                         **lead["parts"].get(what, {})}
        out["peak_gib"] = [r.get("peak_gib") for r in ranks]
        out["rss_gib"] = [r["rss_gib"] for r in ranks]
        out["seconds"] = max(r["seconds"] for r in ranks)
        readings[sync] = out
    return {"readings": readings, "launches": by_path}


def tp_microbatches() -> list[tuple[int, int]]:
    """The ``(examples, seq)`` of a tp rank's microbatch: N x per-type
    batch / data degree rows of seq tokens."""
    data = TP["n"] // TP["model_degree"]
    return [(TP["n_groups"] * TP["per_type_batch"] // data, TP["seq"])]


def tp_kernel_checks(cfg) -> list[dict]:
    """K1 and K1-bwd at the rows the EP model check gives them
    (deepseek-v2-lite's d_model and its kv_norm's 512, at
    ``EP["model_tokens"]``), and K2 and K2-bwd in bf16 at what the FSDP x
    TP step (d) gives them (:func:`fsdp_tp_kernel_checks`), with the
    kernel phase's tolerances. The tp training microbatch (K1, K1-bwd,
    K2, K2-bwd) and its K3 buckets are in the kernel phase's main shapes.
    None of these is a main shape."""
    from repro_torch.configs import get_config

    ds = get_config(EP["arch"])
    tokens = EP["model_tokens"][0] * EP["model_tokens"][1]
    rows = [(tokens, ds.d_model), (tokens, ds.kv_lora_rank)]
    out = [check_rmsnorm(ds, rows), check_rmsnorm_bwd(ds, rows)]
    for k in out:
        for sh in k["shapes"]:
            sh["main"] = False
            sh["path"] = "tp"
    return merge_checks(out, fsdp_tp_kernel_checks(cfg))


def fsdp_tp_kernel_checks(cfg) -> list[dict]:
    """K2 and K2-bwd (bf16) on a model rank's heads of the FSDP x TP
    step (d): ``tp_heads`` at ``FSDP_TP["grid"]``'s model degree
    (qwen2.5-3b at model 2: 8 query heads and 1 KV head of 128) at a data
    rank's batch (``FSDP_TP["batch"]`` / data degree examples of
    ``FSDP_TP["seq"]``)."""
    import torch

    from repro_torch.models.attention import tp_heads

    grid = FSDP_TP["grid"]
    hl, _, kvl, _ = tp_heads(cfg, 0, grid["model"])
    lcfg = cfg.scaled(n_heads=hl, n_kv_heads=kvl,
                      head_dim=cfg.resolved_head_dim)
    b, s = FSDP_TP["batch"] // grid["data"], FSDP_TP["seq"]
    out = [check_flash(lcfg, [(b, s, torch.bfloat16)]),
           check_flash_bwd(lcfg, [(b, s)], dtypes=("bfloat16",))]
    for k in out:
        for sh in k["shapes"]:
            sh["main"] = False
            sh["path"] = "fsdp_tp"
    return out


def tp_k3_sizes(cfg) -> list[int]:
    """K3's sizes on the tp phase's int8 arm: the largest bucket of its
    layout (padded to the data degree) and that bucket's stage-2 half."""
    data = TP["n"] // TP["model_degree"]
    top = max(train_layout(cfg.scaled(n_layers=TP["depth"]), pad_to=data,
                           settings=TP).bucket_sizes)
    return [top, top // data]


def tp_alone_checks(cfg) -> list[dict]:
    """For ``--phase tp``: the tp path's main shapes, which a whole run
    checks in the kernel phase (K1 and K1-bwd at a rank's microbatch
    rows, K2 and K2-bwd at its microbatch, K3 at
    :func:`tp_k3_sizes`), and :func:`tp_kernel_checks`."""
    import torch

    micro = tp_microbatches()
    rows = [(b * s, cfg.d_model) for b, s in micro]
    out = [check_rmsnorm(cfg, rows), check_rmsnorm_bwd(cfg, rows),
           check_flash(cfg, [(b, s, torch.bfloat16) for b, s in micro]),
           check_flash_bwd(cfg, micro, dtypes=("bfloat16",)),
           *check_int8_ef(int8_ef_cases(tp_k3_sizes(cfg)))]
    return merge_checks(out, tp_kernel_checks(cfg))


def tp_block_bytes(cfg, model_degree: int) -> dict:
    """What a rank stores under each arm at ``cfg``, from storage-free
    leaves and the executor's ``gspmd`` rule: the params (bf16, fp32
    norms and biases) and fp32 moments, whole (``shard_map``) or this
    rank's blocks (``gspmd``: the sharded leaves' columns / degree); and
    the whole params alone (``params``: what a ``gspmd`` rank gathers)."""
    import torch

    from repro_torch.dist import tree_leaves
    from repro_torch.exec import executor_param_specs
    from repro_torch.models.model import Model

    params = Model(cfg, torch.device("meta")).init(0)
    specs = executor_param_specs(params, model_degree)
    flags = tree_leaves(_spec_flags(params, specs))
    whole = block = gathered = 0
    for t, f in zip(tree_leaves(params), flags):
        n = t.numel()
        whole += n * (t.element_size() + 8)
        block += (n // model_degree if f else n) * (t.element_size() + 8)
        gathered += n * t.element_size()
    return {"shard_map": whole, "gspmd": block, "params": gathered}


def _spec_flags(params, specs):
    """A tree like ``params`` of whether each leaf's spec shards it."""
    if isinstance(params, dict):
        return {k: _spec_flags(params[k], specs[k]) for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(_spec_flags(p, s) for p, s in zip(params, specs))
    return bool(specs)


def _tp_instrument(ex, rec: dict, tag: str) -> None:
    """Per executed step: its ``S_A``, loss, host seconds and the seconds
    of the sync (the data group's buckets and, under ``gspmd``, the
    model group's gathers; gloo's collectives hold the host, and each
    part is closed by a synchronise); state checksums after every step,
    at the snapshot and after the rollback."""
    import torch

    from repro_torch.dist import tree_leaves

    def state() -> list:
        ts = (tree_leaves(ex.params) + tree_leaves(ex.opt_state.mu)
              + tree_leaves(ex.opt_state.nu))
        if ex._ef_state is not None:
            ts += list(ex._ef_state["err1"]) + list(ex._ef_state["err2"])
        return ts

    sync_s = []

    def timed(fn):
        def run(*a, **kw):
            if ex.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if ex.device.type == "cuda":
                torch.cuda.synchronize()
            sync_s.append(time.perf_counter() - t0)
            return out
        return run

    ex._grad_sync._sync_all = timed(ex._grad_sync._sync_all)
    if ex._gather is not None:
        ex._gather_into = _gather_into_timed(ex, timed)
    dispatch, snap, roll = ex._dispatch, ex._snapshot_now, ex._rollback

    def timed_dispatch(report):
        sync_s.clear()
        if ex.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, s_a = ex.step, ex.state.s_a
        out = dispatch(report)
        loss = float(out[2]["loss"])
        secs = time.perf_counter() - t0
        rec["steps"].append({"step": step, "s_a": s_a, "loss": loss,
                             "seconds": secs, "sync_s": sum(sync_s),
                             "checksums": checksums(state())})
        if ex.rank == 0 and ex.model_rank == 0:
            log(f"[{tag}] step {step} S_A={s_a}: loss {loss:.6f}, "
                f"{secs:.3f} s, sync {sum(sync_s):.3f} s")
        return out

    def checked_snapshot():
        t0 = time.perf_counter()
        snap()
        rec["snapshots"].append({"step": ex.step,
                                 "seconds": time.perf_counter() - t0,
                                 "checksums": checksums(state())})

    def checked_rollback():
        if ex.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = roll()
        if ex.device.type == "cuda":
            torch.cuda.synchronize()
        rec["rollbacks"].append({"step": out[0],
                                 "seconds": time.perf_counter() - t0,
                                 "checksums": checksums(state())})
        return out

    ex._dispatch, ex._snapshot_now = timed_dispatch, checked_snapshot
    ex._rollback = checked_rollback


def _gather_into_timed(ex, timed):
    """``ex._gather_into`` with the gather it calls timed (the bound
    ``BucketedAllGather.__call__`` is looked up on the class)."""
    from repro_torch.dist import tree_leaves

    gather = timed(ex._gather)

    def run(blocks, fulls):
        gather([t for t, f in zip(tree_leaves(blocks), ex._flags) if f],
               [t for t, f in zip(tree_leaves(fulls), ex._flags) if f])
    return run


def tp_arm_rank(rank: int, world: int, cfg, arm: tuple, device: str,
                seq: int, one, ref: dict) -> dict:
    """One tp arm on this rank (the default group is the whole grid):
    the executor at model degree 2, the first step's whole gradient
    against a one-rank executor's on rank 0 (over ``one``, a one-rank
    group), then the scripted run. Returns this rank's record. ``ref``
    keeps rank 0's reference gradient for the next arm, which starts
    from the same parameters (checked by checksum; otherwise it is
    computed again)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import tree_leaves
    from repro_torch.exec import MeshExecutor, tree_max_rel_err
    from repro_torch.kernels import ops
    from repro_torch.scenarios.campaign import rss_gib
    from repro_torch.train import ScriptedInjector

    name, sync, compress = arm
    on_card = torch.device(device).type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kw = dict(n_groups=TP["n_groups"], redundancy=TP["r"], seq=seq,
              per_type_batch=TP["per_type_batch"], seed=TP["seed"],
              bucket_mb=TP["bucket_mb"], total_steps=TP["steps"],
              device=device)
    t0 = time.perf_counter()
    ex = MeshExecutor(cfg, model_degree=TP["model_degree"], sync=sync,
                      grad_compress=compress, **kw)
    rec: dict = {"rank": rank, "arm": name, "steps": [], "snapshots": [],
                 "rollbacks": [], "init_s": time.perf_counter() - t0,
                 "n_buckets": ex._layout.n_buckets,
                 "stored_bytes": sum(
                     t.numel() * t.element_size() for t in
                     tree_leaves(ex.params) + tree_leaves(ex.opt_state.mu)
                     + tree_leaves(ex.opt_state.nu))}
    # the first step's whole gradient against a one-rank executor's with
    # fp32 buckets (rank 0)
    t0 = time.perf_counter()
    grads = ex.mesh_grads(0)
    full = ex.params if ex._gather is None else ex._gather_params(ex.params)
    if rank == 0:
        sums = checksums(tree_leaves(full))
        if ref.get("params") != sums:
            one_rank = MeshExecutor(cfg, group=one, **kw)
            one_rank.place_state(full)
            ref.update(params=sums, grads=one_rank.mesh_grads(0))
            one_rank.close()
            del one_rank
        rec["grad_rel_err"] = tree_max_rel_err(grads, ref["grads"])
    del grads, full
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()
    rec["grad_check_s"] = time.perf_counter() - t0
    script, _ = train_script(TP["n_groups"], TP["r"], TP)
    _tp_instrument(ex, rec, f"tp {name}")
    ops.reset_launches()
    t0 = time.perf_counter()
    rep = ex.run(TP["steps"], injector=ScriptedInjector(script),
                 snapshot_every=TP["snapshot_every"])
    if on_card:
        torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = dict(ops.launches)
    if rank == 0:
        log(f"[tp {name}] set up {rec['init_s']:.1f} s, gradient check "
            f"{rec['grad_check_s']:.1f} s, run {rec['wall_s']:.1f} s "
            f"(snapshots {sum(x['seconds'] for x in rec['snapshots']):.1f}"
            f" s, rollback {rec['rollbacks'][0]['seconds']:.1f} s)")
    rec["report"] = {
        "failures": rep.failures, "wipeouts": rep.wipeouts,
        "steps_done": rep.steps_done, "rollback_steps": rep.rollback_steps,
        "s_a_by_step": [s["s_a"] for s in rec["steps"]],
        "events": [(e.step, [int(v) for v in e.victims], bool(e.wipeout),
                    e.s_a_after, e.rollback_depth) for e in rep.events]}
    rec["script"] = {str(k): v for k, v in script.items()}
    if on_card:
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
    rec["rss_gib"] = rss_gib()
    ex.close()
    del ex
    gc.collect()
    return rec


def ep_rank(rank: int, world: int, device: str = "cuda",
            cfg=None) -> dict | None:
    """(b) on this rank: deepseek-v2-lite's MoE layer at published width
    on the model group of ranks 0 and 1 (32 experts each, the rank's
    part held alone), at each of ``EP["tokens"]`` in bf16 and fp32,
    forward and backward, against the expert-parallel body on a group
    of one rank (all 64 experts, the same capacity); then the first two
    blocks as a model built on the group against the same model on the
    one-rank group. Ranks 2 and 3 take part in the groups' creation
    only. Returns this rank's record (None on ranks 2 and 3). ``device``
    and ``cfg`` (the MoE config, by default ``EP["arch"]``'s) let the
    same checks rehearse on CPU ranks at a small width."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_mesh_groups
    from repro_torch.models import cast_params
    from repro_torch.models.model import _init_moe
    from repro_torch.models.moe import (_dispatch, ep_capacity, ep_shard,
                                        moe_ffn, route_topk)

    grid = init_mesh_groups(dist.group.WORLD, TP["model_degree"])
    singles = [dist.new_group([r]) for r in range(world)]
    if grid.data_rank != 0:
        return None
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t_start = time.perf_counter()
    cfg = get_config(EP["arch"]) if cfg is None else cfg
    m, ep = grid.model_rank, grid.model_degree
    e_local = cfg.moe.n_experts // ep
    gen = torch.Generator(device=device).manual_seed(EP["seed"])
    whole = _init_moe(gen, cfg, torch.device(device))
    rec: dict = {"rank": rank, "cases": []}
    for dtype in ("bfloat16", "float32"):
        # bf16 as drawn (the router fp32), or every leaf fp32
        p_whole = whole if dtype == "bfloat16" else \
            cast_params(whole, dtype=torch.float32)
        # this rank's part alone: its routed experts' and its slice of
        # the shared experts copied out, the router whole
        local = _own_part(p_whole, cfg, m, ep)
        rec[f"expert_bytes_{dtype}"] = sum(
            t.numel() * t.element_size()
            for t in tree_leaves(local["experts"]))
        for tokens in EP["tokens"]:
            g = torch.Generator(device=device).manual_seed(tokens)
            x0 = torch.randn((1, tokens, cfg.d_model), generator=g,
                             device=device).to(getattr(torch, dtype))
            cot = torch.randn(x0.shape, generator=g,
                              device=device).to(x0.dtype)
            out = {}
            for label, params, group in (("ep", local, grid.model_group),
                                         ("one", p_whole, singles[rank])):
                leaves = tree_leaves(params)
                for t in leaves:
                    t.requires_grad_()
                # a first call, then the timed one whose values count
                for _ in range(2):
                    for t in leaves:
                        t.grad = None
                    x = x0.clone().requires_grad_()
                    sync()
                    t0 = time.perf_counter()
                    y = moe_ffn(x, params, cfg, group=group)
                    (y.float() * cot.float()).sum().backward()
                    sync()
                out[label] = {"ms": (time.perf_counter() - t0) * 1e3,
                              "y": y.detach(), "dx": x.grad,
                              "grads": {k: [t.grad for t in
                                            tree_leaves(params[k])]
                                        for k in params}}
                for t in leaves:
                    t.requires_grad_(False)
            # the one-rank body's gradients of this rank's part
            mine = ep_shard({k: _unflat(p_whole[k], v)
                             for k, v in out["one"]["grads"].items()},
                            cfg, m, ep)
            errs = {"y": _rel_to_largest(out["ep"]["y"], out["one"]["y"]),
                    "dx": _rel_to_largest(out["ep"]["dx"],
                                          out["one"]["dx"])}
            for k, got in out["ep"]["grads"].items():
                want = tree_leaves(mine[k])
                errs[f"d{k}"] = max(_rel_to_largest(a, b)
                                    for a, b in zip(got, want))
            xf = x0.reshape(-1, cfg.d_model)
            idx, _ = route_topk(xf, p_whole["router"], cfg.moe.top_k)
            cap = ep_capacity(cfg, xf.shape[0])
            drops = 0
            for r in range(ep):
                _, keep = _dispatch(idx, r * e_local, e_local, cap)
                here = (idx >= r * e_local) & (idx < (r + 1) * e_local)
                drops += int((here.reshape(-1) & ~keep).sum())
            case = {"dtype": dtype, "tokens": tokens, "capacity": cap,
                    "slots": tokens * cfg.moe.top_k, "dropped": drops,
                    "errors": errs, "ep_ms": out["ep"]["ms"],
                    "one_ms": out["one"]["ms"]}
            rec["cases"].append(case)
            if rank == 0:
                log(f"[tp] EP {dtype} at {tokens} tokens: capacity {cap}, "
                    f"{drops} of {case['slots']} slots dropped; errors "
                    f"{ {k: f'{v:.3g}' for k, v in errs.items()} }; "
                    f"{out['ep']['ms']:.2f} ms on 2 ranks, "
                    f"{out['one']['ms']:.2f} on one (forward and backward, "
                    f"a second call)")
            del out
        del p_whole, local
        gc.collect()
    del whole
    layer_launches = dict(ops.launches)
    ops.reset_launches()
    rec["model"] = _ep_model(rank, grid, singles[rank], cfg, device)
    rec["model"]["launches"] = dict(ops.launches)
    rec["layer_launches"] = layer_launches
    if on_card:
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_start
    if rank == 0:
        log(f"[tp] EP checks in {rec['seconds']:.1f} s")
    return rec


def _own_part(p: dict, cfg, rank: int, size: int) -> dict:
    """Rank ``rank``'s part of a MoE layer ``p`` (``ep_shard``'s blocks)
    as tensors of its own."""
    from repro_torch.models.moe import ep_shard

    return {k: (v.clone() if k == "router" else
                {n: t.clone() for n, t in v.items()})
            for k, v in ep_shard(p, cfg, rank, size).items()}


def _unflat(like, leaves):
    """``leaves`` in ``like``'s tree (a dict of tensors, or one)."""
    if isinstance(like, dict):
        from repro_torch.dist import tree_leaves
        keys = sorted(like)
        assert len(keys) == len(leaves) == len(tree_leaves(like))
        return dict(zip(keys, leaves))
    return leaves[0]


def _rel_to_largest(got, want) -> float:
    """``max |got - want| / max |want|`` in fp64."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def _ep_model(rank: int, grid, single, cfg, device: str) -> dict:
    """(b)'s model check: deepseek-v2-lite's first two blocks (dense,
    MoE), drawn from seed 0 and cast to fp32, built on the model group
    (the rank's expert blocks held alone) and on the one-rank group (all
    experts): the loss of ``EP["model_tokens"]`` and every gradient, the
    expert leaves' against the one-rank gradient's blocks."""
    import torch

    from repro_torch.dist import tree_leaves
    from repro_torch.models import build_model, cast_params
    from repro_torch.models.moe import ep_shard

    cfg = cfg.scaled(n_layers=2)
    m, ep = grid.model_rank, grid.model_degree
    whole = cast_params(build_model(cfg, device=device).init(EP["seed"]),
                        dtype=torch.float32)
    seg = whole["segments"][1][0]
    local_moe = _own_part(seg["moe"], cfg, m, ep)
    local = {**whole, "segments": [whole["segments"][0],
                                   ({**seg, "moe": local_moe},)]}
    g = torch.Generator(device=device).manual_seed(EP["seed"])
    b, s = EP["model_tokens"]
    tokens = torch.randint(0, cfg.vocab, (b, s + 1), generator=g,
                           device=device)
    out = {}
    for label, params, group in (("ep", local, grid.model_group),
                                 ("one", whole, single)):
        model = build_model(cfg, device=device, model_group=group)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_()
            t.grad = None
        logits = model.forward(params, tokens=tokens[:, :-1]).float()
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
        loss.backward()
        out[label] = {"loss": float(loss.detach()),
                      "grads": [t.grad for t in leaves]}
        for t in leaves:
            t.requires_grad_(False)
    # the one-rank gradients in the model group's layout: the expert
    # leaves cut to this rank's blocks
    grads_one = _tree_like(whole, out["one"]["grads"])
    seg_g = grads_one["segments"][1][0]
    cut = ep_shard(seg_g["moe"], cfg, m, ep)
    grads_one["segments"][1] = ({**seg_g, "moe": cut},)
    want = tree_leaves(grads_one)
    err = max(_rel_to_largest(a, b) for a, b in
              zip(out["ep"]["grads"], want))
    rec = {"loss_ep": out["ep"]["loss"], "loss_one": out["one"]["loss"],
           "grad_rel_err": err, "n_params": sum(
               t.numel() for t in tree_leaves(whole)),
           "expert_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(local_moe["experts"]))}
    if rank == 0:
        log(f"[tp] EP model ({cfg.name}, 2 blocks): loss {rec['loss_ep']:.6f}"
            f" on 2 ranks, {rec['loss_one']:.6f} on one; gradients within "
            f"{err:.3g} of each leaf's largest")
    return rec


def _tree_like(tree, leaves):
    """``leaves`` (in the JAX package's order) in ``tree``'s structure."""
    from repro_torch.dist.collectives import _flatten, _unflatten

    return _unflatten(_flatten(tree)[1], list(leaves))


#: (d) the FSDP x TP step on the tp phase's grid: ``batch`` examples of
#: ``seq`` tokens a step (``batch / 2`` a data rank), one microbatch.
#: Tolerances against the one-rank step, both in bf16. The split step
#: rounds each model rank's partial product to bf16 before the model
#: group sums it (g), and each data rank's gradient block to bf16 before
#: the reduce-scatter sums them, where the one-rank step rounds each
#: whole product once: roundings of the size bf16 already makes, so the
#: yardstick is the one-rank bf16 gradient's own distance from the same
#: step in fp32 (``e_one``, ``tree_max_rel_err``). The gradient gate:
#: the split's distance from the one-rank bf16 gradient within
#: ``grad_tol`` x ``e_one`` (each of the two is about ``e_one`` from the
#: fp32 one, so they may be twice that apart, and the split's extra
#: roundings add the third), and below 2^-4 of the largest element. The
#: losses (fp32 sums over bf16 logits): within 2^-8 relative, one bf16
#: unit roundoff
FSDP_TP = dict(steps=3, batch=4, seq=256, seed=0, grad_tol=3.0,
               grad_cap=2.0 ** -4, loss_tol=2.0 ** -8, peak_rel=0.10,
               peak_abs=256 << 20, grid={"data": 2, "model": 2},
               prod_peak_gib=75.0)


def fsdp_tp_shape():
    """(d)'s cell."""
    from repro_torch.configs import ShapeSpec

    return ShapeSpec("fsdp_tp", "train", FSDP_TP["seq"], FSDP_TP["batch"])


def fsdp_tp_batches() -> list[dict]:
    """(d)'s whole batches (numpy, seeded): tokens and labels int32 (1,
    B, S), the weights (1, B) of a healthy table (1/B each), a masked one
    (example 0 weighs 0 and its supplier, example 1, twice), a healthy
    one."""
    import numpy as np

    rng = np.random.default_rng(FSDP_TP["seed"])
    b, s = FSDP_TP["batch"], FSDP_TP["seq"]
    out = []
    for i in range(FSDP_TP["steps"]):
        seq = rng.integers(0, 151936, size=(1, b, s + 1)).astype(np.int32)
        w = np.full((1, b), 1.0 / b, np.float32)
        if i == 1:
            w[0, 0], w[0, 1] = 0.0, 2.0 / b
        out.append({"tokens": seq[..., :-1].copy(),
                    "labels": seq[..., 1:].copy(), "weights": w})
    return out


def fsdp_dry_runs(cfg) -> dict:
    """The dry runs (d) and (e) gate on, in a process of their own: (d)'s
    cell traced on each rank of the fake (2, 2) grid, and the production
    ``train_4k`` cell at full depth (``run_cell``)."""
    from repro_torch.launch.dryrun import record_cell, run_cell

    out: dict = {"ranks": []}
    n = FSDP_TP["grid"]["data"] * FSDP_TP["grid"]["model"]
    for r in range(n):
        t0 = time.perf_counter()
        cell, _ = record_cell(ARCH, "fsdp_tp", False, cfg=cfg,
                              axes=FSDP_TP["grid"], shape=fsdp_tp_shape(),
                              rank=r)
        out["ranks"].append({"arg_bytes": cell.arg_bytes,
                             "peak_bytes": cell.cost.peak_bytes,
                             "schedule": cell.log.schedule(),
                             "flops": cell.cost.flops,
                             "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    out["production"] = run_cell(ARCH, "train_4k", False)
    out["production_s"] = time.perf_counter() - t0
    return out


def start_fsdp_dry_runs(cfg):
    """:func:`fsdp_dry_runs` in a spawned process (no card, no process
    group): ``(future, pool)``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))
    return pool.submit(fsdp_dry_runs, cfg), pool


def fsdp_tp_rank(rank: int, world: int, cfg, device: str = "cuda") -> dict:
    """(d) on this rank (the default group is the whole grid): three
    steps, the first's gradient gathered whole between its halves (rank
    0: against a one-rank ``make_train_step``), the second recorded,
    with the memory and launch readings. Returns this rank's record."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import tree_leaves
    from repro_torch.dist.sharding import gather_tree, shard_tree
    from repro_torch.exec import tree_max_rel_err
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_mesh_groups
    from repro_torch.launch.steplog import record_step
    from repro_torch.models import build_model
    from repro_torch.models.model import Model, cast_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    t_start = time.perf_counter()
    grid = init_mesh_groups(dist.group.WORLD, FSDP_TP["grid"]["model"])
    d, coords, sizes = grid.data_rank, grid.coords(), grid.axis_sizes()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device, mesh=grid)
    gen = torch.Generator(device=device).manual_seed(FSDP_TP["seed"])
    blocks = shard_tree(Model(cfg, torch.device(device)).init(gen),
                        model.specs, coords, sizes)
    gc.collect()
    opt = adamw_init(blocks, moment_dtype=cfg.moment_dtype)
    bl = FSDP_TP["batch"] // grid.data_degree
    batches = [{k: torch.from_numpy(v[:, d * bl:(d + 1) * bl].copy()).to(
        device) for k, v in b.items()} for b in fsdp_tp_batches()]
    state = tree_leaves(blocks) + tree_leaves(opt.mu) + tree_leaves(opt.nu)
    rec: dict = {"rank": rank, "stored_bytes": sum(
        t.numel() * t.element_size() for t in
        state + list(batches[0].values())) + 4}
    step = make_train_step(model, grad_shardings=model.specs)
    # the first step in its two halves, its gradient gathered whole
    # between them (rank 0 keeps it on the host); the peak is read over
    # the steps from after the gather
    ops.reset_launches()
    t0 = time.perf_counter()
    loss, grads = step.grads(blocks, batches[0])
    whole = gather_tree(grads, model.specs, grid)
    whole = [t.to("cpu", copy=True) for t in tree_leaves(whole)] \
        if rank == 0 else None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocks, opt, m = step.update(blocks, opt, loss, grads)
    del grads
    losses, step_s = [float(m["loss"])], [time.perf_counter() - t0]
    for i, batch in enumerate(batches[1:]):
        t0 = time.perf_counter()
        if i == 0:
            (blocks, opt, m), log = record_step(
                step, (blocks, opt, batch), donated=state,
                returned=lambda r: tree_leaves(r[0]) + tree_leaves(r[1].mu)
                + tree_leaves(r[1].nu), watch=False)
            rec["schedule"] = log.schedule()
        else:
            blocks, opt, m = step(blocks, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    rec.update(launches=dict(ops.launches), losses=losses, step_s=step_s,
               peak_bytes=torch.cuda.max_memory_allocated() - base,
               base_bytes=base)
    del blocks, opt, state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        # the one-rank step on the whole batch, from the same draw
        t0 = time.perf_counter()
        one = build_model(cfg, device)
        gen = torch.Generator(device=device).manual_seed(FSDP_TP["seed"])
        params = one.init(gen)
        ref_opt = adamw_init(params, moment_dtype=cfg.moment_dtype)
        ref_step = make_train_step(one)
        full = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                for b in fsdp_tp_batches()]
        _, _, ref_grads = ref_step.accumulate(params, full[0])
        ref = [t.to("cpu", copy=True) for t in tree_leaves(ref_grads)]
        ref_losses = []
        for b in full:
            params, ref_opt, m = ref_step(params, ref_opt, b)
            ref_losses.append(float(m["loss"]))
        del params, ref_opt, ref_step, ref_grads
        gc.collect()
        torch.cuda.empty_cache()
        # the same first gradient in fp32: bf16's own distance from it
        gen = torch.Generator(device=device).manual_seed(FSDP_TP["seed"])
        params = cast_params(one.init(gen), dtype=torch.float32)
        _, _, f32 = make_train_step(one).accumulate(params, full[0])
        f32 = [t.to("cpu", copy=True) for t in tree_leaves(f32)]
        rec.update(grad_rel_err=tree_max_rel_err(whole, ref),
                   e_one=tree_max_rel_err(ref, f32),
                   e_split=tree_max_rel_err(whole, f32),
                   ref_losses=ref_losses, ref_s=time.perf_counter() - t0)
        del one, params, full, f32, ref, whole
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def fsdp_tp_gates(records: list, dry: dict) -> dict:
    """(d)'s and (e)'s gates on the ranks' records and the dry runs."""
    import math

    r0 = records[0]
    for r in records:
        losses = r["losses"]
        if not all(math.isfinite(x) for x in losses) or losses != \
                r0["losses"]:
            raise AssertionError(f"fsdp_tp rank {r['rank']}: losses "
                                 f"{losses} (rank 0 {r0['losses']})")
        want = dry["ranks"][r["rank"]]
        if r["stored_bytes"] != want["arg_bytes"]:
            raise AssertionError(f"fsdp_tp rank {r['rank']}: stores "
                                 f"{r['stored_bytes']} bytes, the dry run's "
                                 f"arg_bytes {want['arg_bytes']}")
        gap = r["peak_bytes"] - want["peak_bytes"]
        if abs(gap) > FSDP_TP["peak_rel"] * want["peak_bytes"] + \
                FSDP_TP["peak_abs"]:
            raise AssertionError(f"fsdp_tp rank {r['rank']}: peak "
                                 f"{r['peak_bytes']} bytes, the dry run's "
                                 f"{want['peak_bytes']} (gap {gap})")
        if r["schedule"] != want["schedule"]:
            raise AssertionError(f"fsdp_tp rank {r['rank']}: its collective "
                                 f"schedule ({len(r['schedule'])}) is not "
                                 f"the dry run's ({len(want['schedule'])})")
        if not all(r["launches"][k] > 0 for k in (
                "rmsnorm", "rmsnorm_bwd", "flash_attention",
                "flash_attention_bwd")):
            raise AssertionError(f"fsdp_tp rank {r['rank']}: launches "
                                 f"{r['launches']}")
    tol = min(FSDP_TP["grad_tol"] * r0["e_one"], FSDP_TP["grad_cap"])
    if not r0["grad_rel_err"] <= tol:
        raise AssertionError(f"fsdp_tp: the first gradient is "
                             f"{r0['grad_rel_err']:.3g} from the one-rank "
                             f"step's (tolerance {tol:.3g}; the one-rank "
                             f"bf16 gradient is {r0['e_one']:.3g} from "
                             f"fp32, the split's {r0['e_split']:.3g})")
    rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                               r0["ref_losses"])]
    if not max(rel) <= FSDP_TP["loss_tol"]:
        raise AssertionError(f"fsdp_tp: losses {r0['losses']} against the "
                             f"one-rank step's {r0['ref_losses']}")
    prod = dry["production"]
    if not prod["ok"] or not prod["peak_bytes"] < \
            FSDP_TP["prod_peak_gib"] * GIB:
        raise AssertionError(f"dryrun train_4k 16x16: {prod}")
    launches: dict = {}
    for r in records:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"loss_rel_err": rel, "launches": launches, "grad_tol": tol,
            "peak_gap_bytes": [r["peak_bytes"]
                               - dry["ranks"][r["rank"]]["peak_bytes"]
                               for r in records]}


def tp_card_rank(rank: int, world: int, cfg, device: str = "cuda",
                 seq: int = TP["seq"], ep_cfg=None) -> list | None:
    """Phase 19 on one of the card's four ranks: (a) the two arms, (b)
    EP, (c) the elastic tier on the grid, (d) the FSDP x TP step (on the
    card only); rank 0 returns every rank's records. ``device``, ``seq``
    and ``ep_cfg`` (:func:`ep_rank`'s ``cfg``) rehearse (a) to (c) on
    CPU ranks."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    # rank 0's one-rank group for the gradient reference: NCCL on the card
    one = dist.new_group([0], backend="nccl" if device == "cuda" else None)
    ref: dict = {}
    arms = [tp_arm_rank(rank, world, cfg, arm, device, seq, one, ref)
            for arm in TP_ARMS]
    del ref
    ep = ep_rank(rank, world, device, ep_cfg)
    gc.collect()
    elastic = tp_elastic_rank(rank, world, cfg, device)
    gc.collect()
    fsdp = fsdp_tp_rank(rank, world, cfg, device) if device == "cuda" \
        else None
    every = [None] * world
    dist.all_gather_object(every, {"arms": arms, "ep": ep,
                                   "elastic": elastic, "fsdp_tp": fsdp,
                                   "seconds": time.perf_counter() - t0})
    return every if rank == 0 else None


def tp_cpu_rank(rank: int, world: int, cfg) -> dict | None:
    """The two arms' script and (c)'s cell on four CPU ranks at smoke
    size: rank 0's reports and the cell's row."""
    import torch.distributed as dist

    from repro_torch.scenarios.campaign import elastic_cells_on_ranks

    one, ref = dist.new_group([0]), {}
    arms = [tp_arm_rank(rank, world, cfg, arm, "cpu", TP["cpu_seq"], one,
                        ref) for arm in TP_ARMS]
    row = elastic_cells_on_ranks(rank, world, [tp_elastic_cell()], cfg,
                                 "cpu")[0]
    if rank:
        return None
    return {"arms": {a["arm"]: a["report"] for a in arms},
            "elastic_cell": row}


def tp_cpu_run() -> dict:
    """:func:`tp_cpu_rank` on four spawned CPU ranks, with its
    seconds."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    out, _ = spawn_ranks(tp_cpu_rank, TP["n"], device="cpu",
                         args=(smoke_config(ARCH).scaled(grad_accum=1),))
    return {**out, "seconds": time.perf_counter() - t0}


def tp_fits(cfg) -> dict:
    """The reckoning at ``cfg``: a rank's stored state under each arm
    (:func:`tp_block_bytes`) plus the accumulator (fp32) and, on the int8
    arm, err1 and err2 (fp32, the gradient and its half); four ranks'
    state with their CUDA contexts against ``mem_limit_gib``; raises if
    over."""
    b = tp_block_bytes(cfg, TP["model_degree"])
    grad = 4 * sum(t.numel() for t in _meta_leaves(cfg))
    card = {"shard_map+int8_ef": b["shard_map"] + grad + grad + grad // 2,
            "gspmd": b["gspmd"] + grad + b["params"]}
    total = {k: TP["n"] * (v + ELASTIC["context_gib"] * GIB)
             for k, v in card.items()}
    log(f"[tp] depth {cfg.n_layers}: a rank stores "
        f"{b['shard_map'] / GIB:.2f} GiB of params and moments under "
        f"shard_map, {b['gspmd'] / GIB:.2f} under gspmd; four ranks with "
        f"the accumulator (and the EF residuals, or the gathered whole "
        f"params) and their contexts: "
        f"{ {k: round(v / GIB, 2) for k, v in total.items()} } GiB against "
        f"{TP['mem_limit_gib']:.0f}")
    if max(total.values()) > TP["mem_limit_gib"] * GIB:
        raise AssertionError(f"tp: {cfg.n_layers} layers do not fit: "
                             f"{total}")
    return {"stored_gib": {k: b[k] / GIB for k in ("shard_map", "gspmd")},
            "card_gib": {k: v / GIB for k, v in total.items()}}


def _meta_leaves(cfg) -> list:
    import torch

    from repro_torch.dist import tree_leaves
    from repro_torch.models.model import Model

    return tree_leaves(Model(cfg, torch.device("meta")).init(0))


def tp_prewarm(cfg) -> None:
    """Triton compiles K1-bwd for a new shape at its first launch: do it
    here, once, at the tp microbatch and the EP model's rows (the ranks
    then load it from Triton's cache)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    ds = get_config(EP["arch"])
    tokens = EP["model_tokens"][0] * EP["model_tokens"][1]
    shapes = [(b * s, cfg.d_model) for b, s in tp_microbatches()]
    shapes += [(tokens, ds.d_model), (tokens, ds.kv_lora_rank)]
    for rows, width in shapes:
        x = torch.ones((rows, width), dtype=torch.bfloat16, device="cuda",
                       requires_grad=True)
        w = torch.ones(width, device="cuda", requires_grad=True)
        ops.rmsnorm(x, w).sum().backward()
    gc.collect()
    torch.cuda.empty_cache()


def tp_phase(cfg_full, records=None, cpu=None, dry=None) -> dict:
    """Phase 19 (see the module doc). ``records`` are the card ranks'
    (from the elastic phase's spawn in a whole run), ``cpu`` the CPU
    arms' reports and seconds and ``dry`` the dry runs of (d) and (e);
    without them this spawns all three itself (``--phase tp``)."""
    import math

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import spawn_ranks

    cfg = cfg_full.scaled(n_layers=TP["depth"], grad_accum=1)
    t_phase = time.perf_counter()
    reading = tp_fits(cfg)
    if records is None:
        tp_prewarm(cfg)
        dry_run, dry_pool = start_fsdp_dry_runs(cfg)
        try:
            with ThreadPoolExecutor(1) as pool:
                cpu_run = pool.submit(tp_cpu_run)
                t0 = time.perf_counter()
                records, _ = spawn_ranks(tp_card_rank, TP["n"],
                                         device="cuda", args=(cfg,))
                card_s = time.perf_counter() - t0
                cpu = cpu_run.result()
            dry = dry_run.result()
        finally:
            dry_pool.shutdown()
    else:
        card_s = None
    cpu_reports, cpu_s = cpu["arms"], cpu["seconds"]
    stored = tp_block_bytes(cfg, TP["model_degree"])
    L = cfg.n_layers
    out = {"config": {"arch": cfg.name, "n_layers": L,
                      "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                      "padded_vocab": cfg.padded_vocab, **TP},
           "reading": reading, "cpu_seconds": cpu_s, "card_seconds": card_s,
           "ranks_seconds": [r["seconds"] for r in records],
           "arms": {}, "launches": {}}
    # (a) the two arms
    for i, (name, sync, _) in enumerate(TP_ARMS):
        ranks = [r["arms"][i] for r in records]
        r0 = ranks[0]
        for r in ranks:
            same = {k: r["report"][k] for k in TP_SAME}
            want = {k: cpu_reports[name][k] for k in TP_SAME}
            if same != want:
                raise AssertionError(f"tp {name} rank {r['rank']}: {same} "
                                     f"differ from the CPU run's {want}")
            losses = [s["loss"] for s in r["steps"]]
            if not all(math.isfinite(x) for x in losses) or \
                    losses != [s["loss"] for s in r0["steps"]]:
                raise AssertionError(f"tp {name}: losses {losses}")
        rep = r0["report"]
        if rep["wipeouts"] != 1 or rep["failures"] != 2:
            raise AssertionError(f"tp {name}: report {rep}")
        # the rollback: bit-identical to the snapshot it restores, and
        # the replayed step's loss its first execution's
        for r in ranks:
            roll = r["rollbacks"][0]
            snap = next(s for s in r["snapshots"]
                        if s["step"] == roll["step"])
            if roll["checksums"] != snap["checksums"]:
                raise AssertionError(f"tp {name} rank {r['rank']}: the "
                                     f"state after the rollback differs "
                                     f"from the snapshot")
            # the replay runs the healthy schedule where the first
            # execution ran the masked one: the same logical batch (§3.1),
            # so the same loss up to fp32 summation order; at one S_A,
            # bit for bit
            first = next(s for s in r["steps"] if s["step"] == roll["step"])
            replay = [s for s in r["steps"] if s["step"] == roll["step"]][1]
            tol = 0.0 if replay["s_a"] == first["s_a"] else \
                TP_REPLAY_TOL * abs(first["loss"])
            if not abs(replay["loss"] - first["loss"]) <= tol:
                raise AssertionError(f"tp {name}: replayed step "
                                     f"{replay['loss']} (S_A "
                                     f"{replay['s_a']}) != {first['loss']} "
                                     f"(S_A {first['s_a']})")
        # per step, the two model ranks of a data slice: bit-identical
        # replicas under shard_map, each its own block under gspmd
        for d in range(TP["n"] // TP["model_degree"]):
            a, b = ranks[2 * d], ranks[2 * d + 1]
            same = [x["checksums"] == y["checksums"]
                    for x, y in zip(a["steps"], b["steps"])]
            if sync == "shard_map" and not all(same):
                raise AssertionError(f"tp {name}: data slice {d}'s model "
                                     f"ranks diverged at steps {same}")
            if sync == "gspmd" and any(same):
                raise AssertionError(f"tp {name}: data slice {d}'s model "
                                     f"ranks hold the same blocks")
        for r in ranks:
            if r["stored_bytes"] != stored[sync]:
                raise AssertionError(f"tp {name} rank {r['rank']}: stores "
                                     f"{r['stored_bytes']} bytes, reckoned "
                                     f"{stored[sync]}")
        tol = TP_GRAD_TOL if sync == "gspmd" else \
            _int8_sweep_tolerance(TP["n"] // TP["model_degree"])
        if not r0["grad_rel_err"] <= tol:
            raise AssertionError(f"tp {name}: the first step's gradient "
                                 f"{r0['grad_rel_err']:.3g} from the "
                                 f"one-rank executor's (tolerance {tol})")
        micro = sum(r0["report"]["s_a_by_step"])
        executed = len(r0["report"]["s_a_by_step"])
        nb = r0["n_buckets"]
        k3 = executed * 2 * nb if sync == "shard_map" else 0
        want = dict.fromkeys(r0["launches"], 0)
        want.update({"rmsnorm": micro * (4 * L + 1),
                     "rmsnorm_bwd": micro * (2 * L + 1),
                     "flash_attention": micro * 2 * L,
                     "flash_attention_bwd": micro * L,
                     "int8_ef_absmax": k3, "int8_ef_quantize": k3})
        by_path: dict = {}
        for r in ranks:
            if r["launches"] != want:
                raise AssertionError(f"tp {name} rank {r['rank']}: "
                                     f"launches {r['launches']} != {want}")
            for k, v in r["launches"].items():
                by_path[k] = by_path.get(k, 0) + v
        out["launches"][name] = by_path
        steady = [s for s in r0["steps"][1:]]
        out["arms"][name] = {
            "report": rep, "grad_rel_err": r0["grad_rel_err"],
            "grad_tol": tol, "stored_gib": r0["stored_bytes"] / GIB,
            "step_s": [_median([s["seconds"] for s in r["steps"][1:]])
                       for r in ranks],
            "sync_share": [_median([s["sync_s"] / s["seconds"]
                                    for s in r["steps"][1:]])
                           for r in ranks],
            "steps": [{k: v for k, v in s.items() if k != "checksums"}
                      for s in r0["steps"]],
            "peak_gib": [r.get("peak_gib") for r in ranks],
            "rss_gib": [r["rss_gib"] for r in ranks],
            "rollback_s": [r["rollbacks"][0]["seconds"] for r in ranks],
            "wall_s": [r["wall_s"] for r in ranks],
            "init_s": [r["init_s"] for r in ranks], "n_buckets": nb,
            "steady_steps": len(steady)}
        a = out["arms"][name]
        log(f"[tp] {name}: step s {[round(x, 3) for x in a['step_s']]}, "
            f"sync share {[round(x, 3) for x in a['sync_share']]}, first "
            f"gradient within {a['grad_rel_err']:.3g} of the one-rank "
            f"executor's, a rank stores {a['stored_gib']:.2f} GiB, peak "
            f"{[round(x, 2) for x in a['peak_gib']]} GiB, RSS "
            f"{[round(x, 2) for x in a['rss_gib']]} GiB")
    # (b) EP
    from repro_torch.configs import get_config

    ds = get_config(EP["arch"]).scaled(n_layers=2)
    ep = [r["ep"] for r in records if r["ep"] is not None]
    ep_launches: dict = {}
    for r in ep:
        for case in r["cases"]:
            tol = EP["tol"][case["dtype"]]
            bad = {k: v for k, v in case["errors"].items() if not v <= tol}
            if bad:
                raise AssertionError(f"tp EP rank {r['rank']} "
                                     f"{case['dtype']} at {case['tokens']} "
                                     f"tokens: {bad} over {tol}")
        mod = r["model"]
        if not (abs(mod["loss_ep"] - mod["loss_one"])
                <= EP["model_tol"] * abs(mod["loss_one"])
                and mod["grad_rel_err"] <= EP["model_tol"]):
            raise AssertionError(f"tp EP model rank {r['rank']}: {mod}")
        # the model's forward and backward on each group: per pass, its
        # norms twice (the remat recompute) but the final one, each
        # norm's backward once; the layer alone runs no kernel
        norms = norms_per_pass(ds)
        want = dict.fromkeys(mod["launches"], 0)
        want.update({"rmsnorm": 2 * (2 * (norms - 1) + 1),
                     "rmsnorm_bwd": 2 * norms})
        if mod["launches"] != want or any(r["layer_launches"].values()):
            raise AssertionError(f"tp EP rank {r['rank']}: launches "
                                 f"{mod['launches']} != {want}, the layer "
                                 f"{r['layer_launches']}")
        for k, v in mod["launches"].items():
            ep_launches[k] = ep_launches.get(k, 0) + v
    if not any(c["dropped"] for c in ep[0]["cases"]):
        raise AssertionError("tp EP: no case dropped a slot")
    out["ep"] = ep
    out["launches"]["ep"] = ep_launches
    # (c) the elastic tier on the grid
    el = _tp_elastic_gates(records, cpu["elastic_cell"], L)
    out["elastic"] = el["readings"]
    for name, counts in el["launches"].items():
        out["launches"][name.removeprefix("tp_")] = counts
    e = out["elastic"]
    log(f"[tp elastic] cell {e['cell']} in {e['cell_s']:.1f} s (peak "
        f"{[round(x, 2) for x in e['cell_peak_gib']]} GiB, RSS "
        f"{[round(x, 2) for x in e['cell_rss_gib']]} GiB)")
    for sync in TP_ELASTIC["syncs"]:
        log(f"[tp elastic] {sync}: {e[sync]}")
    # (d) the FSDP x TP step and (e) the production dry run
    fsdp = [r["fsdp_tp"] for r in records]
    gates = fsdp_tp_gates(fsdp, dry)
    out["launches"]["fsdp_tp"] = gates["launches"]
    prod = dry["production"]
    out["fsdp_tp"] = {
        "losses": fsdp[0]["losses"], "ref_losses": fsdp[0]["ref_losses"],
        "loss_rel_err": gates["loss_rel_err"],
        "grad_rel_err": fsdp[0]["grad_rel_err"], "e_one": fsdp[0]["e_one"],
        "e_split": fsdp[0]["e_split"], "grad_tol": gates["grad_tol"],
        "loss_tol": FSDP_TP["loss_tol"],
        "stored_bytes": [r["stored_bytes"] for r in fsdp],
        "peak_bytes": [r["peak_bytes"] for r in fsdp],
        "dry_peak_bytes": [x["peak_bytes"] for x in dry["ranks"]],
        "peak_gap_bytes": gates["peak_gap_bytes"],
        "base_bytes": [r["base_bytes"] for r in fsdp],
        "collectives": len(fsdp[0]["schedule"]),
        "step_s": [r["step_s"] for r in fsdp],
        "ref_s": fsdp[0]["ref_s"],
        "seconds": [r["seconds"] for r in fsdp],
        "dry_s": [x["seconds"] for x in dry["ranks"]]}
    out["dryrun"] = {"record": prod, "seconds": dry["production_s"]}
    f = out["fsdp_tp"]
    log(f"[fsdp_tp] losses {f['losses']} vs one rank {f['ref_losses']} "
        f"(rel {[f'{x:.2e}' for x in f['loss_rel_err']]}), first gradient "
        f"within {f['grad_rel_err']:.3g} of one rank's (tol "
        f"{f['grad_tol']:.3g}; one rank's bf16 {f['e_one']:.3g} and the "
        f"split's {f['e_split']:.3g} from fp32); stored bytes {f['stored_bytes']} "
        f"= the dry run's arg_bytes; peak {f['peak_bytes']} vs the dry "
        f"run's {f['dry_peak_bytes']} (gap {f['peak_gap_bytes']}); "
        f"{f['collectives']} collectives a step as traced; step s "
        f"{[[round(x, 2) for x in s] for s in f['step_s']]}")
    log(f"[dryrun] qwen2.5-3b train_4k 16x16 at full depth in "
        f"{dry['production_s']:.1f} s: {json.dumps(prod)}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _int8_sweep_tolerance(dp: int) -> float:
    from repro_torch.exec import int8_sweep_tolerance

    return int8_sweep_tolerance(dp)


def profile_calls(calls, iters: int) -> dict:
    """For each ``(name, fn)``: host time per call (host clock around
    calls that end in a synchronize), device time per call and the
    kernels that take it (``torch.profiler``), and the device's busy
    share of the host's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"]
        dev_us = lambda e: e.self_device_time_total  # noqa: E731
        dev_ms = sum(dev_us(e) for e in kernels) / 1e3 / iters
        if not dev_ms > 0:
            raise AssertionError(f"{name}: the profiler saw no device time")
        top = sorted(kernels, key=dev_us, reverse=True)[:10]
        out[name] = {
            "host_ms": host_ms, "device_ms": dev_ms,
            "device_busy_share": dev_ms / host_ms,
            "kernel_launches": sum(e.count for e in kernels) // iters,
            "top_kernels": [{"name": e.key[:80],
                             "ms": dev_us(e) / 1e3 / iters,
                             "calls": e.count // iters} for e in top]}
        log(f"[profile] {name}: host {host_ms:.3f} ms, device "
            f"{dev_ms:.3f} ms per call ({dev_ms / host_ms:.1%} busy), "
            f"{out[name]['kernel_launches']} kernel launches")
        for k in out[name]["top_kernels"]:
            log(f"[profile]   {k['ms']:.4f} ms x{k['calls']} {k['name']}")
    return out


def profile_phase(cfg, cfg_ssm) -> dict:
    """Where the time goes on the main paths' models: for qwen2.5-3b and
    mamba2-1.3b, a serving decode step (all slots active, each at the
    longest bucket's length) and a prefill of the longest bucket; then
    one training step of each train phase's executor (qwen2.5-3b and
    mamba2-1.3b) at ``S_A = 1`` (full depth, int8 EF)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.serve import pages_needed
    from repro_torch.train import make_prefill, make_serve_step
    from repro_torch.train.trainer import TrainReport

    out = {}
    for c, prefix in ((cfg, ""), (cfg_ssm, "ssm_")):
        model = build_model(c, device="cuda")
        params = model.init(SERVE["seed"])
        slots, ps = SERVE["slots"], SERVE["page_size"]
        longest = max(SERVE["buckets"])
        m = pages_needed(longest + SERVE["max_new"], ps)
        pools = model.init_paged_state(slots, slots * m + 1, ps)
        table = (1 + torch.arange(slots * m, device="cuda")).reshape(slots,
                                                                     m)
        pos = torch.full((slots,), longest, device="cuda")
        toks = torch.ones((slots, 1), dtype=torch.long, device="cuda")
        step = make_serve_step(model, paged=True)
        prefill = make_prefill(model, return_cache=True)
        prompt = torch.ones((1, longest), dtype=torch.long, device="cuda")
        out.update(profile_calls(
            [(f"{prefix}decode_step",
              lambda: step(params, pools, table, pos, toks)),
             (f"{prefix}prefill_{longest}",
              lambda: prefill(params, prompt))], iters=5))
        del model, params, pools, step, prefill
        gc.collect()
        torch.cuda.empty_cache()

    for c, st, name in ((cfg, TRAIN, "train_step"),
                        (cfg_ssm, SSM_TRAIN, "ssm_train_step")):
        ex = _executor(c.scaled(n_layers=st["depths"][0], grad_accum=1),
                       "cuda", n_groups=st["n_groups"], r=st["r"],
                       seq=st["seq"], per_type_batch=st["per_type_batch"],
                       seed=st["seed"], grad_compress="int8_ef",
                       bucket_mb=st["bucket_mb"])
        report = TrainReport()
        out[name] = profile_calls(
            [(name, lambda: float(ex._dispatch(report)[2]["loss"]))],
            iters=2)[name]
        del ex
        gc.collect()
        torch.cuda.empty_cache()
    return out


def decode_vs_prefill(model, params, cfg, rid, generated,
                      tag="slice", settings: dict = SERVE,
                      gate: bool = True) -> dict:
    """Prefill the prompt of request ``rid`` plus its generated tokens (a
    length off the buckets: the flash kernel's ragged tile, or K4's
    ragged chunk) and compare, at each generated position, the prefill's
    logits with the greedy choice the decode made there. The two paths
    round differently in bf16 (the fused prefill kernels keep fp32 where
    the plain decode rounds to bf16), so a near-tie may flip; the chosen
    token's prefill logit must then still be within 0.25 of the
    prefill's maximum (logits here have a spread of about 1)."""
    import numpy as np
    import torch

    from repro_torch.data import RequestStream

    req = RequestStream(cfg, buckets=settings["buckets"],
                        max_new=settings["max_new"],
                        seed=settings["seed"]).request(rid)
    seq = np.concatenate([req.tokens, generated[:-1]]).astype(np.int64)
    with torch.no_grad():
        logits, _ = model.prefill(params, torch.from_numpy(seq)[None].cuda())
    logits = logits[0, req.prompt_len - 1:, :cfg.vocab].float()
    if tuple(logits.shape) != (len(generated), cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits: shape "
                             f"{tuple(logits.shape)} or not finite")
    chosen = torch.from_numpy(np.asarray(generated, np.int64)).cuda()
    agree = (logits.argmax(-1) == chosen).float().mean().item()
    gap = (logits.max(-1).values
           - logits.gather(1, chosen[:, None])[:, 0]).max().item()
    log(f"[{tag}] decode vs prefill (request {rid}, {len(seq)} tokens): "
        f"greedy agreement {agree:.3f}, largest logit gap {gap:.4f} over "
        f"{len(generated)} tokens (logit std {logits.std().item():.3f})")
    if gate and not gap <= 0.25:
        raise AssertionError(f"decode chose a token {gap} below the "
                             f"prefill's best")
    return {"request": rid, "prefill_tokens": len(seq),
            "greedy_agreement": agree, "max_logit_gap": gap, "tol": 0.25,
            "logit_std": logits.std().item(), "positions": len(generated)}


def _pinned_routes(n_moe: int, routes=None):
    """Patch ``route_topk`` for a check of a deep MoE model: each call
    records the experts its own gates pick (sorted index rows, on the
    host), by MoE layer in call order; given ``routes`` (a recorded
    (S, k) row set a layer), it takes the experts of ``routes[layer]`` at
    the positions in ``state["positions"]`` instead, its own gates
    softmaxed over them, as ``route_topk`` weighs its own top-k. Returns
    ``(state, undo)``; ``state["own"]`` is the record."""
    import torch

    from repro_torch.models import moe as moe_mod

    orig = moe_mod.route_topk
    state = {"calls": 0, "positions": None, "own": [[] for _ in
                                                    range(n_moe)]}

    def route(x_flat, router_w, top_k):
        layer = state["calls"] % n_moe
        state["calls"] += 1
        idx, w = orig(x_flat, router_w, top_k)
        state["own"][layer].append(idx.sort(-1).values.cpu())
        if routes is None:
            return idx, w
        idx = routes[layer][state["positions"]].to(x_flat.device)
        gates = torch.matmul(x_flat.float(), router_w.float())
        return idx, torch.softmax(gates.gather(1, idx), dim=-1)
    moe_mod.route_topk = route
    return state, lambda: setattr(moe_mod, "route_topk", orig)


def decode_vs_prefill_pinned(model, params, cfg, rid, generated,
                             tag="slice", settings: dict = SERVE) -> dict:
    """:func:`decode_vs_prefill` for a deep MoE model in bf16. A token's
    top-k turns on router gaps that bf16 roundings move, and the decode
    step and a prefill over the same tokens round differently (other row
    counts in every product), so at some positions some layer sends the
    token to other experts, and from there the two paths' logits are
    different functions: over deepseek's 26 MoE layers every position of
    a request took other experts somewhere, and the logits decorrelate.
    So the request's prompt and generated tokens are prefilled with each
    MoE layer's experts recorded, then decoded token by token through
    the paged path (the prompt prefilled into a page pool, then one
    ``decode_step_paged`` a position, teacher-forced) with each MoE layer
    given the prefill's experts at that position (its own gates weighing
    them): the decode's greedy choice at every position must be within
    0.25 of the prefill's best logit, the gate of
    :func:`decode_vs_prefill`. The positions whose own routing differed
    somewhere are counted, and the healthy run's tokens against the
    prefill reported, not gated."""
    import numpy as np
    import torch

    from repro_torch.data import RequestStream
    from repro_torch.serve import make_cache_writer, pool_pages_for

    req = RequestStream(cfg, buckets=settings["buckets"],
                        max_new=settings["max_new"],
                        seed=settings["seed"]).request(rid)
    plen, ps = req.prompt_len, settings["page_size"]
    n_moe = sum(k.endswith("moe") for k in cfg.block_kinds())
    seq = torch.from_numpy(np.concatenate(
        [req.tokens, generated[:-1]]).astype(np.int64)).cuda()[None]
    state, undo = _pinned_routes(n_moe)
    try:
        with torch.no_grad():
            ref, _ = model.prefill(params, seq)
    finally:
        undo()
    routes = [own[0] for own in state["own"]]           # (S, k) a layer
    n_pages = pool_pages_for(1, seq.shape[1], ps)
    table = torch.arange(1, n_pages, device="cuda")[None]
    pools = model.init_paged_state(1, n_pages, ps)
    state, undo = _pinned_routes(n_moe, routes)
    try:
        with torch.no_grad():
            state["positions"] = torch.arange(plen)
            first, dense = model.prefill(params, seq[:, :plen])
            make_cache_writer(model)(pools, dense, table[0], 0)
            got = [first[0, -1]]
            for t in range(plen, seq.shape[1]):
                state["positions"] = torch.tensor([t])
                lg, pools = model.decode_step_paged(
                    params, pools, table, torch.tensor([t], device="cuda"),
                    tokens=seq[:, t:t + 1])
                got.append(lg[0, 0])
    finally:
        undo()
    own = [torch.cat(per) for per in state["own"]]       # (S, k) a layer
    flipped = sum(any(not torch.equal(own[i][t], routes[i][t])
                      for i in range(n_moe))
                  for t in range(plen - 1, seq.shape[1]))
    ref = ref[0, plen - 1:, :cfg.vocab].float()
    got = torch.stack(got)[:, :cfg.vocab].float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{tag}: decode logits {tuple(got.shape)} "
                             f"against {tuple(ref.shape)}, or not finite")
    choice = got.argmax(-1)
    gap = (ref.max(-1).values
           - ref.gather(1, choice[:, None])[:, 0]).max().item()
    agree = (choice == ref.argmax(-1)).float().mean().item()
    rms = (got - ref).square().mean().sqrt().item()
    healthy = decode_vs_prefill(model, params, cfg, rid, generated, tag,
                                settings, gate=False)
    log(f"[{tag}] decode vs prefill, each MoE layer given the prefill's "
        f"experts (request {rid}, {seq.shape[1]} tokens, teacher-forced): "
        f"greedy agreement {agree:.3f}, largest logit gap {gap:.4f} (tol "
        f"0.25), logit RMS difference {rms:.4f}; left to their own gates "
        f"{flipped} of {ref.shape[0]} positions take other experts in "
        f"some of the {n_moe} MoE layers")
    if not gap <= 0.25:
        raise AssertionError(f"{tag}: with the prefill's experts the decode "
                             f"chose a token {gap} below the prefill's best")
    return {"request": rid, "positions": ref.shape[0],
            "greedy_agreement": agree, "max_logit_gap": gap, "tol": 0.25,
            "logit_rms_diff": rms, "positions_routed_otherwise": flipped,
            "healthy_run": healthy}


# ------------------------------------------------------------------ #
# audit: the §3.1 certification and the static audit                 #
# ------------------------------------------------------------------ #
#: part (c) of the audit phase: qwen2.5-3b at published width and 2
#: layers, N 4, r 2, the int8 EF sync in 32 MiB buckets, 2 x 256 tokens a
#: rank of a fake grid of 4 ranks (a one-rank NCCL group takes all 8
#: examples); the sweep's tolerance is the JAX sweep's (tests/test_exec.py)
AUDIT = dict(depth=2, n_groups=4, redundancy=2, seq=256, per_type_batch=2,
             bucket_mb=32.0, total_steps=50, tol=5e-3, wire_ratio_max=0.3)
#: the kernels the audit's steps must launch
AUDIT_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd", "int8_ef_absmax",
                 "int8_ef_quantize")


def _audit_counts(report) -> dict:
    """Each target's line of a certification report."""
    return {name.removeprefix("target:"): counts
            for name, counts in sorted(report.summary.items())
            if name.startswith("target:")}


def audit_published(cfg_full) -> dict:
    """Part (c): the step passes and the schedule sweep on ranks 0 and 3
    of a fake grid of 4 at published width, the int8/fp32 wire ratio, and
    ``survivor_set_sweep`` on a real one-rank NCCL group in both syncs."""
    import torch

    from repro_torch.analysis import Report
    from repro_torch.exec import (MeshExecutor, int8_sweep_tolerance,
                                  survivor_set_sweep)
    from repro_torch.launch.lint import audit_executor, fake_grid
    from repro_torch.launch.mesh import close_data_group, init_data_group
    from repro_torch.launch.steplog import collective_report, wire_byte_ratio
    from repro_torch.train.trainer import SpareTrainer

    cfg = cfg_full.scaled(n_layers=AUDIT["depth"], grad_accum=1)
    kw = {k: AUDIT[k] for k in ("n_groups", "redundancy", "seq",
                                "per_type_batch", "bucket_mb",
                                "total_steps")}
    world = AUDIT["n_groups"]
    report, logs, ranks = Report(), {}, {}
    t0 = time.perf_counter()
    for rank in (0, world - 1):
        with fake_grid(rank, world) as group:
            for compress in ("int8_ef", None):
                if compress is None and rank:
                    continue
                tag = f"published:{compress or 'fp32'}@rank{rank}"
                ex = MeshExecutor(cfg, grad_compress=compress, group=group,
                                  device="cuda", **kw)
                try:
                    # the fp32 step is recorded for the wire ratio only
                    ranks[tag], logs[(compress, rank)] = audit_executor(
                        report, ex, tag, sweep=compress is not None)
                finally:
                    ex.close()
                    del ex
                    gc.collect()
                    torch.cuda.empty_cache()
    fake_s = time.perf_counter() - t0
    ratio = wire_byte_ratio(logs[("int8_ef", 0)], logs[(None, 0)])
    wire = {c: collective_report(logs[(c, 0)])
            for c in ("int8_ef", None)}
    t0 = time.perf_counter()
    sweeps = {}
    close_data_group()
    init_data_group("cuda")
    try:
        for compress in (None, "int8_ef"):
            ex = MeshExecutor(cfg, grad_compress=compress, device="cuda",
                              **kw)
            ref = SpareTrainer(cfg, n_groups=kw["n_groups"],
                               redundancy=kw["redundancy"], seq=kw["seq"],
                               per_type_batch=kw["per_type_batch"],
                               total_steps=kw["total_steps"], device="cuda")
            ref.params = ex.params      # one set of weights for both
            try:
                checks = survivor_set_sweep(ex, ref)
            finally:
                ex.close()
                del ex, ref
                gc.collect()
                torch.cuda.empty_cache()
            tol = int8_sweep_tolerance(1) if compress else AUDIT["tol"]
            name = compress or "fp32"
            sweeps[name] = {
                "tol": tol, "sets": len(checks),
                "singles": sum(len(c.victims) == 1 for c in checks),
                "s_a": sorted({c.s_a for c in checks}),
                "max_mesh_vs_host": max(c.mesh_vs_host for c in checks),
                "max_mesh_vs_vanilla": max(c.mesh_vs_vanilla
                                           for c in checks),
                "failed": [list(c.victims) for c in checks if not c.ok(tol)]}
    finally:
        close_data_group()
    sweep_s = time.perf_counter() - t0
    out = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, **kw},
           "ranks": ranks, "violations": [v.render() for v in
                                          report.violations],
           "wire_ratio": ratio, "wire": {str(k): v for k, v in wire.items()},
           "sweeps": sweeps, "fake_grid_s": fake_s, "sweep_s": sweep_s}
    if report.violations:
        raise AssertionError(f"audit (c): {report.render_text()}")
    if not ratio <= AUDIT["wire_ratio_max"]:
        raise AssertionError(f"audit (c): int8/fp32 wire bytes {ratio} > "
                             f"{AUDIT['wire_ratio_max']}")
    for name, sw in sweeps.items():
        if sw["failed"] or sw["singles"] != AUDIT["n_groups"]:
            raise AssertionError(f"audit (c): the {name} sweep: {sw}")
    return out


def audit_phase(cfg_full) -> dict:
    """The §3.1 certification on the card (phase 20): (a) the AST passes
    over the port's files, (b) the lint's certification target set
    (``certify_executors``) with CUDA tensors, (c) the published-width
    part (:func:`audit_published`); the kernels' launches counted from 0
    around the phase."""
    from repro_torch.analysis import run_ast_passes
    from repro_torch.kernels import ops
    from repro_torch.launch.lint import certify_executors
    from repro_torch.launch.mesh import close_data_group

    t0 = time.perf_counter()
    close_data_group()          # a group an earlier phase left up
    ops.reset_launches()
    ast = run_ast_passes(ROOT)
    files = ast.summary["ast"]["files_scanned"]
    log(f"[audit] (a) AST passes: {files} files, {len(ast.violations)} "
        f"violations, {len(ast.suppressed)} suppressed")
    if ast.violations:
        raise AssertionError(f"audit (a): {ast.render_text()}")
    t1 = time.perf_counter()
    rep = certify_executors("cuda", progress=log)
    targets = _audit_counts(rep)
    certify_s = time.perf_counter() - t1
    if not rep.clean:
        raise AssertionError(f"audit (b): {rep.render_text()}")
    published = audit_published(cfg_full)
    launches = dict(ops.launches)
    missing = [k for k in AUDIT_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"audit: {missing} never launched: {launches}")
    return {"ast": {"files": files, "violations": 0,
                    "suppressed": len(ast.suppressed)},
            "targets": targets, "certify_s": certify_s,
            "published": published, "launches": launches,
            "seconds": time.perf_counter() - t0}


def kernel_table(kernels: list[dict], by_path: dict) -> dict:
    """One row per kernel; its times are those at the shape its main path
    runs most (the longest prompt bucket in bf16 for the forwards, one
    training microbatch in bf16 for the backwards, the largest fp32
    gradient bucket for K3; the other shapes stay under ``shapes``).
    ``launches`` sums the paths run, each counted from 0 just before it
    and read just after (``launches_by_path``)."""
    rows = []
    for k in kernels:
        # a phase run alone (--phase families) may hold no main shape
        head = next((sh for sh in k["shapes"] if sh["main"]),
                    k["shapes"][0])
        per = {path: n[k["name"]] for path, n in by_path.items()}
        rows.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": sum(per.values()) if per else None,
            "launches_by_path": per,
            "max_abs_err": k["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "at": head["shape"], "dtype_routes": k.get("dtype_routes"),
            "shapes": k["shapes"]})
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "train",
                                        "ssm-train", "families", "hybrid",
                                        "mla", "v3-train", "campaign",
                                        "elastic", "tp", "audit",
                                        "profile"),
                    default="all")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import close_data_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_main = time.perf_counter()

    marks: dict = {}

    def mark(name: str) -> None:
        marks[name] = time.perf_counter() - t_main
        log(f"[time] {name} at {marks[name]:.1f} s")

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    mark("build")
    result["build"] = build_kernels()
    cfg, cfg_ssm = get_config(ARCH), get_config(SSM_ARCH)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    if args.phase == "profile":
        try:
            result["profile"] = profile_phase(cfg, cfg_ssm)
        finally:
            close_data_group()
        (out / "chip_profile.json").write_text(json.dumps(result, indent=1))
        return 0
    try:
        kernels, by_path = [], {}
        if args.phase in ("all", "kernels"):
            mark("kernels")
            kernels = kernel_phase(cfg, cfg_ssm)
        if args.phase == "all":
            mark("reference")
            result["reference"] = reference_phase(cfg)
            result["train_reference"] = train_reference_phase(cfg)
            mark("slice")
            result["slice"] = slice_phase(cfg)
            by_path["serve"] = result["slice"]["launches"]
            by_path["serve_default_spellings"] = \
                result["slice"]["default_spellings"]["launches"]
            mark("ssm")
            result["ssm_reference"] = ssm_reference_phase(cfg_ssm)
            result["ssm_slice"] = slice_phase(cfg_ssm, tag="ssm slice")
            by_path["ssm_serve"] = result["ssm_slice"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
        if args.phase in ("all", "train"):
            mark("dots")
            result["dots"] = dots_phase(cfg, cfg_ssm)
            by_path["train_dots"] = result["dots"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
            mark("train")
            result["train"] = train_phase(cfg)
            by_path["train"] = result["train"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
            mark("failure tiers")
            result["failure_tiers"] = failure_tiers_phase(
                cfg, result["train"]["config"]["n_layers"])
            by_path["train_failure_tiers"] = \
                result["failure_tiers"]["launches"]
        if args.phase == "ssm-train":
            mark("kernels")
            kernels = [check_ssd_scan_bwd(cfg_ssm)]
        if args.phase in ("all", "ssm-train"):
            gc.collect()
            torch.cuda.empty_cache()
            mark("ssm train")
            result["ssm_train_reference"] = ssm_train_reference_phase(
                cfg_ssm)
            result["ssm_train"] = train_phase(cfg_ssm, SSM_TRAIN,
                                              "ssm train")
            by_path["ssm_train"] = result["ssm_train"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
        if args.phase == "families":
            mark("kernels")
            kernels = merge_checks([], family_kernel_checks(cfg))
        if args.phase in ("all", "families"):
            gc.collect()
            torch.cuda.empty_cache()
            mark("families")
            t0 = time.perf_counter()
            result["families"] = families_phase()
            result["families_seconds"] = time.perf_counter() - t0
            for arch, rec in result["families"].items():
                by_path[f"families_serve_{arch}"] = rec["serve"]["launches"]
                by_path[f"families_train_{arch}"] = rec["train"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
        if args.phase == "hybrid":
            mark("kernels")
            kernels = merge_checks([], hybrid_kernel_checks(
                get_config(HYBRID_ARCH)))
        if args.phase in ("all", "hybrid"):
            gc.collect()
            torch.cuda.empty_cache()
            mark("hybrid")
            result["hybrid"] = hybrid_phase(clis=args.phase == "hybrid")
            by_path["hybrid_serve"] = result["hybrid"]["serve"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
        if args.phase == "mla":
            mark("kernels")
            kernels = merge_checks([], mla_kernel_checks(
                get_config(MLA_ARCH), get_config(MLA_V3_ARCH)))
        if args.phase in ("all", "mla"):
            gc.collect()
            torch.cuda.empty_cache()
            mark("mla")
            result["mla"] = mla_phase(clis=args.phase == "mla")
            by_path["mla_serve"] = result["mla"]["serve"]["launches"]
            by_path["mla_train"] = result["mla"]["train"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
        if args.phase == "v3-train":
            mark("kernels")
            kernels = merge_checks([], v3_kernel_checks(get_config(V3_ARCH)))
            log_checks(kernels)
        if args.phase in ("all", "v3-train"):
            gc.collect()
            torch.cuda.empty_cache()
            mark("v3 train")
            result["v3_train"] = v3_train_phase()
            by_path["v3_train"] = result["v3_train"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
        if args.phase == "all":
            by_path["serve_wipeout"] = result["slice"]["wipeout_launches"]
            mark("cli")
            result["cli"] = cli_phase({**HYBRID_CLIS, **MLA_CLIS})
        if args.phase in ("all", "campaign"):
            gc.collect()
            torch.cuda.empty_cache()
            mark("campaign")
            t0 = time.perf_counter()
            result["campaign"] = campaign_phase(cfg)
            result["campaign"]["seconds"] = time.perf_counter() - t0
            by_path.update(result["campaign"]["launches"])
        if args.phase in ("all", "elastic"):
            gc.collect()
            torch.cuda.empty_cache()
            mark("elastic")
            t0 = time.perf_counter()
            result["elastic"] = elastic_phase(cfg, tp=args.phase == "all")
            result["elastic"]["seconds"] = time.perf_counter() - t0
            by_path["elastic"] = result["elastic"]["launches"]
        if args.phase == "tp":
            mark("kernels")
            kernels = tp_alone_checks(cfg)
            log_checks(kernels)
        if args.phase in ("all", "tp"):
            # in a whole run the elastic phase's ranks ran the tp ranks'
            # part too: gate and summarise their records here
            gc.collect()
            torch.cuda.empty_cache()
            mark("tp")
            el = result.get("elastic", {})
            result["tp"] = tp_phase(cfg, el.pop("tp_records", None),
                                    el.pop("tp_cpu", None),
                                    el.pop("tp_dry", None))
            for name, counts in result["tp"]["launches"].items():
                by_path[name if name == "fsdp_tp" else f"tp_{name}"] = \
                    counts
        if args.phase in ("all", "audit"):
            gc.collect()
            torch.cuda.empty_cache()
            mark("audit")
            result["audit"] = audit_phase(cfg)
            by_path["audit"] = result["audit"]["launches"]
    finally:
        close_data_group()
    mark("end")
    table = kernel_table(kernels, by_path)
    result["kernels"] = table["kernels"]
    result["seconds"] = time.perf_counter() - t_main
    (out / "chip_smoke.json").write_text(json.dumps(result, indent=1))

    print(json.dumps({"kernels": [{k: v for k, v in row.items()
                                   if k != "shapes"}
                                  for row in table["kernels"]]}))
    if args.phase == "all":
        for phase, tag in (("slice", "slice"), ("ssm_slice", "ssm slice")):
            for name in ("healthy", "burst"):
                r = result[phase]["runs"][name]
                print(f"[{tag}] {result[phase]['config']['arch']} {name}: "
                      f"{r['tokens_per_s']:.2f} tok/s, p50 {r['p50_ms']} "
                      f"ms, p99 {r['p99_ms']} ms per token ({card})")
    if args.phase == "all":
        w = result["slice"]["runs"]["wipeout"]
        print(f"[slice] {result['slice']['config']['arch']} wipeout: "
              f"{w['tokens_per_s']:.2f} tok/s, reload from the checkpoint "
              f"{w['reload_s']:.2f} s, tokens identical ({card})")
    if "failure_tiers" in result:
        f = result["failure_tiers"]
        print(f"[failure tiers] {f['config']['n_layers']} layers: "
              f"{f['ckpt_saves']} saves, checkpoint {f['save_gib']:.2f} GiB "
              f"in {f['save_s']:.2f} s = {f['save_gb_per_s']:.3f} GB/s to "
              f"{f['filesystem']}, restore {f['restore_s']:.2f} s; step "
              f"{f['step_s_save_in_flight_median']} s with a save in "
              f"flight vs {f['step_s_no_save_median']} s; peak RSS "
              f"{f['peak_rss_gib']:.2f} of {f['host_mem_total_gib']:.2f} "
              f"GiB ({card})")
    if "campaign" in result:
        cp = result["campaign"]
        for name, runs in (("trainer", cp["trainer"]), ("gray", cp["gray"])):
            for label, r in runs.items():
                print(f"[campaign] {name} {label}, {cp['depth']} layers: "
                      f"{r['seconds']:.1f} s, step s by S_A "
                      f"{ {sa: v['median'] for sa, v in r['step_s_by_s_a'].items()} }"
                      f", peak {r['peak_gib']:.2f} GiB, peak RSS "
                      f"{r['peak_rss_gib']:.2f} GiB, snapshots "
                      f"{[round(x, 2) for x in r['snapshot_s']]} s ({card})")
        print(f"[campaign] phase {cp['seconds']:.1f} s; DES grid "
              f"{cp['des']['seconds']} s; counts equal to the CPU runs', "
              f"{cp['multi_group_events']} multi-group events, launch.obs "
              f"gates passed ({card})")
    if "elastic" in result:
        e, b = result["elastic"], result["elastic"]["bits"]
        for arm, a in e["arms"].items():
            print(f"[elastic] {arm}, {e['depth']} layers, {ELASTIC['n']} "
                  f"ranks over {e['backend']}: run {a['seconds']:.1f} s, step s "
                  f"{a['step_s_before_kill']} before the kill and "
                  f"{a['step_s_after_kill']} after, reshape wall s "
                  f"{[round(x, 2) for x in a['reshape_wall_s']]}, peak "
                  f"{[round(x, 2) for x in a['peak_gib']]} GiB (sum "
                  f"{sum(a['peak_gib']):.2f}), RSS at the end "
                  f"{[round(x, 2) for x in a['rss_gib']]} GiB ({card})")
        print(f"[elastic] bits: step s {b['dp4']['step_s']} at DP 4 (sync "
              f"{b['dp4']['sync_share']:.1%}), {b['dp2']['step_s']} at DP 2 "
              f"(sync {b['dp2']['sync_share']:.1%}); reshape "
              f"{b['reshape']['wall_s']:.2f} s (group "
              f"{b['reshape'].get('group_s', 0.0):.2f}, EF move "
              f"{b['reshape'].get('ef_move_s', 0.0):.2f}), restore "
              f"{b['restore_s']:.2f} s, rollback {b['rollback_s']:.2f} s; "
              f"counts equal to the CPU runs', bit gates held; the arms "
              f"{e['card_seconds']:.1f} s on the card and "
              f"{e['cpu_seconds']:.1f} s on the CPU; phase "
              f"{e['seconds']:.1f} s ({card})")
    if "tp" in result:
        t = result["tp"]
        for name, a in t["arms"].items():
            print(f"[tp] {name}, {t['config']['n_layers']} layers, 2 x 2 "
                  f"ranks: step s {[round(x, 3) for x in a['step_s']]} "
                  f"(median a rank), sync {[f'{x:.1%}' for x in a['sync_share']]}"
                  f" of a step (gathers included), first gradient within "
                  f"{a['grad_rel_err']:.3g} of a one-rank executor's, a rank "
                  f"stores {a['stored_gib']:.2f} GiB, peak "
                  f"{[round(x, 2) for x in a['peak_gib']]} GiB, RSS "
                  f"{[round(x, 2) for x in a['rss_gib']]} GiB ({card})")
        for r in t["ep"]:
            cases = {f"{c['dtype']}@{c['tokens']}":
                     (c["dropped"], round(c["ep_ms"], 2)) for c in r["cases"]}
            print(f"[tp] EP rank {r['rank']}: expert bytes "
                  f"{r['expert_bytes_bfloat16'] / GIB:.3f} GiB (bf16), "
                  f"(dropped, ms) {cases}, model loss {r['model']['loss_ep']:.5f}"
                  f" vs {r['model']['loss_one']:.5f} ({card})")
        e = t["elastic"]
        print(f"[tp elastic] cell {TP_ELASTIC['arm']} (N 2, r 1, model 2): "
              f"{e['cell']}, {e['cell_s']:.1f} s ({card})")
        for sync in TP_ELASTIC["syncs"]:
            x = e[sync]
            print(f"[tp elastic] {sync} bits: step s {x['dp2']['step_s']} at "
                  f"DP 2 (sync {x['dp2']['sync_share']:.1%}), "
                  f"{x['dp1']['step_s']} at DP 1 (sync "
                  f"{x['dp1']['sync_share']:.1%}); reshape {x['reshape']}, "
                  f"restore {x['restore']}, rollback {x['rollback']}; peak "
                  f"{x['peak_gib']} GiB, RSS {x['rss_gib']} GiB; "
                  f"{x['seconds']:.1f} s ({card})")
        f = t["fsdp_tp"]
        print(f"[fsdp_tp] qwen2.5-3b, {t['config']['n_layers']} layers, "
              f"data 2 x model 2 (rule table blocks): losses "
              f"{[round(x, 5) for x in f['losses']]} vs one rank "
              f"{[round(x, 5) for x in f['ref_losses']]}, first gradient "
              f"within {f['grad_rel_err']:.3g} (tol {f['grad_tol']:.3g}; "
              f"bf16 from fp32: one rank {f['e_one']:.3g}, split "
              f"{f['e_split']:.3g}); "
              f"stored {f['stored_bytes'][0] / GIB:.3f} GiB a rank = the "
              f"dry run's arg_bytes; peak "
              f"{[round(x / GIB, 3) for x in f['peak_bytes']]} GiB vs the "
              f"dry run's {[round(x / GIB, 3) for x in f['dry_peak_bytes']]}"
              f"; schedule of {f['collectives']} collectives as traced; "
              f"step s {[round(x, 2) for x in f['step_s'][0]]} ({card})")
        d = t["dryrun"]
        r = d["record"]
        print(f"[dryrun] qwen2.5-3b train_4k 16x16, {r['n_layers']} layers, "
              f"traced on the CPU in {d['seconds']:.1f} s: peak "
              f"{r['peak_bytes'] / GIB:.2f} GiB, arg "
              f"{r['arg_bytes'] / GIB:.3f} GiB, {r['flops_per_device']:.4g} "
              f"FLOPs, {r['bytes_per_device']:.4g} bytes, collectives "
              f"{r['collectives']['total_bytes'] / GIB:.2f} GiB, "
              f"bottleneck {r['bottleneck']} (H100 data-sheet rates)")
        print(f"[tp] phase gates held; the ranks' tp part "
              f"{max(t['ranks_seconds']):.1f} s, the CPU arms "
              f"{t['cpu_seconds']:.1f} s ({card})")
    if "audit" in result:
        a = result["audit"]
        for name, c in a["targets"].items():
            print(f"[audit] {name}: {c['survivor_sets']} survivor sets "
                  f"certified, {c['programs']} programs certified, "
                  f"{c['leaves_in_place']} leaves audited in place, "
                  f"{c['host_syncs']} host syncs seen by the sync debug "
                  f"mode, {c['violations']} violations ({card})")
        p = a["published"]
        for tag, c in p["ranks"].items():
            print(f"[audit] {tag} ({p['config']['arch']}, "
                  f"{p['config']['n_layers']} layers): {c['survivor_sets']} "
                  f"survivor sets certified, {c['collectives']} "
                  f"collectives, {c['leaves_in_place']} leaves audited in "
                  f"place, {c['host_syncs']} host syncs, "
                  f"{c['violations']} violations ({card})")
        for name, sw in p["sweeps"].items():
            print(f"[audit] survivor_set_sweep {name}, one NCCL rank: "
                  f"{sw['sets']} sets ({sw['singles']} singles, S_A "
                  f"{sw['s_a']}), mesh vs host {sw['max_mesh_vs_host']:.3g}, "
                  f"mesh vs vanilla {sw['max_mesh_vs_vanilla']:.3g} (tol "
                  f"{sw['tol']:.3g}) ({card})")
        print(f"[audit] int8/fp32 wire bytes {p['wire_ratio']:.4f} (gate "
              f"{AUDIT['wire_ratio_max']}); AST {a['ast']['files']} files, "
              f"0 violations; launches "
              f"{ {k: a['launches'][k] for k in AUDIT_KERNELS} }; "
              f"certify {a['certify_s']:.1f} s, fake grid "
              f"{p['fake_grid_s']:.1f} s, sweeps {p['sweep_s']:.1f} s")
        print(f"[time] audit phase {a['seconds']:.1f} s ({card})")
    if "dots" in result:
        for name in ("qwen", "mamba2"):
            d = result["dots"][name]
            pol = d["policies"]
            none = "bit-identical" if d["none_bit_identical"] else \
                f"off by {d['none_max_abs']:.3e}"
            print(f"[dots] {d['config']['arch']}, {d['config']['n_layers']} "
                  f"layers, {d['config']['tokens']} tokens: 'dots' "
                  f"bit-identical to 'nothing', launches equal; 'none' "
                  f"{none}; "
                  f"peak GiB none {pol['none']['peak_gib']:.3f}, dots "
                  f"{pol['dots']['peak_gib']:.3f}, nothing "
                  f"{pol['nothing']['peak_gib']:.3f}; s "
                  f"{ {p: round(v['seconds'], 3) for p, v in pol.items()} } "
                  f"({card})")
    for arch, f in result.get("families", {}).items():
        sv, t = f["serve"]["runs"], f["train"]
        print(f"[families] {arch}: serve {f['serve']['config']['n_layers']} "
              f"layers, {sv['healthy']['n_tokens']} tokens a run, healthy "
              f"{sv['healthy']['tokens_per_s']:.2f} tok/s "
              f"(p50 {sv['healthy']['p50_ms']} ms, p99 "
              f"{sv['healthy']['p99_ms']} ms), burst "
              f"{sv['burst']['tokens_per_s']:.2f} tok/s (p50 "
              f"{sv['burst']['p50_ms']} ms, p99 {sv['burst']['p99_ms']} ms); "
              f"train {t['config']['n_layers']} layers: step "
              f"{t['step_s_median']:.3f} s at S_A=1 (median of "
              f"{t['steady_steps']}; {t['step_s_masked_median']:.3f} s "
              f"masked), "
              f"{t['tokens_per_s']:.1f} tokens/s, sync "
              f"{t['sync_share_median']:.1%}, peak {t['peak_gib']:.2f} GiB, "
              f"snapshot {t['snapshot_gib']:.2f} GiB in "
              f"{t['snapshot_s']:.2f} s; {f['seconds']:.1f} s ({card})")
    if "families" in result:
        print(f"[families] phase {result['families_seconds']:.1f} s "
              f"({card})")
    if "hybrid" in result:
        hy = result["hybrid"]
        sv = hy["serve"]
        for name in ("healthy", "burst"):
            r = sv["runs"][name]
            print(f"[hybrid] {sv['config']['arch']} {name}, "
                  f"{sv['config']['n_layers']} layers: "
                  f"{r['tokens_per_s']:.2f} tok/s, p50 {r['p50_ms']} ms, "
                  f"p99 {r['p99_ms']} ms per token ({card})")
        m = hy["moe"]
        print(f"[hybrid] serving peak {sv['peak_gib']:.2f} GiB (init "
              f"{sv['init_peak_gib']:.2f}); MoE layer "
              f"bf16 grouped {m['grouped_128_ms']:.3f} / "
              f"{m['grouped_8_ms']:.3f} ms at 128 / 8 tokens, dense oracle "
              f"{m['dense_oracle_128_ms']:.3f} / "
              f"{m['dense_oracle_8_ms']:.3f} ms, experts' read "
              f"{m['experts_read_bound_ms']:.3f} ms; phase "
              f"{hy['seconds']:.1f} s ({card})")
    if "mla" in result:
        ml = result["mla"]
        sv, t = ml["serve"], ml["train"]
        for name in ("healthy", "burst"):
            r = sv["runs"][name]
            print(f"[mla] {sv['config']['arch']} {name}, "
                  f"{sv['config']['n_layers']} layers: "
                  f"{r['tokens_per_s']:.2f} tok/s, p50 {r['p50_ms']} ms, "
                  f"p99 {r['p99_ms']} ms per token ({card})")
        print(f"[mla] serving peak {sv['peak_gib']:.2f} GiB (init "
              f"{sv['init_peak_gib']:.2f}); train {t['config']['n_layers']} "
              f"layers: step {t['step_s_median']:.3f} s at S_A=1, "
              f"{t['tokens_per_s']:.1f} tokens/s, sync "
              f"{t['sync_share_median']:.1%}, peak {t['peak_gib']:.2f} GiB; "
              f"phase {ml['seconds']:.1f} s ({card})")
    if "v3_train" in result:
        t = result["v3_train"]
        print(f"[v3 train] {t['config']['arch']}, {t['config']['n_layers']} "
              f"layers ({t['n_params'] / 1e9:.3f}B parameters; bf16 "
              f"accumulator and moments, int8 EF): step "
              f"{t['step_s_median']:.3f} s at S_A={t['microbatches_per_steady_step']} "
              f"(median of {t['steady_steps']}), {t['tokens_per_s']:.1f} "
              f"tokens/s of the logical batch, sync "
              f"{t['sync_share_median']:.1%}, peak {t['peak_gib']:.2f} GiB "
              f"(reckoned {t['reckoned_gib'][str(t['config']['n_layers'])]['total']:.2f}), "
              f"snapshot {t['snapshot_gib']:.2f} GiB in "
              f"{t['snapshot_s']:.2f} s, rollback {t['rollback_s']:.2f} s; "
              f"phase {t['seconds']:.1f} s ({card})")
    for key, tag in (("ssm_train", "ssm train"), ("train", "train")):
        if key not in result:
            continue
        t = result[key]
        print(f"[{tag}] {t['config']['arch']}, {t['config']['n_layers']} "
              f"layers: step {t['step_s_median']:.3f} s (median of the "
              f"replayed S_A=1 steps), {t['tokens_per_s']:.1f} tokens/s, "
              f"sync {t['sync_share_median']:.1%} of a step; set up "
              f"{t['init_s']:.1f} s ({card})")
        print(f"[{tag}] peak device memory {t['peak_gib']:.2f} GiB "
              f"allocated, {t['peak_reserved_gib']:.2f} GiB reserved, "
              f"{t['alloc_retries']} allocator retries "
              f"(readings {t['depth_readings']}); snapshot "
              f"{t['snapshot_gib']:.2f} GiB in {t['snapshot_s']:.2f} s; host "
              f"MemTotal {t['host_mem_total_gib']:.1f} GiB ({card})")
    names = list(marks)
    by_phase = {a: round(marks[b] - marks[a], 1)
                for a, b in zip(names, names[1:])}
    print(f"[time] seconds by phase: {by_phase}, the whole script "
          f"{result['seconds']:.1f} ({card})")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
