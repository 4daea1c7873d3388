"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # phases 1-2, then the profiles
    python3 chip_smoke.py --worker step --rank R --port P [--route hosts]
                                       # one process of path K (or N)

Phases:
  1. device: a CUDA card of compute capability 9.0; TF32 off.
  2. build: the kernels of bignn_tpu_torch/csrc, with nvcc, into build/.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes config2 gives it (hole-interleaved readout ids included; the
     flash-GAT backward on the dense train graph), with times for both.
  4. serving path: config2 (GIN:128 x2 -> sum -> GAT:128:4 -> mlp:64,
     the JAX package's init of seed 0) on the DrugBank stand-in, served by
     Scorer:
     encode, pair scoring, top-k, batched top-k with known partners
     excluded. Its three kernels' launch counts must be > 0, and the
     embeddings must match the same forward run with the plain versions.
  5. training path: a config2 Trainer at full width (batch 2048 positives +
     2048 negatives, Adam lr 1e-3) takes 20 steps. All four kernels' launch
     counts must be > 0; step 1's gradients must match the same step run
     with the plain versions; the loss must be finite and fall.
  6. config2-real: Trainer.fit on the in-repo real drugs for seeds 0 and 1
     through the kernels (head_dim 8); the means of the best val AUC and of
     the test AUC must reach 0.70, the JAX package's learning gate.
  7. sparse serving: config4's model in float32 (GIN:128 x2 -> sum ->
     GAT:128:4 -> mlp:64, feat 32) served by Scorer over the whole
     100,000-drug synthetic-large graph, whose outer graph is above
     dense_max_nodes and so takes GATConv's edge-list branch: build, refresh,
     pair scoring of the val positives and as many negatives, top-k, batched
     top-k with known partners excluded. segment_sum, segment_softmax,
     spmm_multihead and block_spmm must launch, flash_gat_attention must
     not (nor block_adjacency: every bucket lies above the block-dense
     threshold). Then the sparse-outer forward kernels
     against their plain versions at these shapes, and the embeddings and
     pair scores against a refresh of the same Scorer with the plain
     versions.
 7b. config4's model as configured (bf16), served by phase 7's Scorer (its
     host layouts and buckets; the model swapped): refresh, requests as
     phase 7; block_spmm, segment_sum, segment_softmax and spmm_multihead
     must launch in bf16 and no float32 form; the embeddings and pair
     scores against a plain-version refresh within SERVE_BF16_TOL of their
     largest value, and at least TOPK_AGREE of the top-20 lists shared;
     then the bf16 forward kernels (segment_softmax, spmm_multihead)
     against their plain versions at these shapes.
  8. sparse training: the full-graph Trainer with config4's model in
     float32 and config4's optimizer (Adam lr 3e-4, batch 1024 + 1024) on
     synthetic-large cut to 16,384 drugs (config4's max_drugs), 20 steps,
     then config1's GCNs (GCN:64 x2 -> GCN:64:identity, dot) 20 steps on
     the same graph. First the sparse-outer backward kernels and the
     softmax (forward in f32 and bf16, backward in bf16) against their
     plain versions at these shapes, and block_spmm (forward and backward,
     unweighted and weighted) at the largest bucket. Every sparse-outer
     kernel, forward and backward, must launch; step 1's gradients must
     match the same step with the plain versions; the loss must be finite
     and fall. Phase 8b: config4's model as configured (bf16), 20 steps
     on the same graph (step 1 by phase 9's bf16 tolerances, a_l by the
     bf16 noise of the float32 run's plain gradients: see A_L_CAP), after
     block_spmm's bf16 forms (the weighted ones off the path) against their
     plain versions at the largest bucket; block_spmm and its backward must
     launch in bf16.
     Path B, phases 7-8: a block-local bucket above BLOCK_DENSE_MAX_NODES =
     131,072 rows (the largest, 301,312 rows at 16,384 drugs) gets no dense
     blocks and its GIN and GCN layers run block_spmm; block_adjacency runs
     only for the buckets at or below the threshold.
  9. config4's own step, as get_config("config4") sets it: MinibatchTrainer
     on the whole 100,000-drug synthetic-large graph (batch 1024 + 1024,
     max_drugs 16,384, fanouts (10,), Adam lr 3e-4), bf16 compute over
     float32 parameters, device-drawn batches, int8 block counts. The build
     (host sampler with calibration, DeviceSampler, one table upload), then
     the bf16 and int8 kernel forms against their plain versions at one
     sampled batch's shapes (the softmax also in float32, off the path),
     step 1's gradients against the same step with
     the plain versions, 512 steps by train_chunk_device (64 chunks of 8):
     finite losses whose last 64-step mean lies below the first's, every
     bf16/int8 form launched and the flash-GAT not; then one chunk under
     torch.cuda.set_sync_debug_mode("warn"), counting host synchronisations.
 10. path A, streaming full graph: config2 on the DrugBank stand-in with
     molecules up to 160 atoms (load_dataset("drugbank", max_atoms=160)), so
     that no bucket is block-local and every inner conv runs
     spmm_sorted_coo. Served by Scorer (build, refresh, score_pairs; the
     embeddings and scores against a plain-version refresh), the sorted-COO
     kernels (forward and backward, unweighted at F 128, weighted at F 64)
     against their plain versions at the largest bucket, then 20 Trainer
     steps of config2 and 20 of config1 (the weighted forms), each with
     step 1's gradients against the plain versions. block_spmm and
     block_adjacency must read 0.
 11. path C, max readout: config2 with readout="max" on the DrugBank
     stand-in (block-local ids with padding runs between molecules), 20
     Trainer steps against the plain versions, then 20 with
     dtype="bfloat16" (step 1 by phase 9's bf16 tolerances, a_l by the
     float32 run's plain gradients as in phase 8b); segment_max and its
     backward segment_max_bwd (f32, then bf16) must launch, segment_sum
     must not (the backward counts its ties itself), and both are held
     against their plain versions at the largest bucket, exactly in both
     types (the backward's library call: autograd through one amax
     scatter_reduce).
 12. path D, config3 as get_config("config3") sets it (BioSNAP stand-in,
     fanouts (10, 5), batch 512 + 512, f32, host-drawn batches) on molecules
     up to 160 atoms: MinibatchTrainer with resident tables, 64 steps by
     train_chunk over prefetched batches, then resident=False (whole host
     batches uploaded each step), 8 steps. Both: step 1's gradients against
     the plain versions, finite losses, spmm_sorted_coo launched and
     block_adjacency and block_spmm at 0.
 13. path E, config4 host-sampled: get_config("config4",
     device_sample=False) (bf16, fanouts (10,), batch 1024 + 1024,
     max_drugs 16,384, Adam lr 3e-4) on synthetic-large cut to 16,384 drugs
     with molecules up to 160 atoms (no batch block-local): MinibatchTrainer
     with resident tables, step 1's gradients against the plain versions
     (bf16 tolerances; a_l against the noise of the model in float32 on the
     same batch, as in phase 8b), 16 steps by train_chunk over prefetched
     draws;
     spmm_sorted_coo and its backward must launch in bf16, the block forms
     not; then the sorted-COO kernels' bf16 forms (unweighted F 128,
     weighted F 64) against their plain versions at a sampled batch.
 14. path F, attention: GAT:128:4 x2 -> sum -> DotAttn:128:4 -> mlp:64
     (feat 64, f32, the JAX init of seed 0), 20 Trainer steps each, step 1
     against the plain versions: (i) on the DrugBank stand-in, GAT's
     block-dense and DotAttn's dense attention (plain PyTorch, as XLA in
     the JAX package); (ii) on molecules up to 160 atoms with an outer graph
     without dense masks, both edge lists (segment_softmax, spmm_multihead
     and their backwards must launch). The flash-GAT reads 0 in both.
  G. the edge-partitioned (p2) step of config5 as get_config("config5")
     sets it (GIN:128 x2 -> sum -> GAT:128:4 -> mlp:64, feat 64, f32,
     batch 2048 + 2048, Adam lr 1e-3) on the DrugBank stand-in, nothing
     cut, with its 4 graph shards on one card (make_mesh(dp=1, graph=4)
     naming the card 4 times, as the JAX package's tests use fake CPU
     devices): the plan, the unions and their upload timed; 20 steps; the
     exchange (all_to_all) on the step's own send buffers bit for bit
     against its plain version; step 1's loss and gradients against the
     same step with the plain versions and against the single-device
     Trainer (one union, prepare_device_data(max_buckets=1)) on the same
     batch and key; one step with remat=True against step 1; 20 steps with
     overlap=True, step 1 against the step without. all_to_all, the
     segment softmax, multi-head SpMM, sorted-grad gather and segment sum
     must launch, the flash-GAT not. G(ii): the outer GAT swapped for
     gcn:128 and for gin:128, 4 steps each, step 1 against the plain
     versions; the weighted sorted-COO SpMM (GCN weights; GIN's 0/1
     locality split) and its backward must launch; then 12 more steps of
     each in turns, their medians on one line, GIN then GCN; then the GIN
     outer's two split SpMMs on shard
     0 of the plan (each source order holds a hub row) against their plain
     versions, forward and backward. G(iii): config5 at graph_shards=64 on
     one card (past the 32 shards whose pointers row 9's launch takes by
     value: its pointer table on the card), 3 steps; the exchange on the
     step's own send buffers bit for bit against its plain version (timed:
     all_to_all:f32 (g64)), step 1's loss (LOSS_RTOL) and gradients and
     the later losses (K_LOSS_RTOL) against the same steps with the plain
     versions.
  H. config5-large as get_config("config5-large") sets it (config4's
     model, bf16, batch 1024 + 1024, Adam lr 3e-4) on the whole
     100,000-drug synthetic-large graph, 8 graph shards on one card, run
     after phase 7b: the plan (B, S and edge_cap as docs/P2_SCALE_r5.txt
     leg 1); the p2 embeddings of its model in float32 against phase 7's
     single-device forward of the same parameters (phase 7's tolerances:
     the partition and the halo against full propagation), and of its
     model as configured against the same p2 forward with the plain
     versions (SERVE_BF16_TOL) and, coarsely, against phase 7b's bf16
     forward (P2_EMB_TOL, or twice that forward's bf16 noise); 8 steps
     with finite losses, the launch counts and the peak device memory read
     over those steps alone; step 1's loss and gradients against the plain
     versions' (bf16 tolerances, a_l by its noise against the float32
     model's plain step); the exchange on the step's own send buffers bit
     for bit against its plain version; block_spmm:bf16 and all_to_all
     must launch; then the multi-head forward on shard 0's edges against
     its plain version.
  I. exact evaluation and the entry points. (i) Right after phase 9, its
     trainer as the 512 steps left it (config4: bf16, int8 counts,
     device-sampled): the sampled evaluate on val and test, then
     embed_all_exact (every molecule in the sampler's all-nodes chunks, one
     outer pass over the 100K-drug train graph) against the same under the
     plain versions (SERVE_BF16_TOL x max), and evaluate(exact=True) on val
     and test, printed beside the sampled ones, each AUC finite and above
     0.5; segment_sum, block_adjacency (int8), segment_softmax and
     spmm_multihead must launch in bf16/int8 and no float32 form (the
     flash-GAT reads 0); the seconds of the embed and of each evaluate, and
     the peak device memory. (ii) After path G: config3 as get_config sets
     it (BioSNAP stand-in, 1,514 drugs, molecules up to 48 atoms:
     block-local, a dense outer graph), the JAX init of seed 0: score_exact
     of a resident and of a non-resident MinibatchTrainer on the val
     positives and as many negatives, against each other and against the
     full-graph Trainer's scores on prepare_device_data (rtol 2e-4, atol
     2e-5 x max); block_adjacency (int8) and the flash-GAT must launch.
     (iii) The entry points in-process, on the first card: run.main
     on config2 (2 epochs, --run-dir under build/, --checkpoint-every 1),
     then the same argv again (it resumes, trains no epoch and reports the
     same best epoch and test AUC); its epoch-0 checkpoint in a run dir of
     its own (Adam's state loads onto the card, and the resume equals the
     run's epoch 1 bit for bit); serve.main with --topk 42,7 --k 20
     --exclude-known and with --pairs/--out on that checkpoint, equal bit
     for bit to a Scorer built by hand on its best parameters; run.main on
     config5 for 1 epoch (4 graph shards on the card). Each run's seconds,
     and path I's total beside the card's nvidia-smi line.
  J. data and feature parallelism in one process, on meshes that name the
     card several times (make_mesh(..., devices=[card] * n)), right after
     path I(i). (i) config4 as get_config sets it on dp = 2 (a batch of
     1024 + 1024 pairs a shard): step 1 against a union-batch reference
     built on phase 9's dp = 1 trainer (the keys key_at(0, 0) and
     key_at(0, 1), the union masked mean, one update, through the
     kernels): the loss within LOSS_RTOL, the gradients by _check_step1;
     then 16 steps (2 chunks of 8) on dp = 1, dp = 2, dp = 2 again and
     dp = 1: the two dp = 2 runs' losses equal to the bit, 32 batches
     sampled, segment_sum:bf16, block_adjacency:int8, segment_softmax:bf16
     and spmm_multihead:bf16 launched twice as often as on dp = 1 and no
     float32 form; the chunk medians / 8 of both, the peak memory of
     dp = 2. (ii) config2's full-graph Trainer on dp = 4 (512 pairs a
     shard), 20 steps against the Trainer without a mesh from the same
     parameters: step 1's loss within LOSS_RTOL and its parameters within
     JAX tests/test_dp.py's rtol 1e-4 / atol 1e-6 (GAT's a_l, whose
     gradient cancels, by its step-1 gradient within GRAD_TOL); the
     flash-GAT forward and backward once a step. (iii) config2's model on
     (dp, tp) = (1, 2) and (2, 2) meshes (shard_params_tp,
     tp_train_step_fn), one step against (ii)'s step 1 without a mesh
     (JAX tests/test_tp.py's rtol 5e-4 / atol 1e-5, a_l as in (ii)).
     (iv) run.main with --dp 2 on config2 (2 epochs) and on config3 with
     --exact-eval (1 epoch): seconds, best epoch, test AUC. Path J's total
     beside the card's nvidia-smi line.
  K. the multi-process p2 run, right after path I(iii): two processes on
     this one card (each its own CUDA context), started as `chip_smoke.py
     --worker step` with a gloo process group on a free local port, each
     within K_TIMEOUT (a survivor of a failed or hung pair is killed, and
     the smoke fails). (i) config5 as get_config sets it, graph 4 over the
     2 processes (make_hybrid_mesh: 2 shards each, so an exchange mixes
     local and remote pairs), dp 1, path G's first K_STEPS batches from the
     same init and keys: each process's losses against path G's within
     K_LOSS_RTOL, the step-1 gradients (summed over the processes)
     against path G's by GRAD_TOL (Adam's step would hide a gradient off
     by a constant factor), both processes' parameters equal to the bit,
     the first
     exchange across processes (CUDA IPC, all_to_all:f32:procs) equal to
     its plain version (through the process group) exactly, and
     all_to_all:f32:procs and path G's other forms launched in each
     process (the one-process all_to_all:f32 not). (iii) The same pair
     again: the same bits. (ii) `python -m bignn_tpu_torch.run --config
     config5 --epochs 1 --checkpoint-every 1 --coordinator 127.0.0.1:<port>
     --num-processes 2 --process-id i` against path I(iii)'s one-process
     run: the epoch loss within K_RUN_RTOL, test AUC within K_RUN_AUC, the
     run dir written by process 0 alone; then the same pair with --epochs
     2 resumes it, equal bit for bit to a straight 2-epoch pair (epoch
     records, result, last checkpoint). (iv) The two-process step median beside path G's;
     at the step's send buffers, the whole exchange (host ms), its kernel
     alone (device ms), its plain version, the library call
     (torch.distributed.all_to_all_single over gloo) and a barrier. Path K's
     processes share the first card wherever more are visible.
  M. one process over several cards, when torch.cuda.device_count() >= 2
     (the first M_CARDS of them; on one card a line says path M needs two
     or more cards and was not run): (iii) right after path J(i), config4
     as get_config sets it on dp = 4 over the cards (a replica, its tables
     and its draws on each card), step 1 against path J's union-batch
     reference on phase 9's trainer, then 2 x 16 steps from the same init:
     the losses equal to the bit, the replicas equal to the bit; (iv) after
     J(ii), config2's Trainer on dp = 4 and tp at M_TP over the cards
     against no mesh, as J(ii)-(iii); after path K: (i) row 9 across the
     cards (nvidia-smi topo -m and nvlink -s logged first) at config5's
     send buffers (G 4, S 432, F 132, one shard a card on four) and
     config5-large's (G 8, S 12,504, two a card), forward and backward
     equal to all_to_all_plain exactly, one launch a card each way (the
     semaphores on the cards), then timed with its plain version
     (cards_queued_ms: device ms, the calls queued behind a sleep on every
     card, the slowest card's span, after a first reading that is
     discarded; and cards_ms, the exchange as the host paces it), the
     kernel on each card (torch.profiler, its waits on the other cards
     included), and bounded per card
     (cards_bound: peer bytes over the NVLink rate in one direction,
     local bytes over 3.35 TB/s); (ii) config5's p2 step, its 4
     graph shards over the cards, K_STEPS of path G's batches from the same
     init and keys: losses within K_LOSS_RTOL of path G's, step-1 gradients
     within GRAD_TOL, the replicas' parameters and a second run equal to
     the bit, each card's device busy over one traced step and its peak
     memory; (v) run.main with --dp 4 on config4 (its graph cut to 16,384
     drugs, one epoch of 8 steps) and on config5, over every visible card;
     (vi) path K's worker as 4 processes, a card each: each process's
     losses and parameters equal to (ii)'s bit for bit.
  N. several cards a process across processes, when
     torch.cuda.device_count() >= N_CARDS (four; on fewer a line says path
     N was not run), right after path M: path K's worker as N_PROCS = 2
     processes of two cards each (init_distributed: a host's processes
     split its cards; make_hybrid_mesh: a graph shard a card; the
     exchange PeerExchange, a staging buffer a card, a launch a card):
     (i) config5 as get_config sets it, graph 4, K_STEPS of path G's
     batches: each process's losses and parameters equal to path M(ii)'s
     bit for bit, the exchange launched on both cards of each process, a
     second pair equal to the first; (ii) row 9 across processes of two
     cards at config5's send buffers (the step's own) and config5-large's
     (G 8, two shards a card, made from SEED on the card): equal to the
     plain version exactly, one launch a card (the semaphores on the
     cards: every card of every process its own), the launches' device ms
     (every process's cards at once, queued behind sleeps), each card's
     kernel (torch.profiler, its waits included), the
     whole exchange's host ms, a host barrier's (what the semaphores
     replace), the plain version's and the library call's
     (all_to_all_single on gloo), bound by cards_bound; (iii) the pair on
     the route between hosts (--route hosts), equal to (i) bit for bit;
     (iv) python -m bignn_tpu_torch.run --config config5 --epochs 1
     --coordinator ... --num-processes 2 on the default device: each
     process's mesh record names two cards, the epoch loss within
     K_RUN_RTOL and the test AUC within K_RUN_AUC of path I(iii)'s
     one-process run; the step medians beside M(ii)'s and M(vi)'s, each
     card's device busy over one traced step and its peak memory.
  O. a wide BI-GNN, right after path J(i) (and M(iii)): configs 2 and 4
     with wider layer specs (wide_config; their dtype, data and trainer as
     registered). W1: gin:300 x2 -> gat:1024:4:identity (OGB's molecular
     GIN width; GAT's PPI layers, 4 heads of 256); W2: gin:300 x2 ->
     dotattn:768:32:identity (Graphormer's base width and heads). (i) Each
     widened form against its plain version at the shapes its path gives
     it, kernel time queued behind a device sleep (queued_ms), plain,
     library and bound: rows 3/3b at config2's mask with H 4, D 256; rows
     4 and 8 at config4's sampled batch (0, 0) with W1's and W2's heads,
     bf16 and float32; row 6 at F 300 at the largest 16,384-drug bucket,
     bf16 and float32, unweighted and weighted. (ii) config2 with W1,
     O_STEPS full-graph steps (dense outer: the flash-GAT pair at head_dim
     256), step 1 against the plain versions (GRAD_TOL), the losses fall.
     (iii) config4's train_chunk_device (bf16, device-sampled, 100,000
     drugs) with W1 and with W2: step 1 against the plain versions (a GAT's
     a_l by its bf16 noise), O_CHUNKS chunks of C4_CHUNK steps, their step
     ms and peak memory; rows 8 at H.D 1024 and at 32 heads and row 4 at
     32 heads (DotAttn's softmax runs on float32 scores) must launch.
     (iv) config4's model with W1 in the full-graph Trainer on 16,384 drugs,
     O_FULL_STEPS steps: row 6 at F 300 must launch.
Each path runs with the launch counts (per kernel and element type, e.g.
segment_sum:bf16) set to 0 just before it and read just after; the kernels
line reports the sum of the paths' counts, each form's error, times (kernel,
plain version, and the one PyTorch call that computes the same function
where there is one) and its bound: the larger of its bytes over 3.35 TB/s
(row 8: and of those bytes with the rows its edges gather by id over
L2's read rate, L2_BYTES_PER_S, gathered_rows)
and its operations over their peak rates: 67 TFLOP/s for float32 outside
the tensor cores, and 495 TFLOP/s for TF32 on them, where the flash-GAT
forward's product and the backward's two run as 3xTF32 (three TF32
products each, counted three times; their elementwise work at 67, the two
times added). The softmax and segment-max backward rows time the one
launch the main path makes, on the bounds that the forward's kernel found,
once it has given autograd's result bit for bit.
all_to_all:f32 is timed at config5-large's
send buffers; a second row, all_to_all:f32 (config5), at config5's, with
the launches of paths G and G(ii), and another, all_to_all:f32 (g64), at
path G(iii)'s 64 shards with its launches; a third, all_to_all:f32:procs,
is path K's exchange across processes at config5's send buffers, with its two
processes' launches over K(i)'s steps (its ms the kernel's device time,
queued behind a sleep; its exchange_ms the whole exchange's host median,
barriers included, and barrier_ms one barrier's; bound: the bytes one
process reads and writes); a fourth, all_to_all:f32:hosts, the same for
K(v)'s route between hosts (its ms the launch that assembles the receive
buffers, its host_bytes what one exchange sends through gloo); a fifth,
all_to_all:f32:cards, path M(i)'s exchange across the cards at config5's
send buffers (its ms the device time queued behind a sleep, its
exchange_ms as the host paces it; its *_config5_large keys at
config5-large's, its *_g64 keys at path G(iii)'s send buffers, 64 shards
spread over the cards), with the
launches of M(ii) and of M(v)'s config5 run, and no library call (NCCL's
all-to-all takes a process a card); on one card its launches are 0 and
its times null; a sixth, all_to_all:f32:procs:cards, path N(ii)'s exchange
across processes of two cards (its ms the kernel's device time, queued
behind a sleep on both cards, exchange_ms and barrier_ms as the third
row's, library all_to_all_single on gloo; its *_config5_large keys at
config5-large's), with N(i)'s launches (counted under
all_to_all:f32:procs, and by card in launches_by_card); on fewer than four
cards its launches are 0 and its times null. Rows 4 and 8
have rows at their other shapes too (segment_softmax:bf16:100k,
spmm_multihead:bf16:100k, segment_softmax{,_bwd}:{f32,bf16}:16k,
spmm_multihead:f32:shard,
segment_softmax{,_bwd}:f32:config4), and row 7 at path G(ii)'s GIN split
(spmm_sorted_coo{,_bwd}:f32:hub), each with the launches of the paths
that run that shape; path O's widened forms have rows of their own
(flash_gat_attention{,_bwd}:f32:d256, spmm_multihead{,_bwd}:{bf16,f32}:w1
and :w2, segment_softmax{,_bwd}:{f32,bf16}:w2,
block_spmm{,_bwd}:{bf16,f32}{,:weighted}:f300), with the launches of the
part of path O that runs them (0 for a form off the path). The bf16
softmax forms are held to their plain
versions value by value (BF16_STEP), and so are the weighted bf16 SpMMs
(BF16_WEIGHTED); row 4's library call is torch.sparse.softmax
(softmax_library). The 100K tensors are freed before
phase 8. The
last line is {"ok": true, "device": {...}}; any failure raises, and the
script exits non-zero without it.

--profile times instead of phases 3-12: the config2 training step, the
16,384-drug sparse training step and path A's config2 step (step medians
with the kernels and with the plain versions in turns: kernels, plain,
plain, kernels; the synchronized time of each part of a step; a
torch.profiler trace of 5 steps: wall and device-busy time, device launches
per step, the device time of the busiest kernels and of the segment
kernels' bounds pass and sums), the 100K-drug Scorer
(the parts of its build, a trace of 5 refreshes), config4's step (chunk
medians in turns, the parts of a step: sample, expand, forward + loss,
backward, Adam; a trace of one chunk of 8 steps), and path D's config3 step
(the host draw, a chunk of 8 steps timed and traced), and the p2 steps
of paths H and G (step medians, peak memory, a trace of one step). It
prints no ok line.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

SEED = 0
SEGMENT_SUM_TOL = 1e-4  # f32 sums of <= 48 unit-scale rows in another order
FLASH_TOL = 1e-4  # f32 softmax sums over up to N=1704 sources, other order
BWD_TOL = 1e-4  # x max(1, max |plain|): sums over whole rows and columns
EMB_RTOL, EMB_ATOL = 2e-4, 2e-5  # atol scaled by max |embedding|
GRAD_TOL = 1e-4  # x max |plain gradient|, per parameter tensor
SPARSE_TOL = 1e-5  # x max(1, max |plain|): f32 sums over <= 232 edges
TRAIN_STEPS = 20
REAL_GATE = 0.70  # tests/test_real_data.py:66-67
# bf16 forms against their plain versions: both sum in float32 and round
# once, so they differ by one bf16 rounding (2**-8) of nearly equal sums
BF16_TOL = 1e-2  # x max(1, max |plain|)
# the bf16 softmax forms, value by value: alpha is at most 1 and ~1/161 on
# average at the 100K and 16,384-drug shapes (d_x alike), so a limit on
# max(1, max |plain|) would pass a kernel wrong on most rows. Both sides
# round a float32 value to bf16, and those float32 values nearly agree, so
# they differ by at most one bf16 step: 2**-7 of the value
BF16_STEP = 2.0 ** -7  # x (|plain| + mean |plain|), per value
# the weighted bf16 SpMMs (rows 6 and 7), value by value: kernel and plain
# version round the same bf16 weights and messages and add them in float32
# in other orders, so they round each sum to the same bf16 value except
# where the two float32 sums straddle a rounding point (about 2**-16 of the
# values for a few messages a row); a kernel that skips either rounding
# moves most sums by a quarter of a bf16 step or more, so a large share of
# the values round to another bf16 value
BF16_WEIGHTED = (BF16_STEP, True, 1e-3)  # (tol, per value, most share off)
# config4's step 1, kernels vs plain versions: the float32 gradients of a
# bf16 computation move in bf16 steps (2**-8 of the largest term); a
# rounding that flips in one run and not the other moves a summed gradient
# by a few such steps, more where its terms cancel (a_l, a_r: 3e-2 in the
# CPU rehearsal, where the two runs differ only in the order of their sums)
STEP_GRAD_TOL = 1e-1  # x max |plain gradient|, per parameter tensor
STEP_GRAD_COS = 0.99  # cosine similarity, per parameter tensor
# A GAT's a_l gradient cancels: a_l shifts the scores of all the incoming
# edges of a drug alike, which the softmax ignores except across the leaky
# ReLU's kink, so the gradient is a small sum of large terms of both signs
# and bf16 rounding moves it by more than STEP_GRAD_TOL of itself. Where a
# path gives the float32 model's plain step-1 gradients on the same batch,
# a_l (by name, and no other tensor) is held to the noise that bf16 shows
# there, noise = max|g_plain - g_f32|: kernels no further from g_f32 than
# the plain versions differ from those by at most 2 x noise. So max|d|
# within the larger of STEP_GRAD_TOL x max|g_plain| and 2 x noise, but
# never beyond A_L_CAP x max|g_plain|, so that a zeroed or sign-flipped
# a_l gradient fails; cosine at least the smaller of STEP_GRAD_COS and
# cos(g_plain, g_f32). (Where bf16 moves a_l by more than its own max, the
# cap holds: PERF.md section 6.)
A_L_CAP = 0.25
# config4's model in bf16 served (phase 7b): embeddings and pair scores
# against a plain-version refresh, x max |plain|: bf16 values rounded after
# float32 sums taken in another order, through five layers
SERVE_BF16_TOL = 2e-2
# least mean share of a top-20 list both refreshes rank (1.0 measured; bf16
# ties may swap the last places)
TOPK_AGREE = 0.9
C4_CHUNKS, C4_CHUNK = 64, 8  # 512 steps of config4 in chunks of 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# the H100's L2 read rate for rows gathered by id from an L2-resident table
# (scripts/probe_l2_rate.py, PERF.md section 6): the rate at which row 8's
# bounds count the rows its edges gather
L2_BYTES_PER_S = 8.30e12
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense
# kernels a trace lists wherever they rank: the segment kernels' bounds
# pass and the segment walk (sums and maxima)
TRACE_ALWAYS = ("find_bounds", "init_bounds", "reduce_segments")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def sync_all() -> None:
    """Wait for every visible card: a step over several cards ends on
    each."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(num_bytes: float, flops: float = 0.0,
             tf32_flops: float = 0.0,
             gathered: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rates, whichever is larger. ``flops`` run in
    float32 outside the tensor cores, ``tf32_flops`` on the tensor cores in
    TF32 (a 3xTF32 product counts three times); their times add.
    ``gathered``: bytes of rows read again by id (row 8's v or g row an
    edge), which L2 serves: the bytes are then bound by the larger of
    ``num_bytes`` over the memory rate and ``num_bytes + gathered`` over
    L2's read rate (``L2_BYTES_PER_S``)."""
    by_bytes = max(num_bytes / HBM_BYTES_PER_S,
                   (num_bytes + gathered) / L2_BYTES_PER_S
                   if gathered else 0.0) * 1e3
    by_ops = (flops / F32_FLOPS + tf32_flops / TF32_FLOPS) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def gathered_rows(dst: torch.Tensor, n_out: int, width: int,
                  dtype: torch.dtype) -> int:
    """Bytes of the rows row 8 gathers by edge: a row of ``width`` values
    of ``dtype`` for each edge with a destination in ``[0, n_out)`` (the
    forward's v rows, the backward's g rows; padding edges read none)."""
    live = int(((dst >= 0) & (dst < n_out)).sum())
    return live * width * torch.empty((), dtype=dtype).element_size()


def flash_fwd_flops(n: int, heads: int, head_dim: int) -> tuple[int, int]:
    """The flash-GAT forward's operations as ``bound_ms`` takes them: per
    (d, s, h) pair, 4 in float32 (the score, its LeakyReLU, the exp, the
    multiplicity) and the D-wide multiply-add p v, run as 3xTF32 on the
    tensor cores (three TF32 products)."""
    pairs = n * n * heads
    return 4 * pairs, 3 * 2 * head_dim * pairs


def flash_bwd_flops(n: int, heads: int, head_dim: int) -> tuple[int, int]:
    """The flash-GAT backward's operations as ``bound_ms`` takes them: per
    (d, s, h) pair, 6 in float32 (the score, its mask and LeakyReLU, the
    exp, d_z) and the two D-wide products g.v and alpha g, run as 3xTF32
    on the tensor cores (three TF32 products each)."""
    pairs = n * n * heads
    return 6 * pairs, 3 * 4 * head_dim * pairs


def record(results: dict, name: str, err: float, tol: float, kernel, plain,
           num_bytes: float, flops: float = 0.0, library=None,
           reps: int = 10, tf32_flops: float = 0.0,
           queued: bool = False, gathered: float = 0.0) -> None:
    """Time a kernel, its plain version and (where one exists) the one
    PyTorch call computing the same function; keep them with the error and
    the bound (``bound_ms``) under ``name``. ``queued``: the kernel's calls
    queued behind a device sleep (``queued_ms``)."""
    ms = queued_ms(kernel) if queued else cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, reps)
    lib_ms = cuda_ms(library, reps) if library is not None else None
    b, by = bound_ms(num_bytes, flops, tf32_flops, gathered)
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, tol=tol,
                         bound_ms=b, bound_by=by, library_ms=lib_ms)
    lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}), kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, library {lib}, bound {b:.4f} ms "
        f"({by})")


def index_add_call(data: torch.Tensor, ids: torch.Tensor, rows: int):
    """The one PyTorch call that sums ``data`` rows by ``ids`` (ids of
    dropped rows equal ``rows``), in the data's type."""
    out = data.new_zeros((rows + 1,) + tuple(data.shape[1:]))
    return lambda: out.zero_().index_add_(0, ids, data)


def multihead_library(src: torch.Tensor, dst: torch.Tensor,
                      alpha: torch.Tensor, n: int, v: torch.Tensor,
                      g: torch.Tensor | None = None):
    """The PyTorch calls that compute ``spmm_multihead`` (``g`` None) or its
    backward, over the ``[n H, N H]`` CSR matrix A (N the rows of ``v``)
    with the entries ``(d H + h, s H + h) = alpha[e, h]`` of the real edges
    (built untimed, duplicates summed): forward ``torch.sparse.mm(A, v)``
    with v viewed as ``[N H, D]``; backward two calls, ``torch.sparse.mm``
    of the transposed matrix with the cotangent for ``d_v`` and
    ``torch.sparse.sampled_addmm`` on A's pattern for ``d_alpha``. None
    where a call refuses the type."""
    num_src, heads, d = v.shape
    keep = dst < n
    h = torch.arange(heads, device=dst.device)
    rows = (dst[keep].long()[:, None] * heads + h).reshape(-1)
    cols = (src[keep].long()[:, None] * heads + h).reshape(-1)
    vals = alpha[keep].reshape(-1)

    def csr(r, c, size):
        return torch.sparse_coo_tensor(torch.stack([r, c]), vals,
                                       size).coalesce().to_sparse_csr()

    v2 = v.reshape(num_src * heads, d)
    try:
        a = csr(rows, cols, (n * heads, num_src * heads))
        if g is None:
            def call():
                return torch.sparse.mm(a, v2)
        else:
            at = csr(cols, rows, (num_src * heads, n * heads))
            g2 = g.reshape(n * heads, d)

            def call():
                return (torch.sparse.mm(at, g2),
                        torch.sparse.sampled_addmm(a, g2, v2.t(), beta=0.0))
        call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  spmm_multihead library call refuses {v.dtype}: "
            f"{str(exc).splitlines()[0]}")
        return None
    return call


def softmax_library(x: torch.Tensor, ids: torch.Tensor, n: int,
                    g: torch.Tensor | None = None):
    """The one PyTorch call that computes ``segment_softmax(x, ids, n)``
    (``g`` None) or ``segment_softmax_bwd(x, g, ids, n)`` (x then alpha):
    ``torch.sparse.softmax`` over dim 1 of the ``[n, E, H]`` COO tensor with
    the entries ``(ids[e], e, :) = x[e]`` of the rows whose id is kept (an
    entry not stored counts as -inf, so a row of it is a segment), or
    ``torch._sparse_softmax_backward_data``, the call its autograd makes, on
    alpha and the cotangent at those entries; built untimed, held once to
    the plain version on the kept rows. None where it refuses the type."""
    from bignn_tpu_torch import ops

    keep = (ids >= 0) & (ids < n)
    idx = torch.stack([ids[keep].long(),
                       torch.arange(len(ids), device=ids.device)[keep]])

    def coo(v):
        return torch.sparse_coo_tensor(idx, v[keep], (n, *v.shape)).coalesce()

    try:
        a = coo(x)
        if g is None:
            def call():
                return torch.sparse.softmax(a, 1)
            want = ops.segment_softmax_plain(x, ids, n)
        else:
            sg = coo(g)

            def call():
                return torch._sparse_softmax_backward_data(sg, a, 1, a)
            want = ops.segment_softmax_bwd_plain(x, g, ids, n)
        out = call()
        want = want[out.indices()[1]].float()
        err = (out.values().float() - want).abs().max().item()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  segment_softmax library call refuses {x.dtype}: "
            f"{str(exc).splitlines()[0]}")
        return None
    what = "torch.sparse.softmax" + ("" if g is None else " backward")
    log(f"  {what} ({x.dtype}) against the plain version: max_abs_err "
        f"{err:.3e}")
    if not err <= BF16_TOL * max(1.0, want.abs().max().item()):
        log(f"  {what} computes another function here: no library time")
        return None
    return call


def softmax_bwd_autograd(scores: torch.Tensor, g: torch.Tensor,
                         ids: torch.Tensor, n: int) -> tuple:
    """(call, alpha): ``torch.autograd.grad`` of ``g`` through
    ``ops.segment_softmax`` of ``scores``, the softmax backward as the main
    path runs it (the forward's kernel hands the backward its bounds on
    ``ids``: one launch), and the forward's alpha."""
    from bignn_tpu_torch import ops

    x = scores.detach().requires_grad_()
    with torch.enable_grad():  # the callers' phases run under no_grad
        alpha = ops.segment_softmax(x, ids, n)
    return (lambda: torch.autograd.grad(alpha, x, g, retain_graph=True)[0],
            alpha.detach())


def softmax_bwd_calls(scores: torch.Tensor, g: torch.Tensor,
                      ids: torch.Tensor, n: int) -> tuple:
    """(kernel call, plain call, alpha, bytes) of the softmax backward rows:
    the one launch the main path makes, on the bounds that the forward's
    kernel finds on ``ids``, first held bit for bit to the path's own call
    (``softmax_bwd_autograd``) and then timed alone (the autograd engine's
    host cost is not the kernel's). The plain call takes the forward
    kernel's alpha; the bytes are alpha, g, the ids and the bounds (2 int32
    a segment)."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.ops import segment

    path, a = softmax_bwd_autograd(scores, g, ids, n)
    _, bounds = segment._segment_softmax_fwd_cuda(scores, ids, n)

    def kernel():
        return segment._segment_softmax_bwd_cuda(a, g, ids, n, bounds,
                                                 saved=True)

    if not torch.equal(kernel(), path()):
        raise AssertionError("segment_softmax_bwd: the launch on the "
                             "forward kernel's bounds is not autograd's")
    return (kernel, lambda: ops.segment_softmax_bwd_plain(a, g, ids, n), a,
            nbytes(a, g, ids) + 8 * n)


def index_put_call(src: torch.Tensor, dst: torch.Tensor, n: int,
                   dtype: torch.dtype, weight: torch.Tensor | None = None):
    """The one PyTorch call that builds the blocks ``[n/128, 128, 128]`` in
    ``dtype``: ``index_put_`` with accumulation of ones (counts) or of the
    edges' ``weight`` at the flat indices of the edges inside their block,
    computed outside the timing."""
    s, d = src.long(), dst.long()
    blk = torch.div(d, 128, rounding_mode="floor")
    s_l = s - blk * 128
    keep = (d < n) & (s_l >= 0) & (s_l < 128)
    flat = (blk * 128 * 128 + (d - blk * 128) * 128 + s_l)[keep]
    vals = (torch.ones(flat.shape, dtype=dtype, device=src.device)
            if weight is None else weight[keep].to(dtype))
    out = torch.zeros(n * 128, dtype=dtype, device=src.device)
    return lambda: out.zero_().index_put_((flat,), vals, accumulate=True)


def check_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}, capability {cap}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"numpy {np.__version__}")
    log(card_line())
    return torch.device("cuda", 0)


def build_kernels() -> None:
    from bignn_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())


def compare_kernels(dev, ds, bucketing, outer_host) -> dict:
    """Each kernel against its plain version at the main path's shapes;
    returns name -> its error, times and bound (``record``)."""
    from bignn_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # segment_sum: the readout of every bucket, real hole-interleaved ids
    seg_cases = []
    for i, b in enumerate(bucketing.batches):
        ids = torch.as_tensor(b.graph_ids, device=dev)
        is_valid = b.graph_ids < b.num_graphs
        holes = int(np.sum(np.diff(is_valid.astype(np.int8)) == 1))
        log(f"  bucket {i}: node_cap {b.node_cap}, edge_cap {b.edge_cap}, "
            f"{b.num_graphs} molecules, {holes} padding runs between them, "
            f"ids sorted: {bool(np.all(np.diff(b.graph_ids) >= 0))}, valid "
            f"ids sorted: {bool(np.all(np.diff(b.graph_ids[is_valid]) >= 0))}")
        x = torch.randn(b.node_cap, 128, device=dev, generator=gen)
        seg_cases.append((x, ids, b.num_graphs))
    err = 0.0
    for x, ids, s in seg_cases:
        got = ops.segment_sum(x, ids, s)
        want = ops.segment_sum_plain(x, ids, s)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
    if not err <= SEGMENT_SUM_TOL:
        raise AssertionError(f"segment_sum: error {err}")
    libs = [index_add_call(x, ids, s) for x, ids, s in seg_cases]
    record(results, "segment_sum:f32", err, SEGMENT_SUM_TOL,
           lambda: [ops.segment_sum(*c) for c in seg_cases],
           lambda: [ops.segment_sum_plain(*c) for c in seg_cases],
           sum(nbytes(x, ids) + s * 128 * 4 for x, ids, s in seg_cases),
           library=lambda: [f() for f in libs], reps=20)

    # block_adjacency: the count adjacency of every bucket (exact), and the
    # weighted form once
    adj_cases = [
        (torch.as_tensor(b.edge_src, device=dev),
         torch.as_tensor(b.edge_dst, device=dev),
         torch.as_tensor(b.block_estarts, device=dev), b.node_cap,
         torch.as_tensor(b.edge_weight, device=dev))
        for b in bucketing.batches]
    err = 0.0
    for src, dst, est, n, w in adj_cases:
        got = ops.block_adjacency(src, dst, None, est, n)
        want = ops.block_adjacency_plain(src, dst, None, n)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        wgot = ops.block_adjacency(src, dst, w, est, n)
        wwant = ops.block_adjacency_plain(src, dst, w, n)
        torch.cuda.synchronize()
        werr = (wgot - wwant).abs().max().item()
        if werr > 1e-6:
            raise AssertionError(f"weighted block_adjacency error {werr}")
    if err != 0.0:
        raise AssertionError(f"block_adjacency: count error {err}")
    libs = [index_put_call(s, d, n, torch.float32)
            for s, d, e, n, _ in adj_cases]
    record(results, "block_adjacency:f32", err, 0.0,
           lambda: [ops.block_adjacency(s, d, None, e, n)
                    for s, d, e, n, _ in adj_cases],
           lambda: [ops.block_adjacency_plain(s, d, None, n)
                    for s, d, e, n, _ in adj_cases],
           sum(nbytes(s, d, e) + n * 128 * 4 for s, d, e, n, _ in adj_cases),
           library=lambda: [f() for f in libs], reps=20)

    # flash_gat_attention: the dense outer graph's mask, N=1704, H=4, D=32
    n, heads, head_dim = ds.num_drugs, 4, 32
    cnt = torch.as_tensor(outer_host.dense_cnt, device=dev)
    sl = torch.randn(n, heads, device=dev, generator=gen)
    sr = torch.randn(n, heads, device=dev, generator=gen)
    v = torch.randn(n, heads, head_dim, device=dev, generator=gen)
    out, lse = ops.flash_gat_attention(sl, sr, v, cnt)
    out_p, lse_p = ops.flash_gat_attention_plain(sl, sr, v, cnt)
    torch.cuda.synchronize()
    err = max((out - out_p).abs().max().item(),
              (lse - lse_p).abs().max().item())
    if not err <= FLASH_TOL:
        raise AssertionError(f"flash_gat_attention: error {err}")
    # per (d, s, h): a score, an exp (float32) and the D-wide multiply-add
    # on the tensor cores in 3xTF32
    flops, tf32_flops = flash_fwd_flops(n, heads, head_dim)
    record(results, "flash_gat_attention:f32", err, FLASH_TOL,
           lambda: ops.flash_gat_attention(sl, sr, v, cnt),
           lambda: ops.flash_gat_attention_plain(sl, sr, v, cnt),
           nbytes(sl, sr, v, cnt, out, lse), flops, reps=20,
           tf32_flops=tf32_flops)

    # flash_gat_attention_bwd: the same mask, lse and out from the forward
    # kernel, a seeded cotangent; each output held to BWD_TOL x its scale
    g = torch.randn(n, heads, head_dim, device=dev, generator=gen)
    args = (sl, sr, v, cnt, lse, out, g)
    got = ops.flash_gat_attention_bwd(*args)
    want = ops.flash_gat_attention_bwd_plain(*args)
    err = _check_close("flash_gat_attention_bwd", got, want, BWD_TOL)
    # the scores and exps again (float32), g.v and the d_v multiply-add:
    # 2 x D-wide, on the tensor cores in 3xTF32
    flops, tf32_flops = flash_bwd_flops(n, heads, head_dim)
    record(results, "flash_gat_attention_bwd:f32", err, BWD_TOL,
           lambda: ops.flash_gat_attention_bwd(*args),
           lambda: ops.flash_gat_attention_bwd_plain(*args),
           nbytes(*args, *got), flops, reps=20, tf32_flops=tf32_flops)
    return results


def negatives(ds, pos: np.ndarray) -> np.ndarray:
    """One corrupted partner per positive, as MinibatchTrainer.evaluate
    draws them."""
    rng = np.random.default_rng(1234)
    right = rng.random(len(pos)) < 0.5
    rand = rng.integers(0, ds.num_drugs, len(pos))
    return np.stack([np.where(right, pos[:, 0], rand),
                     np.where(right, rand, pos[:, 1])], axis=1)


def plain_ops():
    """The plain versions in place of the kernels, for a reference run
    (every element type: the plain versions take them all)."""
    from bignn_tpu_torch import ops

    return mock.patch.multiple(
        ops,
        segment_sum=ops.segment_sum_plain,
        block_adjacency=lambda s, d, w, e, n, out_dtype=torch.float32: (
            ops.block_adjacency_plain(s, d, w, n, out_dtype)),
        flash_gat_attention=ops.flash_gat_attention_plain,
        segment_softmax=ops.segment_softmax_plain,
        spmm_multihead=ops.spmm_multihead_plain,
        gather_rows_sorted_grad=ops.gather_rows_sorted_grad_plain,
        spmm_sorted_coo=ops.spmm_sorted_coo_plain,
        segment_max=ops.segment_max_plain,
        all_to_all=ops.all_to_all_plain)


# kernel form (wrapper:element type) -> (CUDA source, the TPU kernel it
# replaces)
KERNELS = {
    "segment_sum:f32": ("bignn_tpu_torch/csrc/segment_sum.cu",
                        "bignn_tpu/ops/pallas/segment.py:58"),
    "segment_sum:bf16": ("bignn_tpu_torch/csrc/segment_sum.cu",
                         "bignn_tpu/ops/pallas/segment.py:58"),
    "block_adjacency:f32": ("bignn_tpu_torch/csrc/block_adj.cu",
                            "bignn_tpu/ops/pallas/block_adj.py:49"),
    "block_adjacency:int8": ("bignn_tpu_torch/csrc/block_adj.cu",
                             "bignn_tpu/ops/pallas/block_adj.py:49"),
    "flash_gat_attention:f32": ("bignn_tpu_torch/csrc/flash_gat.cu",
                                "bignn_tpu/ops/pallas/flash_gat.py:65"),
    "flash_gat_attention_bwd:f32": ("bignn_tpu_torch/csrc/flash_gat_bwd.cu",
                                    "bignn_tpu/ops/pallas/flash_gat.py:85"),
    "segment_softmax:f32": ("bignn_tpu_torch/csrc/segment_softmax.cu",
                            "bignn_tpu/ops/pallas/segment.py:307"),
    "segment_softmax:bf16": ("bignn_tpu_torch/csrc/segment_softmax.cu",
                             "bignn_tpu/ops/pallas/segment.py:307"),
    "segment_softmax_bwd:f32": ("bignn_tpu_torch/csrc/segment_softmax.cu",
                                "bignn_tpu/ops/pallas/segment.py:293"),
    "segment_softmax_bwd:bf16": ("bignn_tpu_torch/csrc/segment_softmax.cu",
                                 "bignn_tpu/ops/pallas/segment.py:293"),
    "spmm_multihead:f32": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                           "bignn_tpu/ops/multihead.py:76"),
    "spmm_multihead:bf16": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                            "bignn_tpu/ops/multihead.py:76"),
    "spmm_multihead_bwd:f32": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                               "bignn_tpu/ops/multihead.py:91"),
    "spmm_multihead_bwd:bf16": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                                "bignn_tpu/ops/multihead.py:91"),
    "gather_rows_sorted_grad_bwd:f32": ("bignn_tpu_torch/csrc/segment_sum.cu",
                                        "bignn_tpu/ops/gather.py:72"),
    "gather_rows_sorted_grad_bwd:bf16": (
        "bignn_tpu_torch/csrc/segment_sum.cu", "bignn_tpu/ops/gather.py:72"),
    "spmm_sorted_coo:f32": ("bignn_tpu_torch/csrc/spmm.cu",
                            "bignn_tpu/ops/pallas/spmm.py:52"),
    "spmm_sorted_coo:f32:weighted": ("bignn_tpu_torch/csrc/spmm.cu",
                                     "bignn_tpu/ops/pallas/spmm.py:52"),
    "spmm_sorted_coo_bwd:f32": ("bignn_tpu_torch/csrc/spmm.cu",
                                "bignn_tpu/ops/pallas/spmm.py:65"),
    "spmm_sorted_coo_bwd:f32:weighted": ("bignn_tpu_torch/csrc/spmm.cu",
                                         "bignn_tpu/ops/pallas/spmm.py:65"),
    "block_spmm:f32": ("bignn_tpu_torch/csrc/block_spmm.cu",
                       "bignn_tpu/ops/pallas/block_spmm.py:57"),
    "block_spmm:f32:weighted": ("bignn_tpu_torch/csrc/block_spmm.cu",
                                "bignn_tpu/ops/pallas/block_spmm.py:57"),
    "block_spmm_bwd:f32": ("bignn_tpu_torch/csrc/block_spmm.cu",
                           "bignn_tpu/ops/pallas/block_spmm.py:57"),
    "block_spmm_bwd:f32:weighted": ("bignn_tpu_torch/csrc/block_spmm.cu",
                                    "bignn_tpu/ops/pallas/block_spmm.py:57"),
    "segment_max:f32": ("bignn_tpu_torch/csrc/segment_max.cu",
                        "bignn_tpu/ops/pallas/segment.py:339"),
    "segment_max:bf16": ("bignn_tpu_torch/csrc/segment_max.cu",
                         "bignn_tpu/ops/pallas/segment.py:339"),
    "segment_max_bwd:f32": ("bignn_tpu_torch/csrc/segment_max.cu",
                            "bignn_tpu/ops/pallas/segment.py:499"),
    "segment_max_bwd:bf16": ("bignn_tpu_torch/csrc/segment_max.cu",
                             "bignn_tpu/ops/pallas/segment.py:499"),
    **{f"spmm_sorted_coo:bf16{w}": ("bignn_tpu_torch/csrc/spmm.cu",
                                    "bignn_tpu/ops/pallas/spmm.py:52")
       for w in ("", ":weighted")},
    **{f"spmm_sorted_coo_bwd:bf16{w}": ("bignn_tpu_torch/csrc/spmm.cu",
                                        "bignn_tpu/ops/pallas/spmm.py:65")
       for w in ("", ":weighted")},
    **{f"block_spmm{b}:bf16{w}": ("bignn_tpu_torch/csrc/block_spmm.cu",
                                  "bignn_tpu/ops/pallas/block_spmm.py:57")
       for b in ("", "_bwd") for w in ("", ":weighted")},
    # rows wider than 256 columns (path O(iv)'s F 300): the tiled forms
    **{f"block_spmm{b}:{t}{w}:tiled": ("bignn_tpu_torch/csrc/block_spmm.cu",
                                       "bignn_tpu/ops/pallas/block_spmm.py:57")
       for b in ("", "_bwd") for t in ("f32", "bf16")
       for w in ("", ":weighted")},
    "all_to_all:f32": ("bignn_tpu_torch/csrc/all_to_all.cu",
                       "bignn_tpu/ops/pallas/collectives.py:43"),
    # the exchange across processes (path K), counted in its processes:
    # through CUDA IPC (K(i)), and the route between hosts (K(v))
    "all_to_all:f32:procs": ("bignn_tpu_torch/csrc/all_to_all.cu",
                             "bignn_tpu/ops/pallas/collectives.py:43"),
    "all_to_all:f32:hosts": ("bignn_tpu_torch/csrc/all_to_all.cu",
                             "bignn_tpu/ops/pallas/collectives.py:43"),
    # across the cards of one process (path M)
    "all_to_all:f32:cards": ("bignn_tpu_torch/csrc/all_to_all.cu",
                             "bignn_tpu/ops/pallas/collectives.py:43"),
}
# the forms a layout that is not block-local must not launch
BLOCK_FORMS = ("block_adjacency:f32", "block_adjacency:int8",
               *(f"block_spmm{b}:{t}{w}{c}" for b in ("", "_bwd")
                 for t in ("f32", "bf16") for w in ("", ":weighted")
                 for c in ("", ":tiled")))
# the float32 forms, which a bf16 model's forward must not launch
F32_FORMS = tuple(f for f in KERNELS if f.split(":")[1] == "f32")


def reset_counts() -> None:
    from bignn_tpu_torch import ops

    for form in KERNELS:
        op = getattr(ops, form.split(":", 1)[0])
        op.launches = 0
        op.launches_by_dtype.clear()
    ops.all_to_all.launches_by_device.clear()


def read_counts() -> dict:
    from bignn_tpu_torch import ops

    counts = {}
    for form in KERNELS:
        name, key = form.split(":", 1)
        counts[form] = getattr(ops, name).launches_by_dtype.get(key, 0)
    return counts


def require_launched(launches: dict, forms, where: str) -> None:
    for form in forms:
        if launches[form] <= 0:
            raise AssertionError(f"{form} was not launched {where}")


def require_idle(launches: dict, forms, where: str) -> None:
    for form in forms:
        if launches[form] != 0:
            raise AssertionError(f"{form} was launched {where}")


def run_serving(dev, ds) -> dict:
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.serve import Scorer

    cfg = get_config("config2")
    model = BiGNN(cfg.model, seed=SEED)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    reset_counts()
    t0 = time.perf_counter()
    scorer = Scorer(model, ds, params, device=dev)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scorer.refresh(params)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    emb = scorer.embeddings
    log(f"  Scorer build (host layout + upload + device encode): "
        f"{encode_s:.4f} s; refresh (device encode alone): {refresh_s:.4f} s")
    if tuple(emb.shape) != (ds.num_drugs, 128) or not torch.isfinite(emb).all():
        raise AssertionError(f"bad embeddings {tuple(emb.shape)}")

    pos = ds.split_edges("val").astype(np.int64)
    pairs = np.concatenate([pos, negatives(ds, pos)])
    scorer.score_pairs(pairs)  # warm-up: first-use allocations
    t0 = time.perf_counter()
    scores = scorer.score_pairs(pairs)
    pairs_ms = (time.perf_counter() - t0) * 1e3
    if scores.shape != (len(pairs),) or not np.isfinite(scores).all():
        raise AssertionError("bad pair scores")
    log(f"  score_pairs: {len(pairs)} pairs in {pairs_ms:.3f} ms")

    drugs = np.arange(8) * 211 % ds.num_drugs
    scorer.top_k(int(drugs[0]), k=20)  # warm-up
    top_ms = []
    for d in drugs:
        t0 = time.perf_counter()
        ids, s = scorer.top_k(int(d), k=20)
        top_ms.append((time.perf_counter() - t0) * 1e3)
        if d in ids or not np.isfinite(s).all() or np.any(np.diff(s) > 0):
            raise AssertionError(f"bad top_k for drug {d}")
    log(f"  top_k(k=20): median {np.median(top_ms):.3f} ms over "
        f"{len(drugs)} queries (min {min(top_ms):.3f}, max {max(top_ms):.3f})")

    batch = np.arange(64) * 26 % ds.num_drugs
    scorer.top_k_batch(batch, k=20, exclude_known=True)  # warm-up
    t0 = time.perf_counter()
    cand, s = scorer.top_k_batch(batch, k=20, exclude_known=True)
    batch_ms = (time.perf_counter() - t0) * 1e3
    known = np.concatenate([ds.split_edges("train"), ds.split_edges("val")])
    for row, d in enumerate(batch):
        partners = set(known[known[:, 0] == d, 1]) | set(
            known[known[:, 1] == d, 0]) | {d}
        if partners & set(cand[row].tolist()) or not np.isfinite(s[row]).all():
            raise AssertionError(f"known partner ranked for drug {d}")
    log(f"  top_k_batch(64 drugs, k=20, exclude_known): {batch_ms:.3f} ms "
        f"({batch_ms / 64:.4f} ms per query)")

    launches = read_counts()
    log(f"  launches on the serving path: {launches}")
    require_launched(launches, ("segment_sum:f32", "block_adjacency:f32",
                                "flash_gat_attention:f32"), "on the main path")

    # the same forward with the plain versions on the card
    with plain_ops():
        ref = Scorer(model, ds, params, device=dev)
    scale = ref.embeddings.abs().max().item()
    diff = (emb - ref.embeddings).abs()
    bound = EMB_ATOL * scale + EMB_RTOL * ref.embeddings.abs()
    log(f"  embeddings vs plain forward: max_abs_err {diff.max().item():.3e} "
        f"(max |emb| {scale:.3e}; rtol {EMB_RTOL}, atol {EMB_ATOL} x max)")
    if not bool((diff <= bound).all()):
        raise AssertionError("embeddings disagree with the plain forward")
    ref_scores = ref.score_pairs(pairs)
    if not np.allclose(scores, ref_scores, rtol=EMB_RTOL,
                       atol=EMB_ATOL * np.abs(ref_scores).max()):
        raise AssertionError("pair scores disagree with the plain forward")
    return launches


def _timed_steps(trainer, batches, label: str, secs: list | None = None,
                 step1: dict | None = None):
    """Run ``batches`` as steps 0.. of epoch 0, each timed on the host clock
    up to a synchronize; logs the times (and appends them to ``secs``; the
    parameters after step 1 go into ``step1``), returns (losses, step-1
    grads)."""
    losses, secs = [], [] if secs is None else secs
    for i, (pairs, mask) in enumerate(batches):
        t0 = time.perf_counter()
        loss = trainer.train_step(pairs, mask, 0, i)
        sync_all()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if i == 0:
            grads = {k: p.grad.clone()
                     for k, p in trainer.model.named_parameters()}
            if step1 is not None:
                step1.update(trainer.params())
    log(f"  {label}: median step {np.median(secs) * 1e3:.3f} ms over "
        f"{len(secs)} steps (first {secs[0] * 1e3:.3f}, min "
        f"{min(secs) * 1e3:.3f}, max {max(secs) * 1e3:.3f})")
    return losses, grads


def _epoch_batches(data, train_cfg):
    """The first TRAIN_STEPS positive batches of epoch 0."""
    from bignn_tpu_torch.data.sampler import EdgeMinibatchSampler

    sampler = EdgeMinibatchSampler(data.train_pairs, train_cfg.batch_size,
                                   train_cfg.seed)
    return [b for _, b in zip(range(TRAIN_STEPS), sampler.epoch(0))]


def run_training(dev, ds) -> dict:
    """config2 training at full width through the kernels, and the same
    steps with the plain versions."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import prepare_device_data

    cfg = get_config("config2")
    data = prepare_device_data(ds)
    return _train_and_check(dev, cfg.model, data, cfg.train,
                            _epoch_batches(data, cfg.train),
                            ("segment_sum:f32", "block_adjacency:f32",
                             "flash_gat_attention:f32",
                             "flash_gat_attention_bwd:f32"))[0]


def _train_and_check(dev, model_cfg, data, train_cfg, batches,
                     must_launch, f32_plain: dict | None = None):
    """TRAIN_STEPS steps of a Trainer through the kernels from the JAX init
    of SEED (the launch counts read just after), then the same steps with
    the plain versions; checks launches, step-1 gradients (``_check_step1``;
    ``f32_plain``: the float32 model's plain gradients on these batches)
    and losses. Returns the counts and the plain step-1 gradients."""
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    reset_counts()
    trainer = Trainer(BiGNN(model_cfg), data, train_cfg, device=dev)
    params0, _ = trainer.init(SEED)
    losses, grads = _timed_steps(trainer, batches, "kernels")
    launches = read_counts()
    log(f"  launches on the training path: {launches}")
    require_launched(launches, must_launch, "in training")
    _check_learning(losses, grads)

    with plain_ops():
        plain = Trainer(BiGNN(model_cfg), data, train_cfg, device=dev)
        plain.model.load_state_dict(params0)
        plain_losses, plain_grads = _timed_steps(plain, batches,
                                                 "plain versions")
    log(f"  plain losses step 1 / {len(batches)}: {plain_losses[0]:.5f} / "
        f"{plain_losses[-1]:.5f}")
    _check_step1(grads, plain_grads, losses[0], plain_losses[0],
                 trainer.model.compute_dtype, f32_plain)
    metrics = trainer.evaluate(split="val")
    log(f"  after {len(batches)} steps: val AUC {metrics['val_auc']:.4f}, "
        f"AP {metrics['val_ap']:.4f}")
    return launches, plain_grads


def _check_learning(losses: list, grads: dict, fall: bool = True) -> None:
    """Finite losses (falling over the run unless not ``fall``), finite
    step-1 gradients, none zero in the first conv layers."""
    log("  losses: " + " ".join(f"{x:.5f}" for x in losses))
    for name, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient of {name}")
        if name.startswith(("inner.0.", "inner.1.", "outer.0.")) and not (
                g.abs().max().item() > 0):
            raise AssertionError(f"zero gradient of {name}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss")
    if fall and not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")


def _check_step1(grads: dict, plain: dict, loss_k: float, loss_p: float,
                 dtype: torch.dtype, f32_plain: dict | None = None) -> None:
    """Step-1 gradients through the kernels against the plain versions',
    per parameter tensor. float32: max|d| / max|g_plain| within GRAD_TOL.
    bf16: within STEP_GRAD_TOL, cosine at least STEP_GRAD_COS, losses
    within 1e-2; with ``f32_plain`` (the float32 model's plain gradients on
    the same batch) a GAT's a_l by its bf16 noise instead (A_L_CAP)."""
    def cos(a, b):
        return torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()

    bf16 = dtype == torch.bfloat16
    tol = STEP_GRAD_TOL if bf16 else GRAD_TOL
    bad = []
    worst_err, worst_cos = 0.0, 1.0
    for name, g in grads.items():
        ref = plain[name]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient of {name}")
        scale = ref.abs().max().item()
        err = (g - ref).abs().max().item()
        line = (f"  step-1 grad {name}: max_abs_err {err:.3e}, max |plain| "
                f"{scale:.3e}")
        if not bf16:
            worst_err = max(worst_err, err / scale if scale > 0 else err)
            log(line)
            continue
        c = cos(g, ref)
        line += f", cosine {c:.6f}"
        limit, least = tol * scale, STEP_GRAD_COS
        noisy = f32_plain is not None and name.endswith(".a_l")
        if noisy:
            noise = (ref - f32_plain[name]).abs().max().item()
            noise_cos = cos(ref, f32_plain[name])
            limit = min(max(limit, 2 * noise), A_L_CAP * scale)
            least = min(least, noise_cos)
            line += (f" (a_l: bf16 noise, plain bf16 vs f32: max|d| "
                     f"{noise:.3e}, cosine {noise_cos:.6f}; limit "
                     f"{limit:.3e}, least cosine {least:.6f}; kernels vs "
                     f"f32: max|d| "
                     f"{(g - f32_plain[name]).abs().max().item():.3e}, "
                     f"cosine {cos(g, f32_plain[name]):.6f})")
        if not (err <= limit and c >= least):
            bad.append(f"{name}: max|d| {err:.3e} (limit {limit:.3e}), "
                       f"cosine {c:.6f} (least {least:.6f})")
        elif not noisy:
            worst_err = max(worst_err, err / scale if scale > 0 else err)
            worst_cos = min(worst_cos, c)
        log(line)
    if not bf16:
        log(f"  step-1 gradients vs plain: worst max|d| / max|g_plain| "
            f"{worst_err:.3e} (bound {GRAD_TOL:g})")
        if not worst_err <= GRAD_TOL:
            raise AssertionError(
                f"step-1 gradients off the plain run: {worst_err}")
        return
    log(f"  step-1 loss kernels {loss_k:.6f} / plain {loss_p:.6f}; worst "
        f"max|d| / max|g_plain| {worst_err:.3e} (bound {STEP_GRAD_TOL:g}), "
        f"worst cosine {worst_cos:.6f} (bound {STEP_GRAD_COS}), a_l by its "
        f"noise where given; {len(bad)} off")
    if abs(loss_k - loss_p) > 1e-2 * max(1.0, abs(loss_p)):
        bad.append(f"loss {loss_k} against {loss_p}")
    if bad:
        raise AssertionError("bf16 step 1 off the plain versions: "
                             + "; ".join(bad))


def run_real_gate(dev) -> None:
    """config2-real through the kernels: the JAX learning gate."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    cfg = get_config("config2-real")
    ds = load_dataset(cfg.dataset)
    data = prepare_device_data(ds)
    reset_counts()
    best_vals, tests = [], []
    for seed in (0, 1):
        t0 = time.perf_counter()
        model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))
        trainer = Trainer(model, data, dataclasses.replace(cfg.train,
                                                           seed=seed), dev)
        _, result = trainer.fit()
        best_vals.append(max(r["val_auc"] for r in result["history"]))
        tests.append(result["test_auc"])
        log(f"  seed {seed}: best val AUC {best_vals[-1]:.4f} (epoch "
            f"{result['best_epoch']}), test AUC {tests[-1]:.4f}, "
            f"{cfg.train.epochs} epochs in {time.perf_counter() - t0:.2f} s")
    log(f"  means: best val AUC {np.mean(best_vals):.4f}, test AUC "
        f"{np.mean(tests):.4f} (gate {REAL_GATE}); backward kernel "
        f"launches {ops.flash_gat_attention_bwd.launches}")
    if ops.flash_gat_attention_bwd.launches <= 0:
        raise AssertionError("config2-real did not run the backward kernel")
    if not (np.mean(best_vals) >= REAL_GATE and np.mean(tests) >= REAL_GATE):
        raise AssertionError(f"config2-real below the gate: {best_vals}, "
                             f"{tests}")


def _check_close(name: str, got, want, tol: float,
                 per_element: bool = False,
                 max_share: float | None = None) -> float:
    """Hold the outputs of a kernel to those of its plain version: the
    worst max|got - want| / max(1, max |want|) within ``tol``, or with
    ``per_element`` every value's |got - want| / (|want| + mean |want|);
    with ``max_share`` also at most that share of the values off their
    plain value at all. Raises beyond it, with the measures. Returns the
    worst absolute error."""
    torch.cuda.synchronize()
    err, ratio, worst, bad, off, count = 0.0, 0.0, 0.0, 0, 0, 0
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        d, b = (a.float() - b.float()).abs(), b.float().abs()
        e = d.max().item() if d.numel() else 0.0
        err, ratio = max(err, e), max(ratio, e / max(1.0, b.max().item()
                                                     if b.numel() else 0.0))
        off, count = off + int((d != 0).sum()), count + d.numel()
        if per_element and d.numel():
            r = torch.where(d == 0, 0.0, d / (b + b.mean()))
            worst, bad = max(worst, r.max().item()), bad + int((r > tol).sum())
    if per_element and not worst <= tol:
        raise AssertionError(
            f"{name}: {bad} values off by more than {tol:g} x (|plain| + "
            f"mean |plain|) (worst {worst:.3e}); max error / max(1, max "
            f"|plain|) {ratio:.3e}")
    if not per_element and not ratio <= tol:
        raise AssertionError(f"{name}: error {ratio} of the scale, above {tol}")
    if max_share is not None and off > max_share * count:
        raise AssertionError(
            f"{name}: {off} of {count} values ({off / max(count, 1):.3e}) off "
            f"their plain value, above a share of {max_share:g}")
    return err


def _compare(results: dict, name: str, kernel, plain, tol,
             num_bytes: float, flops: float = 0.0, library=None,
             per_element: bool = False, queued: bool = False,
             gathered: float = 0.0) -> None:
    """Hold a kernel to its plain version (``_check_close``; ``tol`` a
    number, or ``(tol, per_element, max_share)``), then ``record`` it
    (``queued``: its kernel time queued behind a sleep; ``gathered``: the
    bytes of rows it gathers by id, ``bound_ms``)."""
    if isinstance(tol, tuple):
        tol, per_element, max_share = tol
    else:
        max_share = None
    got = kernel()
    err = _check_close(name, got, plain(), tol, per_element, max_share)
    outs = got if isinstance(got, tuple) else (got,)
    record(results, name, err, tol, kernel, plain,
           num_bytes + nbytes(*outs), flops, library, queued=queued,
           gathered=gathered)


def sparse_config():
    """config4 and its model in float32, for the full-graph paths of phases
    7-8 (phases 7b, 8b and 9 run config4's model as configured, bf16)."""
    from bignn_tpu_torch.config import get_config

    cfg = get_config("config4")
    return cfg, dataclasses.replace(cfg.model, dtype="float32")


def load_large():
    """config4's dataset, the whole 100K-drug synthetic-large graph."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset

    cfg = get_config("config4")
    t0 = time.perf_counter()
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    log(f"  dataset {ds.name}: {ds.num_drugs} drugs, "
        f"{sum(m.num_nodes for m in ds.molecules)} atoms, {len(ds.edges)} "
        f"DDI edges ({len(ds.train_idx)} train), "
        f"{time.perf_counter() - t0:.2f} s")
    return ds


def _serve_requests(scorer, ds):
    """The 100K Scorer's requests, timed: the val positives and as many
    negatives scored, 8 top_k queries, a top_k_batch of 64 drugs with known
    partners excluded (checked); returns (pairs, scores, batch, candidates,
    the launch counts since the last reset)."""
    pos = ds.split_edges("val").astype(np.int64)
    pairs = np.concatenate([pos, negatives(ds, pos)])
    scorer.score_pairs(pairs[:scorer.chunk])  # warm-up
    t0 = time.perf_counter()
    scores = scorer.score_pairs(pairs)
    pairs_ms = (time.perf_counter() - t0) * 1e3
    if scores.shape != (len(pairs),) or not np.isfinite(scores).all():
        raise AssertionError("bad pair scores")
    log(f"  score_pairs: {len(pairs)} pairs in {pairs_ms:.3f} ms")

    drugs = np.arange(8) * 12_347 % ds.num_drugs
    scorer.top_k(int(drugs[0]), k=20)  # warm-up
    top_ms = []
    for d in drugs:
        t0 = time.perf_counter()
        ids, s = scorer.top_k(int(d), k=20)
        top_ms.append((time.perf_counter() - t0) * 1e3)
        if d in ids or not np.isfinite(s).all() or np.any(np.diff(s) > 0):
            raise AssertionError(f"bad top_k for drug {d}")
    log(f"  top_k(k=20): median {np.median(top_ms):.3f} ms over "
        f"{len(drugs)} queries (min {min(top_ms):.3f}, max {max(top_ms):.3f})")

    batch = np.arange(64) * 1_543 % ds.num_drugs
    scorer.top_k_batch(batch, k=20, exclude_known=True)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cand, s = scorer.top_k_batch(batch, k=20, exclude_known=True)
    batch_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_counts()
    known = np.concatenate([ds.split_edges("train"), ds.split_edges("val")])
    near = known[np.isin(known[:, 0], batch) | np.isin(known[:, 1], batch)]
    for row, d in enumerate(batch):
        partners = set(near[near[:, 0] == d, 1]) | set(
            near[near[:, 1] == d, 0]) | {d}
        if partners & set(cand[row].tolist()) or not np.isfinite(s[row]).all():
            raise AssertionError(f"known partner ranked for drug {d}")
    log(f"  top_k_batch(64 drugs, k=20, exclude_known): {batch_ms:.3f} ms "
        f"({batch_ms / 64:.4f} ms per query); peak device memory "
        f"{peak:.2f} GiB")
    log(f"  launches on the serving path: {launches}")
    return pairs, scores, batch, cand, launches


def run_sparse_serving(dev, ds) -> tuple[dict, dict, object]:
    """config4's model in float32 served over the whole 100K-drug graph
    ``ds``; returns the launch counts, the forward kernels' comparisons and
    the Scorer (phase 7b reuses its host layouts)."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.serve import Scorer

    cfg, model_cfg = sparse_config()
    model = BiGNN(model_cfg, seed=SEED)
    params = {k: v.clone() for k, v in model.state_dict().items()}

    reset_counts()
    t0 = time.perf_counter()
    scorer = Scorer(model, ds, params, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scorer.refresh(params)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    emb = scorer.embeddings
    log(f"  Scorer build (host layouts + upload + device encode): "
        f"{build_s:.4f} s; refresh (device encode alone): {refresh_s:.4f} s")
    if tuple(emb.shape) != (ds.num_drugs, 128) or not torch.isfinite(emb).all():
        raise AssertionError(f"bad embeddings {tuple(emb.shape)}")
    pairs, scores, _, _, launches = _serve_requests(scorer, ds)
    # every bucket at 100K drugs lies above the block-dense threshold:
    # block_adjacency reads 0 here (_check_block_routes)
    require_launched(launches, ("segment_sum:f32", "segment_softmax:f32",
                                "spmm_multihead:f32", "block_spmm:f32"),
                     "on the main path")
    if launches["flash_gat_attention:f32"] != 0:
        raise AssertionError("the dense flash-GAT ran on the sparse path")
    _check_block_routes(scorer._buckets, launches)

    # the new forward kernels against their plain versions at these shapes
    outer = scorer._outer
    n, e = outer.num_nodes, outer.edge_cap
    log(f"  kernels at N {n}, E {e}, H 4, D 32 (E*H*D = {e * 128})")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = 3 * torch.randn(e, 4, device=dev, generator=gen)
    v = torch.randn(n, 4, 32, device=dev, generator=gen)
    results = {}
    _compare(results, "segment_softmax:f32",
             lambda: ops.segment_softmax(x, outer.edge_dst, n),
             lambda: ops.segment_softmax_plain(x, outer.edge_dst, n),
             SPARSE_TOL, nbytes(x, outer.edge_dst),
             library=softmax_library(x, outer.edge_dst, n))
    alpha = ops.segment_softmax_plain(x, outer.edge_dst, n)
    del x
    _compare(results, "spmm_multihead:f32",
             lambda: ops.spmm_multihead(v, outer.edge_src, outer.edge_dst,
                                        alpha, n),
             lambda: ops.spmm_multihead_plain(v, outer.edge_src,
                                              outer.edge_dst, alpha, n),
             SPARSE_TOL, nbytes(v, outer.edge_src, outer.edge_dst, alpha),
             2 * e * 128,
             library=multihead_library(outer.edge_src, outer.edge_dst, alpha,
                                       n, v),
             gathered=gathered_rows(outer.edge_dst, n, 128, v.dtype))
    del v, alpha
    torch.cuda.empty_cache()

    # the same Scorer refreshed with the plain versions on the card
    _check_plain_refresh(scorer, params, pairs, emb, scores)
    return launches, results, scorer


def run_sparse_serving_bf16(dev, ds, scorer) -> tuple[dict, dict]:
    """Phase 7b: config4's model as configured (bf16) served over the whole
    100K-drug graph by ``scorer``, phase 7's Scorer with its host layouts
    and uploaded buckets, the model swapped (the layouts depend on the
    inner layers, not the compute type); its embeddings, pair scores and
    top-20 lists against a refresh with the plain versions. Returns the
    launch counts and the bf16 forward kernels' comparisons at these
    shapes."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN

    model = BiGNN(get_config("config4").model, seed=SEED)
    if model.compute_dtype != torch.bfloat16:
        raise AssertionError("config4's model is not bf16")
    params = {k: v.clone() for k, v in model.state_dict().items()}
    scorer.model = model.to(dev).eval()
    reset_counts()
    t0 = time.perf_counter()
    scorer.refresh(params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scorer.refresh(params)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    emb = scorer.embeddings
    log(f"  bf16 model on phase 7's layouts: first refresh {first_s:.4f} s, "
        f"refresh {refresh_s:.4f} s; embeddings {emb.dtype}")
    if (tuple(emb.shape) != (ds.num_drugs, 128) or emb.dtype != torch.bfloat16
            or not torch.isfinite(emb).all()):
        raise AssertionError(f"bad embeddings {tuple(emb.shape)} {emb.dtype}")
    pairs, scores, batch, cand, launches = _serve_requests(scorer, ds)
    require_launched(launches, ("block_spmm:bf16", "segment_sum:bf16",
                                "segment_softmax:bf16", "spmm_multihead:bf16"),
                     "on the bf16 serving path")
    require_idle(launches, (*F32_FORMS, "block_adjacency:int8"),
                 "on the bf16 serving path")

    with plain_ops():
        scorer.refresh(params)
        ref_scores = scorer.score_pairs(pairs)
        ref_cand, _ = scorer.top_k_batch(batch, k=20, exclude_known=True)
    ref = scorer.embeddings.float()
    scale = ref.abs().max().item()
    err = (emb.float() - ref).abs().max().item()
    s_scale = float(np.abs(ref_scores).max())
    s_err = float(np.abs(scores - ref_scores).max())
    agree = np.mean([len(set(a) & set(b)) / 20
                     for a, b in zip(cand.tolist(), ref_cand.tolist())])
    log(f"  vs plain refresh: embeddings max_abs_err {err:.3e} (max |emb| "
        f"{scale:.3e}, median {ref.abs().median().item():.3e}), pair scores "
        f"{s_err:.3e} (max {s_scale:.3e}, median "
        f"{float(np.median(np.abs(ref_scores))):.3e}); bound "
        f"{SERVE_BF16_TOL} x max; top-20 lists agree {agree:.4f} (least "
        f"{TOPK_AGREE})")
    if not (err <= SERVE_BF16_TOL * scale and s_err <= SERVE_BF16_TOL * s_scale
            and agree >= TOPK_AGREE):
        raise AssertionError("bf16 serving disagrees with the plain refresh")

    # the bf16 forward kernels against their plain versions at these shapes
    outer = scorer._outer
    n, e = outer.num_nodes, outer.edge_cap
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = (3 * torch.randn(e, 4, device=dev, generator=gen)).to(torch.bfloat16)
    v = torch.randn(n, 4, 32, device=dev, generator=gen).to(torch.bfloat16)
    results = {}
    _compare(results, "segment_softmax:bf16:100k",
             lambda: ops.segment_softmax(x, outer.edge_dst, n),
             lambda: ops.segment_softmax_plain(x, outer.edge_dst, n),
             BF16_STEP, nbytes(x, outer.edge_dst),
             library=softmax_library(x, outer.edge_dst, n), per_element=True)
    alpha = ops.segment_softmax_plain(x, outer.edge_dst, n)
    del x
    _compare(results, "spmm_multihead:bf16:100k",
             lambda: ops.spmm_multihead(v, outer.edge_src, outer.edge_dst,
                                        alpha, n),
             lambda: ops.spmm_multihead_plain(v, outer.edge_src,
                                              outer.edge_dst, alpha, n),
             BF16_TOL, nbytes(v, outer.edge_src, outer.edge_dst, alpha),
             2 * e * 128,
             library=multihead_library(outer.edge_src, outer.edge_dst, alpha,
                                       n, v),
             gathered=gathered_rows(outer.edge_dst, n, 128, v.dtype))
    del v, alpha
    torch.cuda.empty_cache()
    return launches, results


def _check_plain_refresh(scorer, params, pairs, emb, scores) -> None:
    """Refresh ``scorer`` with the plain versions on the card: its
    embeddings and pair scores must match ``emb`` and ``scores``, the
    kernels' (EMB_RTOL, and EMB_ATOL of the largest value)."""
    with plain_ops():
        scorer.refresh(params)
        ref_scores = scorer.score_pairs(pairs)
    ref = scorer.embeddings
    scale = ref.abs().max().item()
    diff = (emb - ref).abs()
    log(f"  embeddings vs plain refresh: max_abs_err {diff.max().item():.3e} "
        f"(max |emb| {scale:.3e}; rtol {EMB_RTOL}, atol {EMB_ATOL} x max)")
    if not bool((diff <= EMB_ATOL * scale + EMB_RTOL * ref.abs()).all()):
        raise AssertionError("embeddings disagree with the plain refresh")
    if not np.allclose(scores, ref_scores, rtol=EMB_RTOL,
                       atol=EMB_ATOL * np.abs(ref_scores).max()):
        raise AssertionError("pair scores disagree with the plain refresh")
    log(f"  pair scores vs plain refresh: max_abs_err "
        f"{np.abs(scores - ref_scores).max():.3e}")


def _check_block_routes(buckets, launches: dict) -> None:
    """Buckets above BLOCK_DENSE_MAX_NODES rows carry no dense blocks (they
    take block_spmm); block_adjacency ran once per bucket at or below it
    (the count adjacency of GIN, at upload)."""
    from bignn_tpu_torch.sparse.formats import BLOCK_DENSE_MAX_NODES

    small = 0
    for i, b in enumerate(buckets):
        dense = b.node_cap <= BLOCK_DENSE_MAX_NODES
        small += dense
        log(f"  bucket {i}: node_cap {b.node_cap}, edge_cap {b.edge_cap}: "
            + ("dense blocks" if dense else "block_spmm"))
        if dense == (b.block_cnt is None):
            raise AssertionError(f"bucket {i} on the wrong route")
    if small == len(buckets):
        raise AssertionError("no bucket above BLOCK_DENSE_MAX_NODES")
    if launches["block_adjacency:f32"] != small:
        raise AssertionError(
            f"block_adjacency ran {launches['block_adjacency:f32']} times "
            f"for {small} buckets at or below the threshold")


def block_spmm_kernels(dev, batch, dtype=torch.float32,
                       feat: int = 128) -> dict:
    """Row 6's forms (forward and backward, unweighted and weighted) in
    ``dtype`` against their plain versions at a block-local bucket above
    the threshold, F ``feat`` (the weighted bf16 forms value by value,
    ``BF16_WEIGHTED``); the library call is a batched matmul over the dense
    blocks in ``dtype`` (built outside the timing). Names carry
    ``:f<feat>`` where F is not 128, whose kernel times are queued behind
    a sleep."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.ops import cuda_lib

    b = batch.to(dev)
    n = b.node_cap
    e_real = int((b.edge_dst < n).sum())
    rows = int(b.node_mask.sum())
    t = cuda_lib.dtype_name(dtype)
    tol = (SPARSE_TOL, BWD_TOL) if dtype == torch.float32 else (BF16_TOL,
                                                                BF16_TOL)
    log(f"  kernels at rows {n} ({n // 128} blocks, {rows} real), edges "
        f"{b.edge_cap} ({e_real} real), F {feat}, {t}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(n, feat, device=dev, generator=gen).to(dtype)
    g = torch.randn(n, feat, device=dev, generator=gen).to(dtype)
    shape = "" if feat == 128 else f":f{feat}"
    results = {}
    for w, tw, form in ((None, None, ""),
                        (b.edge_weight, b.edge_tweight, ":weighted")):
        if w is not None and dtype == torch.bfloat16:
            tol = (BF16_WEIGHTED, BF16_WEIGHTED)
        blocks = ops.block_adjacency_plain(b.edge_src, b.edge_dst, w,
                                           n).to(dtype)
        blocks_t = blocks.transpose(1, 2).contiguous()
        # bytes the function needs: the real rows and the real edges (the
        # padding edges come last); the padding rows are never read
        wbytes = 0 if w is None else nbytes(w[:e_real])
        fwd = (x, b.edge_src, b.edge_dst, w, b.block_estarts, b.edge_tsrc,
               b.edge_tdst, tw, b.block_tstarts, n)
        _compare(results, f"block_spmm:{t}{form}{shape}",
                 lambda: ops.block_spmm(*fwd),
                 lambda: ops.block_spmm_plain(x, b.edge_src, b.edge_dst, w,
                                              num_nodes=n), tol[0],
                 nbytes(x[:rows], b.edge_src[:e_real], b.edge_dst[:e_real],
                        b.block_estarts) + wbytes,
                 2 * e_real * feat,
                 library=lambda: ops.block_diag_spmm(blocks, x),
                 queued=feat != 128)
        bwd = (g, b.edge_tsrc, b.edge_tdst, tw, b.block_tstarts, n)
        _compare(results, f"block_spmm_bwd:{t}{form}{shape}",
                 lambda: ops.block_spmm_bwd(*bwd),
                 lambda: ops.block_spmm_plain(*bwd[:4], num_nodes=n),
                 tol[1],
                 nbytes(g[:rows], b.edge_tsrc[:e_real], b.edge_tdst[:e_real],
                        b.block_tstarts) + wbytes,
                 2 * e_real * feat,
                 library=lambda: ops.block_diag_spmm(blocks_t, g),
                 queued=feat != 128)
        del blocks, blocks_t
    return results


def run_sparse_training(dev) -> tuple[list, dict]:
    """The full-graph Trainer with config4's model in float32 and config4's
    optimizer on 16,384 drugs, then config1's GCNs on the same graph, then
    (phase 8b) config4's model as configured, bf16; returns the launch
    counts of the three and the backward and block-local kernels'
    comparisons."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.models import BiGNNConfig
    from bignn_tpu_torch.sparse.formats import BLOCK_DENSE_MAX_NODES

    cfg, model_cfg = sparse_config()
    t0 = time.perf_counter()
    ds = load_dataset(cfg.dataset, num_drugs=cfg.max_drugs)
    data = prepare_device_data(ds)
    log(f"  dataset {ds.name} at {ds.num_drugs} drugs: "
        f"{sum(m.num_nodes for m in ds.molecules)} atoms, "
        f"{len(ds.train_idx)} train edges; data + layouts "
        f"{time.perf_counter() - t0:.2f} s")
    outer = data.outer.to(dev)
    if outer.dense_cnt is not None:
        raise AssertionError("the outer graph has dense masks")
    n, e = outer.num_nodes, outer.edge_cap
    log(f"  outer graph: {n} drugs, edge_cap {e} (directed, self-loops, "
        f"padded), no dense masks")

    # the new backward kernels against their plain versions at these shapes
    log(f"  kernels at N {n}, E {e}, H 4, D 32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s_e = 3 * torch.randn(e, 4, device=dev, generator=gen)
    alpha = ops.segment_softmax_plain(s_e, outer.edge_dst, n)
    g_e = torch.randn(e, 4, device=dev, generator=gen)
    v = torch.randn(n, 4, 32, device=dev, generator=gen)
    g = torch.randn(n, 4, 32, device=dev, generator=gen)
    results = {}
    x = 3 * torch.randn(e, 4, device=dev, generator=gen)
    for t, dtype, tol in (("f32", torch.float32, SPARSE_TOL),
                          ("bf16", torch.bfloat16, BF16_STEP)):
        xt = x.to(dtype)
        _compare(results, f"segment_softmax:{t}:16k",
                 lambda xt=xt: ops.segment_softmax(xt, outer.edge_dst, n),
                 lambda xt=xt: ops.segment_softmax_plain(xt, outer.edge_dst,
                                                         n),
                 tol, nbytes(xt, outer.edge_dst),
                 library=softmax_library(xt, outer.edge_dst, n),
                 per_element=t == "bf16")
    g16 = g_e.to(torch.bfloat16)
    kernel, plain, a16, num_bytes = softmax_bwd_calls(
        s_e.to(torch.bfloat16), g16, outer.edge_dst, n)
    _compare(results, "segment_softmax_bwd:bf16:16k", kernel, plain,
             BF16_STEP, num_bytes,
             library=softmax_library(a16, outer.edge_dst, n, g16),
             per_element=True)
    del x, xt, a16, g16, kernel, plain
    kernel, plain, a32, num_bytes = softmax_bwd_calls(s_e, g_e,
                                                      outer.edge_dst, n)
    _compare(results, "segment_softmax_bwd:f32", kernel, plain, BWD_TOL,
             num_bytes, library=softmax_library(a32, outer.edge_dst, n, g_e))
    del s_e, a32, kernel, plain
    mh = (v, outer.edge_src, outer.edge_dst, alpha, n, g,
          outer.edge_src_perm, outer.edge_src_sorted)
    _compare(results, "spmm_multihead_bwd:f32",
             lambda: ops.spmm_multihead_bwd(*mh),
             lambda: ops.spmm_multihead_bwd_plain(*mh), BWD_TOL,
             nbytes(v, outer.edge_dst, alpha, g, outer.edge_src_perm,
                    outer.edge_src_sorted), 4 * e * 128,
             library=multihead_library(outer.edge_src, outer.edge_dst, alpha,
                                       n, v, g),
             gathered=gathered_rows(outer.edge_dst, n, 128, g.dtype))
    gather = (g_e, outer.edge_src, n, outer.edge_src_perm,
              outer.edge_src_sorted)
    # the library call sums g_e by the gather's own (unsorted) indices
    _compare(results, "gather_rows_sorted_grad_bwd:f32",
             lambda: ops.gather_rows_sorted_grad_bwd(*gather),
             lambda: ops.gather_rows_sorted_grad_bwd_plain(*gather), BWD_TOL,
             nbytes(g_e, outer.edge_src_perm, outer.edge_src_sorted),
             library=index_add_call(g_e, outer.edge_src, n))
    _check_close("gather_rows_sorted_grad_bwd (sorted dst)",
                 ops.gather_rows_sorted_grad_bwd(g_e, outer.edge_dst, n),
                 ops.gather_rows_sorted_grad_bwd_plain(g_e, outer.edge_dst, n),
                 BWD_TOL)
    del alpha, g_e, v, g, mh, gather, outer
    torch.cuda.empty_cache()
    results.update(block_spmm_kernels(dev, max(
        data.bucketing.batches, key=lambda b: b.node_cap)))
    torch.cuda.empty_cache()

    batches = _epoch_batches(data, cfg.train)
    launches, f32_plain = _train_and_check(
        dev, model_cfg, data, cfg.train, batches,
        ("segment_sum:f32", "block_adjacency:f32", "segment_softmax:f32",
         "segment_softmax_bwd:f32", "spmm_multihead:f32",
         "spmm_multihead_bwd:f32", "gather_rows_sorted_grad_bwd:f32",
         "block_spmm:f32", "block_spmm_bwd:f32"))
    if (launches["flash_gat_attention:f32"]
            or launches["flash_gat_attention_bwd:f32"]):
        raise AssertionError("the dense flash-GAT ran on the sparse path")
    small = sum(b.node_cap <= BLOCK_DENSE_MAX_NODES
                for b in data.bucketing.batches)
    if launches["block_adjacency:f32"] != small:
        raise AssertionError("block_adjacency off the small buckets")
    # the weighted forms: config1's GCNs (inner block-local above the
    # threshold; outer over the sparse 16,384-drug graph, sorted COO)
    log("  config1 (GCN:64 x2 -> GCN:64:identity, dot), feat 32, on the "
        "same graph")
    gcn, _ = _train_and_check(
        dev, BiGNNConfig.config1(feat_dim=ds.feat_dim), data, cfg.train,
        batches, ("block_spmm:f32:weighted", "block_spmm_bwd:f32:weighted",
                  "spmm_sorted_coo:f32:weighted",
                  "spmm_sorted_coo_bwd:f32:weighted", "block_adjacency:f32"))

    # phase 8b: config4's model as configured (bf16), the same graph and
    # optimizer; row 6's bf16 forms at the largest bucket first (the
    # weighted ones off the path: no shipped config runs a bf16 GCN)
    log("  phase 8b: config4's model as configured (bf16), 20 steps")
    torch.cuda.empty_cache()
    results.update(block_spmm_kernels(dev, max(
        data.bucketing.batches, key=lambda b: b.node_cap), torch.bfloat16))
    torch.cuda.empty_cache()
    bf16, _ = _train_and_check(
        dev, cfg.model, data, cfg.train, batches,
        ("block_spmm:bf16", "block_spmm_bwd:bf16", "segment_sum:bf16",
         "segment_softmax:bf16", "segment_softmax_bwd:bf16",
         "spmm_multihead:bf16", "spmm_multihead_bwd:bf16",
         "gather_rows_sorted_grad_bwd:bf16"), f32_plain)
    if bf16["flash_gat_attention:f32"] or bf16["flash_gat_attention_bwd:f32"]:
        raise AssertionError("the dense flash-GAT ran on phase 8b")
    return [launches, gcn, bf16], results


def spmm_forms(b, dtype=torch.float32) -> list[tuple]:
    """Row 7's forms in ``dtype`` (forward and backward, unweighted at F 128
    as GIN's second layer takes them, weighted at F 64 as GCN's) at a
    bucket ``b`` on the card that is not block-local: ``(name, kernel call,
    plain call, library call, tolerance, bytes the call must read,
    operations)`` each; the weighted bf16 forms are held value by value
    (``BF16_WEIGHTED``). The library call is torch.sparse.mm over a CSR
    matrix in ``dtype`` built outside the timing."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.ops import cuda_lib

    dev = b.edge_src.device
    n = b.node_cap
    real = b.edge_dst < n
    e_real = int(real.sum())
    rows = int(b.node_mask.sum())
    src, dst = b.edge_src, b.edge_dst
    t = cuda_lib.dtype_name(dtype)
    tol = (SPARSE_TOL, BWD_TOL) if dtype == torch.float32 else (BF16_TOL,
                                                                BF16_TOL)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    forms = []
    for w, feat, form in ((None, 128, ""), (b.edge_weight, 64, ":weighted")):
        if w is not None and dtype == torch.bfloat16:
            tol = (BF16_WEIGHTED, BF16_WEIGHTED)
        x = torch.randn(n, feat, device=dev, generator=gen).to(dtype)
        g = torch.randn(n, feat, device=dev, generator=gen).to(dtype)
        vals = (torch.ones(e_real, device=dev) if w is None else w[real])
        ij = torch.stack([dst[real], src[real]]).long()
        csr, csr_t = (torch.sparse_coo_tensor(m, vals.to(dtype), (n, n))
                      .coalesce().to_sparse_csr() for m in (ij, ij.flip(0)))
        # bytes the function needs: the real rows and the real edges (the
        # padding edges come last)
        wbytes = 0 if w is None else nbytes(w[:e_real])
        fwd = (x, src, dst, w, n)
        forms.append((f"spmm_sorted_coo:{t}{form}",
                      lambda fwd=fwd: ops.spmm_sorted_coo(*fwd),
                      lambda fwd=fwd: ops.spmm_sorted_coo_plain(*fwd),
                      lambda a=csr, x=x: torch.sparse.mm(a, x), tol[0],
                      nbytes(x[:rows], src[:e_real], dst[:e_real]) + wbytes,
                      2 * e_real * feat))
        bwd = (g, src, dst, w, n, b.edge_src_perm, b.edge_src_sorted)
        forms.append((f"spmm_sorted_coo_bwd:{t}{form}",
                      lambda bwd=bwd: ops.spmm_sorted_coo_bwd(*bwd),
                      lambda bwd=bwd: ops.spmm_sorted_coo_bwd_plain(*bwd),
                      lambda a=csr_t, g=g: torch.sparse.mm(a, g), tol[1],
                      nbytes(g[:rows], dst[:e_real], b.edge_src_perm[:e_real],
                             b.edge_src_sorted[:e_real]) + wbytes,
                      2 * e_real * feat))
    return forms


def spmm_kernels(dev, batch, dtype=torch.float32) -> dict:
    """Row 7's forms (``spmm_forms``) in ``dtype`` against their plain
    versions at a bucket that is not block-local, timed with the library
    call."""
    b = batch.to(dev)
    log(f"  kernels at rows {b.node_cap} ({int(b.node_mask.sum())} real), "
        f"edges {b.edge_cap} ({int((b.edge_dst < b.node_cap).sum())} real), "
        f"{dtype}")
    results = {}
    for name, kernel, plain, library, tol, nb, flops in spmm_forms(b, dtype):
        _compare(results, name, kernel, plain, tol, nb, flops,
                 library=library)
    return results


def gin_split_layouts(src, dst, src_perm, src_sorted, b: int,
                      n_halo: int) -> list[tuple]:
    """dist_gin_apply's two sorted-COO SpMMs on one shard's edges (int32
    tensors of the plan; ``b`` owned rows, ``n_halo`` received ones), as
    parallel/halo.py builds them: per SpMM ``(src, dst, weight, rows of x,
    src_perm, src_sorted)``. The owned-source SpMM clamps every halo source
    to row b - 1 (weight 0) and the halo-source one every owned source to
    halo row 0 (weight 0), so each source order holds a hub row of about
    the other half's edges."""
    w_loc = (src < b).float()
    return [(src.clamp(max=b - 1), dst, w_loc, b, src_perm,
             src_sorted.clamp(max=b - 1)),
            ((src - b).clamp(0, n_halo - 1), dst, 1.0 - w_loc, n_halo,
             src_perm, (src_sorted - b).clamp(0, n_halo - 1))]


def gin_split_forms(src, dst, src_perm, src_sorted, b: int, n_halo: int,
                    feat: int = 128) -> list[tuple]:
    """Row 7 at dist_gin_apply's split (``gin_split_layouts``), float32 at
    F ``feat``: ``spmm_sorted_coo:f32:hub`` (both forward SpMMs) and
    ``spmm_sorted_coo_bwd:f32:hub`` (both backwards), as ``spmm_forms``
    gives its forms; the library calls are torch.sparse.mm on each SpMM's
    CSR matrix (the forward) or its transpose (the backward)."""
    from bignn_tpu_torch import ops

    dev = src.device
    lays = gin_split_layouts(src, dst, src_perm, src_sorted, b, n_halo)
    real = dst < b
    e_real = int(real.sum())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = [torch.randn(lay[3], feat, device=dev, generator=gen)
          for lay in lays]
    g = torch.randn(b, feat, device=dev, generator=gen)
    libs, libs_t = [], []
    for s, d, w, n, _, _ in lays:
        ij = torch.stack([d[real], s[real]]).long()
        libs.append(torch.sparse_coo_tensor(ij, w[real], (b, n)).coalesce()
                    .to_sparse_csr())
        libs_t.append(torch.sparse_coo_tensor(ij.flip(0), w[real], (n, b))
                      .coalesce().to_sparse_csr())
    fwd = [(x, s, d, w, b) for x, (s, d, w, *_) in zip(xs, lays)]
    bwd = [(g, s, d, w, n, p, st) for s, d, w, n, p, st in lays]
    # per SpMM, the real edges' ids and weights (a source-sorted array holds
    # as many real edges as the dst-sorted one)
    ebytes = e_real * 4
    return [
        ("spmm_sorted_coo:f32:hub",
         lambda: tuple(ops.spmm_sorted_coo(*a) for a in fwd),
         lambda: tuple(ops.spmm_sorted_coo_plain(*a) for a in fwd),
         lambda: tuple(torch.sparse.mm(a, x) for a, x in zip(libs, xs)),
         SPARSE_TOL, sum(nbytes(x) + 3 * ebytes for x in xs),
         sum(2 * e_real * feat for _ in xs)),
        ("spmm_sorted_coo_bwd:f32:hub",
         lambda: tuple(ops.spmm_sorted_coo_bwd(*a) for a in bwd),
         lambda: tuple(ops.spmm_sorted_coo_bwd_plain(*a[:5]) for a in bwd),
         lambda: tuple(torch.sparse.mm(a, g) for a in libs_t),
         BWD_TOL, len(bwd) * (nbytes(g) + 4 * ebytes),
         sum(2 * e_real * feat for _ in bwd))]


def run_streaming(dev) -> tuple[list, dict]:
    """Path A: config2 on the DrugBank stand-in with molecules up to 160
    atoms, where no bucket is block-local: served by Scorer (embeddings
    and pair scores against a plain-version refresh), trained 20 steps,
    then config1's GCNs trained 20 steps; returns the launch counts of the
    three runs and the sorted-COO kernels' comparisons at the largest
    bucket."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.models import BiGNN, BiGNNConfig
    from bignn_tpu_torch.serve import Scorer
    from bignn_tpu_torch.sparse import bucket_graphs

    ds = load_dataset("drugbank", max_atoms=160)
    bucketing = bucket_graphs(ds.molecules)
    log(f"  dataset {ds.name}: {ds.num_drugs} drugs, "
        f"{sum(m.num_nodes for m in ds.molecules)} atoms, "
        f"{sum(m.num_nodes > 128 for m in ds.molecules)} molecules over 128 "
        f"atoms, {len(ds.train_idx)} train edges")
    for i, b in enumerate(bucketing.batches):
        log(f"  bucket {i}: node_cap {b.node_cap}, edge_cap {b.edge_cap}, "
            f"{b.num_graphs} molecules, block-local "
            f"{b.block_estarts is not None}")
    if any(b.block_estarts is not None for b in bucketing.batches):
        raise AssertionError("a bucket is block-local")
    cfg = get_config("config2")
    model = BiGNN(cfg.model, seed=SEED)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    reset_counts()
    t0 = time.perf_counter()
    scorer = Scorer(model, ds, params, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scorer.refresh(params)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    pos = ds.split_edges("val").astype(np.int64)
    pairs = np.concatenate([pos, negatives(ds, pos)])
    scores = scorer.score_pairs(pairs)
    served = read_counts()
    emb = scorer.embeddings
    log(f"  Scorer build {build_s:.4f} s; refresh {refresh_s:.4f} s; "
        f"{len(pairs)} pairs scored")
    log(f"  launches on the streaming serving path: {served}")
    require_launched(served, ("spmm_sorted_coo:f32", "segment_sum:f32",
                              "flash_gat_attention:f32"), "on path A")
    require_idle(served, BLOCK_FORMS, "on path A")
    if tuple(emb.shape) != (ds.num_drugs, 128) or not np.isfinite(
            scores).all():
        raise AssertionError("bad embeddings or scores")
    _check_plain_refresh(scorer, params, pairs, emb, scores)
    del scorer, emb
    results = spmm_kernels(dev, max(bucketing.batches,
                                    key=lambda b: b.node_cap))
    torch.cuda.empty_cache()

    data = prepare_device_data(ds)
    log("  config2 Trainer, 20 steps")
    trained, _ = _train_and_check(
        dev, cfg.model, data, cfg.train, _epoch_batches(data, cfg.train),
        ("spmm_sorted_coo:f32", "spmm_sorted_coo_bwd:f32", "segment_sum:f32",
         "flash_gat_attention:f32", "flash_gat_attention_bwd:f32"))
    c1 = get_config("config1")
    log(f"  config1 (GCN:64 x2 -> GCN:64:identity, dot), feat "
        f"{ds.feat_dim}, 20 steps, batch {c1.train.batch_size}")
    gcn, _ = _train_and_check(
        dev, BiGNNConfig.config1(feat_dim=ds.feat_dim), data, c1.train,
        _epoch_batches(data, c1.train),
        ("spmm_sorted_coo:f32:weighted", "spmm_sorted_coo_bwd:f32:weighted"))
    for c in (trained, gcn):
        require_idle(c, BLOCK_FORMS, "on path A")
    return [served, trained, gcn], results


def run_max_readout(dev, ds, bucketing) -> tuple[list, dict]:
    """Path C: config2 with readout="max" on the DrugBank stand-in (block-
    local buckets, padding runs between molecules), 20 steps in float32,
    then 20 in bf16 (``dtype="bfloat16"``, the step-1 gradients by the
    bf16 tolerances); the readout's backward is one launch of its own
    kernel, and no segment sum runs. Then the segment max and its backward
    in both types against their plain versions at the largest bucket
    (exact: a max is one of its inputs, and the backward does the composed
    rule's operations)."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import prepare_device_data

    cfg = get_config("config2")
    data = prepare_device_data(ds)
    maxed = dataclasses.replace(cfg.model, readout="max")
    batches = _epoch_batches(data, cfg.train)
    sums = ("segment_sum:f32", "segment_sum:bf16")
    launches, f32_plain = _train_and_check(
        dev, maxed, data, cfg.train, batches,
        ("segment_max:f32", "segment_max_bwd:f32", "block_adjacency:f32",
         "flash_gat_attention:f32", "flash_gat_attention_bwd:f32"))
    require_idle(launches, sums, "on path C")
    log("  bf16 (dtype=\"bfloat16\"), 20 steps")
    bf16, _ = _train_and_check(
        dev, dataclasses.replace(maxed, dtype="bfloat16"), data, cfg.train,
        batches, ("segment_max:bf16", "segment_max_bwd:bf16",
                  "flash_gat_attention:f32", "flash_gat_attention_bwd:f32"),
        f32_plain)
    require_idle(bf16, sums, "on path C")
    results = {}
    b = max(bucketing.batches, key=lambda b: b.node_cap)
    for name, kernel, plain, library, tol, nb, flops in (
            segment_max_forms(dev, b) + segment_max_bwd_forms(dev, b)):
        _compare(results, name, kernel, plain, tol, nb, flops,
                 library=library)
    return [launches, bf16], results


def segment_max_forms(dev, b) -> list[tuple]:
    """Row 5 in float32 and bf16 at bucket ``b`` (block-local ids with
    padding runs), F 128, as ``spmm_forms`` gives its forms (exact: a max
    is one of its inputs); the library call is one amax
    ``scatter_reduce_``."""
    from bignn_tpu_torch import ops

    ids = torch.as_tensor(b.graph_ids, device=dev)
    n, s = b.node_cap, b.num_graphs
    rows = int((ids < s).sum())
    log(f"  segment_max at rows {n} ({rows} valid) -> {s} molecules, F 128")
    idx = torch.where(ids < s, ids, s).long()[:, None].expand(-1, 128)
    forms = []
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(n, 128, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED)).to(dt)
        out = x.new_empty((s + 1, 128))
        # bytes the function needs: the valid rows (a padding row lies in
        # no segment and is never read), every id, and the output
        forms.append((
            f"segment_max:{'f32' if dt == torch.float32 else 'bf16'}",
            lambda x=x: ops.segment_max(x, ids, s),
            lambda x=x: ops.segment_max_plain(x, ids, s),
            lambda x=x, out=out: out.scatter_reduce_(
                0, idx, x, "amax", include_self=False),
            0.0, nbytes(x[:rows], ids), rows * 128))
    return forms


def max_bwd_inputs(dev, b, dt) -> tuple:
    """(x, ids, s, g, rows) of the segment max backward's forms at bucket
    ``b``, F 128: data and cotangent drawn from seeded device generators,
    and the rows whose id is kept."""
    ids = torch.as_tensor(b.graph_ids, device=dev)
    s = b.num_graphs
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(b.node_cap, 128, device=dev, generator=gen).to(dt)
    g = torch.randn(s, 128, device=dev, generator=gen).to(dt)
    return x, ids, s, g, int((ids < s).sum())


def max_bwd_autograd(x: torch.Tensor, ids: torch.Tensor, n: int,
                     g: torch.Tensor) -> tuple:
    """(call, out): ``torch.autograd.grad`` of ``g`` through
    ``ops.segment_max`` of ``x``, the max readout's backward as the main
    path runs it, and the forward's result."""
    from bignn_tpu_torch import ops

    xr = x.detach().requires_grad_()
    with torch.enable_grad():  # the callers' phases run under no_grad
        out = ops.segment_max(xr, ids, n)
    return (lambda: torch.autograd.grad(out, xr, g, retain_graph=True)[0],
            out.detach())


def max_bwd_library(x: torch.Tensor, ids: torch.Tensor, n: int,
                    g: torch.Tensor):
    """The one PyTorch call that computes the segment max's backward:
    ``torch.autograd.grad`` through one amax ``scatter_reduce`` with
    ``include_self=False`` (dropped ids sent to a spare row whose cotangent
    is 0), whose backward splits a segment's cotangent evenly among its
    ties; the graph is built untimed."""
    idx = torch.where(ids < n, ids, n).long()[:, None].expand(-1, x.shape[1])
    xr = x.detach().requires_grad_()
    gs = torch.cat([g, g.new_zeros(1, g.shape[1])])
    with torch.enable_grad():
        out = xr.new_zeros((n + 1, x.shape[1])).scatter_reduce(
            0, idx, xr, "amax", include_self=False)
    return lambda: torch.autograd.grad(out, xr, gs, retain_graph=True)[0]


def segment_max_bwd_forms(dev, b) -> list[tuple]:
    """Row 5's backward in float32 and bf16 at bucket ``b``, as
    ``segment_max_forms`` gives the forward: the one launch the main path
    makes, on the bounds that the forward's kernel found, first held bit
    for bit to the path's own call (``max_bwd_autograd``) and then timed
    alone (the autograd engine's host cost is not the kernel's); exact
    against the composed plain rule on the forward's result. Bytes: the
    valid rows, the ids, out and g, the bounds (2 int32 a segment), and
    (added by ``_compare``) all of d; operations: a compare an element of
    the valid rows and a divide an element of g."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.ops import segment

    forms = []
    for dt in (torch.float32, torch.bfloat16):
        x, ids, s, g, rows = max_bwd_inputs(dev, b, dt)
        path, out = max_bwd_autograd(x, ids, s, g)
        _, bounds = segment._segment_max_cuda(x, ids, s)

        def kernel(x=x, out=out, g=g, bounds=bounds):
            return segment._segment_max_bwd_cuda(x, ids, out, g, s, bounds,
                                                 saved=True)

        name = f"segment_max_bwd:{'f32' if dt == torch.float32 else 'bf16'}"
        if not torch.equal(kernel(), path()):
            raise AssertionError(f"{name}: the launch on the forward "
                                 "kernel's bounds is not autograd's")
        forms.append((
            name, kernel,
            lambda x=x, out=out, g=g: ops.segment_max_bwd_plain(x, ids, out,
                                                                g, s),
            max_bwd_library(x, ids, s, g), 0.0,
            nbytes(x[:rows], ids, out, g) + 8 * s, (rows + s) * 128))
    return forms


def _step1_vs_plain(tr, hb, witness: bool = False) -> float:
    """Step 1 of MinibatchTrainer ``tr`` on batch ``hb`` from the JAX init
    of SEED, through the kernels and through the plain versions, held by
    ``_check_step1``; ``witness``: a bf16 model's a_l also against the
    same step of the model in float32 with the plain versions. Returns the
    kernels' loss."""
    from bignn_tpu_torch.models import BiGNN

    def step1():
        tr.init(SEED)
        loss = tr.train_step(hb).item()
        return loss, {k: p.grad.clone()
                      for k, p in tr.model.named_parameters()}

    loss, grads = step1()
    f32_plain = None
    with plain_ops():
        plain_loss, plain = step1()
        if witness:
            model = tr.model
            tr.model = BiGNN(dataclasses.replace(
                model.config, dtype="float32")).to(tr.device)
            try:
                _, f32_plain = step1()
            finally:
                tr.model = model
                tr.init(SEED)
    if tr.model.compute_dtype != torch.bfloat16:
        log(f"  step-1 loss kernels {loss:.6f} / plain {plain_loss:.6f}")
    _check_step1(grads, plain, loss, plain_loss, tr.model.compute_dtype,
                 f32_plain)
    return loss


def run_config3(dev) -> list:
    """Path D: config3 as get_config sets it (BioSNAP stand-in, here with
    molecules up to 160 atoms, so the layout is not block-local; fanouts
    (10, 5), batch 512 + 512, f32, host-drawn batches): MinibatchTrainer
    with resident tables, 64 steps by train_chunk (chunks of 8) over
    prefetched batches, then resident=False, 8 steps; returns the launch
    counts of both runs."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import MinibatchTrainer

    cfg = get_config("config3")
    ds = load_dataset(cfg.dataset, max_atoms=160, **cfg.dataset_kwargs)
    log(f"  dataset {ds.name}: {ds.num_drugs} drugs, "
        f"{sum(m.num_nodes for m in ds.molecules)} atoms, "
        f"{sum(m.num_nodes > 128 for m in ds.molecules)} molecules over 128 "
        f"atoms, {len(ds.train_idx)} train edges")
    counts = []
    for resident in (True, False):
        t0 = time.perf_counter()
        tr = MinibatchTrainer(BiGNN(cfg.model, seed=SEED), ds, cfg.train,
                              fanouts=cfg.fanouts, max_drugs=cfg.max_drugs,
                              resident=resident, device=dev)
        s = tr.sampler
        log(f"  resident={resident}: build {time.perf_counter() - t0:.3f} s;"
            f" caps: drugs {s.drug_budget}, node_cap {s.node_cap}, edge_cap "
            f"{s.edge_cap}, outer_edge_cap {s.outer_edge_cap}, pair_cap "
            f"{s.pair_cap}; block-local {s.block_local}")
        if s.block_local:
            raise AssertionError("config3's layout is block-local")
        draw = s.sample_compact_at if resident else s.sample_at
        _step1_vs_plain(tr, draw(0, 0))
        tr.init(SEED)
        torch.cuda.synchronize()
        reset_counts()
        steps = 64 if resident else 8
        chunk = 8 if resident else 1
        losses, secs = _prefetched_chunks(tr, draw, steps, chunk)
        launches = read_counts()
        log(f"  {steps} steps in chunks of {chunk}: median "
            f"{np.median(secs) * 1e3 / chunk:.3f} ms a step (host draws "
            f"prefetched on 2 threads); losses {losses[0]:.5f} -> "
            f"{losses[-1]:.5f}, mean of the last 8 "
            f"{losses[-8:].mean():.5f}")
        log(f"  launches: {launches}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError("non-finite config3 loss")
        require_launched(launches, ("spmm_sorted_coo:f32",
                                    "spmm_sorted_coo_bwd:f32"), "on path D")
        require_idle(launches, BLOCK_FORMS, "on path D")
        counts.append(launches)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def _prefetched_chunks(tr, draw, steps: int, chunk: int):
    """``steps`` steps of ``tr`` by ``train_chunk`` over host draws (epoch
    0) prefetched on 2 threads, ``chunk`` at a time; returns the losses and
    each chunk's seconds."""
    from bignn_tpu_torch.data.prefetch import ParallelPrefetcher

    losses, secs, pending = [], [], []
    t0 = time.perf_counter()
    for hb in ParallelPrefetcher(lambda i: draw(0, i), steps, workers=2):
        pending.append(hb)
        if len(pending) == chunk:
            losses.append(tr.train_chunk(pending))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            pending = []
    return torch.cat(losses).float().cpu().numpy(), secs


def config4_host_trainer(dev):
    """Path E's trainer: get_config("config4", device_sample=False) (bf16,
    fanouts (10,), batch 1024 + 1024, max_drugs 16,384, Adam lr 3e-4) on
    synthetic-large cut to 16,384 drugs with molecules up to 160 atoms, so
    that no batch is block-local; MinibatchTrainer with resident tables."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import MinibatchTrainer

    cfg = get_config("config4", device_sample=False)
    t0 = time.perf_counter()
    ds = load_dataset(cfg.dataset, num_drugs=cfg.max_drugs, max_atoms=160)
    log(f"  dataset {ds.name}: {ds.num_drugs} drugs, "
        f"{sum(m.num_nodes for m in ds.molecules)} atoms, "
        f"{sum(m.num_nodes > 128 for m in ds.molecules)} molecules over 128 "
        f"atoms, {len(ds.train_idx)} train edges, "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    tr = MinibatchTrainer(BiGNN(cfg.model, seed=SEED), ds, cfg.train,
                          fanouts=cfg.fanouts, max_drugs=cfg.max_drugs,
                          device_sample=cfg.device_sample, device=dev)
    s = tr.sampler
    log(f"  build {time.perf_counter() - t0:.3f} s; model dtype "
        f"{cfg.model.dtype}; caps: drugs {s.drug_budget}, node_cap "
        f"{s.node_cap}, edge_cap {s.edge_cap}, outer_edge_cap "
        f"{s.outer_edge_cap}, pair_cap {s.pair_cap}; block-local "
        f"{s.block_local}")
    if s.block_local or tr.device_sample or not tr.resident:
        raise AssertionError("path E is not config4 host-sampled, streaming")
    return tr


def run_config4_host(dev) -> tuple[dict, dict]:
    """Path E: config4 host-sampled (``config4_host_trainer``): step 1's
    gradients against the plain versions (bf16 tolerances), 16 steps by
    train_chunk over prefetched draws; then row 7's bf16 forms against
    their plain versions at a sampled batch. Returns the launch counts and
    the comparisons."""
    tr = config4_host_trainer(dev)
    s = tr.sampler
    hb = s.sample_compact_at(0, 0)
    _step1_vs_plain(tr, hb, witness=True)
    tr.init(SEED)
    torch.cuda.synchronize()
    reset_counts()
    losses, secs = _prefetched_chunks(tr, s.sample_compact_at, 16, 8)
    launches = read_counts()
    log(f"  16 steps in chunks of 8: median {np.median(secs) * 1e3 / 8:.3f} "
        f"ms a step (host draws prefetched on 2 threads); losses "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}")
    log(f"  launches: {launches}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite path E loss")
    require_launched(launches, ("spmm_sorted_coo:bf16",
                                "spmm_sorted_coo_bwd:bf16"), "on path E")
    require_idle(launches, BLOCK_FORMS, "on path E")
    with torch.no_grad():
        pb = tr._expand_compact(hb.to(dev), tr.tables)
    results = spmm_kernels(dev, pb, torch.bfloat16)
    del tr, pb
    gc.collect()
    torch.cuda.empty_cache()
    return launches, results


def run_attention(dev, ds) -> list:
    """Path F: GAT inner and DotAttn outer layers (feat 64, GAT:128:4 x2 ->
    sum -> DotAttn:128:4 -> mlp:64, f32, the JAX init of SEED), config2's
    optimizer, 20 Trainer steps each against the plain versions: (i) on the DrugBank stand-in
    ``ds``, block-local buckets with dense blocks and the dense 1,704-drug
    outer graph (GAT's block-dense and DotAttn's dense attention, plain
    PyTorch, as the JAX package leaves them to XLA); (ii) on molecules up
    to 160 atoms with the outer graph built without dense masks (GAT's and
    DotAttn's edge lists: segment_softmax and spmm_multihead, forward and
    backward). Returns the launch counts of both runs."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.models import BiGNNConfig
    from bignn_tpu_torch.sparse import build_outer_graph

    model_cfg = BiGNNConfig(
        feat_dim=64, inner_layers=("gat:128:4", "gat:128:4"), readout="sum",
        outer_layers=("dotattn:128:4:identity",), scorer="mlp:64")
    train_cfg = get_config("config2").train  # Adam lr 1e-3, 2048 + 2048
    data = prepare_device_data(ds)
    dense_buckets = sum(b.block_cnt is not None
                        for b in data.bucketing.batches)
    if data.outer.dense_cnt is None or not dense_buckets:
        raise AssertionError("run (i) needs dense blocks and a dense outer")
    log(f"  (i) DrugBank stand-in: dense blocks in {dense_buckets} of "
        f"{len(data.bucketing.batches)} buckets, dense outer graph")
    dense, _ = _train_and_check(dev, model_cfg, data, train_cfg,
                             _epoch_batches(data, train_cfg),
                             ("segment_sum:f32", "block_adjacency:f32"))
    big = load_dataset("drugbank", max_atoms=160)
    data = prepare_device_data(big)
    tp = data.train_pairs
    data = dataclasses.replace(data, outer=build_outer_graph(
        tp[:, 0], tp[:, 1], data.num_drugs, dense_max_nodes=0))
    log("  (ii) molecules up to 160 atoms, outer graph without dense masks")
    sparse, _ = _train_and_check(
        dev, model_cfg, data, train_cfg, _epoch_batches(data, train_cfg),
        ("segment_sum:f32", "segment_softmax:f32", "segment_softmax_bwd:f32",
         "spmm_multihead:f32", "spmm_multihead_bwd:f32",
         "gather_rows_sorted_grad_bwd:f32"))
    for c in (dense, sparse):
        require_idle(c, ("flash_gat_attention:f32",
                         "flash_gat_attention_bwd:f32"), "on path F")
    require_idle(sparse, BLOCK_FORMS, "on path F (ii)")
    return [dense, sparse]


def config4_trainer(dev, ds, mesh=None):
    """config4's MinibatchTrainer on ``ds``, exactly as get_config sets it
    (on ``mesh`` where given), with the parts of its build timed."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import MinibatchTrainer

    cfg = get_config("config4")
    t0 = time.perf_counter()
    tr = MinibatchTrainer(
        BiGNN(cfg.model, seed=SEED), ds, cfg.train, fanouts=cfg.fanouts,
        max_drugs=cfg.max_drugs, dispatch_chunk=cfg.dispatch_chunk,
        device_sample=cfg.device_sample, mesh=mesh, device=dev)
    total = time.perf_counter() - t0
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in tr.setup_seconds.items())
    log(f"  MinibatchTrainer build {total:.3f} s ({parts})")
    s, d = tr.sampler, tr.dsampler
    log(f"  model dtype {cfg.model.dtype}; caps: drugs {d.D}, node_cap "
        f"{d.NC} ({d.NC // 128} blocks), edge_cap {d.EC}, outer_edge_cap "
        f"{d.OE}, pair_cap {d.pair_cap}, superrows ({s.r_node}, "
        f"{s.r_edge}), {d.C} size classes, node hops {d.n_node_hops}, "
        f"U {d.U}")
    sizes = tr.resident_bytes()
    top = sorted(sizes.items(), key=lambda kv: -kv[1])[:4]
    log(f"  resident on the card: {sum(sizes.values()) / 2**20:.1f} MiB ("
        + ", ".join(f"{k} {v / 2**20:.1f}" for k, v in top) + ")")
    return tr


def config4_kernels(dev, cb, pb, outer) -> dict:
    """The bf16 and int8 kernel forms of config4's step against their plain
    versions at one sampled batch's shapes."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.ops import cuda_lib

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    D, NC, E = cb.drug_budget, pb.node_cap, outer.edge_cap
    results = {}
    log(f"  kernels at rows {NC} -> {D} drugs (F 128), edges {pb.edge_cap} "
        f"in {NC // 128} blocks, outer E {E} (H 4, D 32), bf16")
    x = torch.randn(NC, 128, device=dev, generator=gen).to(bf)
    ids = pb.graph_ids
    _compare(results, "segment_sum:bf16",
             lambda: ops.segment_sum(x, ids, D),
             lambda: ops.segment_sum_plain(x, ids, D), BF16_TOL,
             nbytes(x, ids), library=index_add_call(x, ids, D))
    del x
    # int8 counts (the step's form); int16 counts and bf16 weights, off the
    # path (r_node**2 > 127; a bf16 GCN inner), timed at the same edges
    for w, dt in ((None, torch.int8), (None, torch.int16),
                  (pb.edge_weight, torch.bfloat16)):
        adj = (pb.edge_src, pb.edge_dst, w, pb.block_estarts, NC, dt)
        name = f"block_adjacency:{cuda_lib.dtype_name(dt)}"
        _compare(results, name,
                 lambda: ops.block_adjacency(*adj),
                 lambda: ops.block_adjacency_plain(*adj[:3], NC, dt),
                 0.0 if w is None else BF16_TOL,
                 nbytes(pb.edge_src, pb.edge_dst, pb.block_estarts)
                 + (0 if w is None else nbytes(w)),
                 library=index_put_call(pb.edge_src, pb.edge_dst, NC, dt,
                                        w))
    s = 3 * torch.randn(E, 4, device=dev, generator=gen)
    s = s.to(bf)
    dst, src = outer.edge_dst, outer.edge_src
    _compare(results, "segment_softmax:bf16",
             lambda: ops.segment_softmax(s, dst, D),
             lambda: ops.segment_softmax_plain(s, dst, D), BF16_STEP,
             nbytes(s, dst), library=softmax_library(s, dst, D),
             per_element=True)
    alpha = ops.segment_softmax_plain(s, dst, D)
    g_e = torch.randn(E, 4, device=dev, generator=gen).to(bf)
    kernel, plain, a_k, num_bytes = softmax_bwd_calls(s, g_e, dst, D)
    _compare(results, "segment_softmax_bwd:bf16", kernel, plain, BF16_STEP,
             num_bytes, library=softmax_library(a_k, dst, D, g_e),
             per_element=True)
    # the same in float32, off the path (the step computes in bf16)
    s32, g32 = s.float(), g_e.float()
    _compare(results, "segment_softmax:f32:config4",
             lambda: ops.segment_softmax(s32, dst, D),
             lambda: ops.segment_softmax_plain(s32, dst, D), SPARSE_TOL,
             nbytes(s32, dst), library=softmax_library(s32, dst, D))
    kernel, plain, a32, num_bytes = softmax_bwd_calls(s32, g32, dst, D)
    _compare(results, "segment_softmax_bwd:f32:config4", kernel, plain,
             BWD_TOL, num_bytes, library=softmax_library(a32, dst, D, g32))
    del s32, a32, g32, a_k, kernel, plain
    v = torch.randn(D, 4, 32, device=dev, generator=gen).to(bf)
    g = torch.randn(D, 4, 32, device=dev, generator=gen).to(bf)
    _compare(results, "spmm_multihead:bf16",
             lambda: ops.spmm_multihead(v, src, dst, alpha, D),
             lambda: ops.spmm_multihead_plain(v, src, dst, alpha, D),
             BF16_TOL, nbytes(v, src, dst, alpha), 2 * E * 128,
             library=multihead_library(src, dst, alpha, D, v),
             gathered=gathered_rows(dst, D, 128, v.dtype))
    mh = (v, src, dst, alpha, D, g, outer.edge_src_perm,
          outer.edge_src_sorted)
    _compare(results, "spmm_multihead_bwd:bf16",
             lambda: ops.spmm_multihead_bwd(*mh),
             lambda: ops.spmm_multihead_bwd_plain(*mh), BF16_TOL,
             nbytes(v, dst, alpha, g, outer.edge_src_perm,
                    outer.edge_src_sorted), 4 * E * 128,
             library=multihead_library(src, dst, alpha, D, v, g),
             gathered=gathered_rows(dst, D, 128, g.dtype))
    gather = (g_e, src, D, outer.edge_src_perm, outer.edge_src_sorted)
    # padding edges (dst D) carry src 0 but sort as id D: the library call
    # gets the same drop through its index
    lib_ids = torch.where(dst < D, src, D)
    _compare(results, "gather_rows_sorted_grad_bwd:bf16",
             lambda: ops.gather_rows_sorted_grad_bwd(*gather),
             lambda: ops.gather_rows_sorted_grad_bwd_plain(*gather), BF16_TOL,
             nbytes(g_e, outer.edge_src_perm, outer.edge_src_sorted),
             library=index_add_call(g_e, lib_ids, D))
    return results


def run_config4_step(dev, ds) -> tuple[dict, dict, object]:
    """Phase 9: config4's step at full size; returns the launch counts of
    the 512-step run, the bf16/int8 kernel comparisons and the trainer as
    the run left it (path I(i) evaluates it)."""
    tr = config4_trainer(dev, ds)
    d = tr.dsampler
    tr.init(SEED)
    cb, stats = d.sample(tr._dev_consts, d.key_at(0, 0))
    pb = tr._expand_compact(cb, tr.tables)
    outer = tr._derive_outer(cb)
    n_real = int(cb.n_real)
    live = int((cb.outer_dst.long() < d.D).sum())
    rows = int((pb.graph_ids < d.D).sum())
    edges = int((pb.edge_dst < pb.node_cap).sum())
    log(f"  batch (0, 0): {n_real} drugs, {rows} atom rows, {edges} atom "
        f"edges, {live} outer edges (with self-loops), stats "
        f"{ {k: int(v) for k, v in stats.items()} }")
    if not (0 < n_real <= d.D and float(cb.mask.min()) == 1.0):
        raise AssertionError(f"bad sampled batch: {n_real} drugs")
    results = config4_kernels(dev, cb, pb, outer)
    del pb, outer
    torch.cuda.empty_cache()

    # step 1 through the kernels and through the plain versions
    _step1_vs_plain(tr, cb)

    # 512 steps from the init, device-drawn, 64 chunks of 8
    tr.init(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, secs, totals = [], [], {}
    for c in range(C4_CHUNKS):
        t0 = time.perf_counter()
        ls, st = tr.train_chunk_device(0, c * C4_CHUNK, C4_CHUNK)
        sync_all()
        secs.append(time.perf_counter() - t0)
        losses.append(ls)
        for k, v in st.items():
            totals[k] = totals.get(k, 0) + v
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.cat(losses).float().cpu().numpy()
    means = losses.reshape(-1, 64).mean(axis=1)
    log(f"  {len(losses)} steps: loss means per 64 steps "
        + " ".join(f"{m:.5f}" for m in means)
        + f"; first loss {losses[0]:.5f}, last {losses[-1]:.5f}")
    log(f"  step time: median chunk {np.median(secs) * 1e3:.3f} ms / "
        f"{C4_CHUNK} = {np.median(secs) * 1e3 / C4_CHUNK:.3f} ms a step "
        f"(first chunk {secs[0] * 1e3:.3f} ms, min {min(secs) * 1e3:.3f}, "
        f"max {max(secs) * 1e3:.3f}); peak device memory {peak:.2f} GiB")
    log(f"  truncation over the run: { {k: int(v) for k, v in totals.items()} }")
    log(f"  launches on config4's step: {launches}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite config4 loss")
    if not means[-1] < means[0]:
        raise AssertionError(f"config4 loss did not fall: {means}")
    require_launched(launches, (
        "segment_sum:bf16", "block_adjacency:int8", "segment_softmax:bf16",
        "segment_softmax_bwd:bf16", "spmm_multihead:bf16",
        "spmm_multihead_bwd:bf16", "gather_rows_sorted_grad_bwd:bf16"),
        "on config4's step")
    if launches["flash_gat_attention:f32"] != 0:
        raise AssertionError("the dense flash-GAT ran on config4's step")

    # one more chunk under the sync debug mode: host synchronisations
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.train_chunk_device(0, C4_CHUNKS * C4_CHUNK, C4_CHUNK)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # each synchronizing call warns "called a synchronizing CUDA operation"
    # (setting the mode itself warns that it is a prototype: not counted)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    log(f"  host synchronisations in one chunk of {C4_CHUNK} steps: "
        f"{len(syncs)}")
    for msg in sorted(set(syncs))[:5]:
        log(f"    {msg[:160]}")
    return launches, results, tr


# ---------------------------------------------------------------------------
# paths G, G(ii) and H: the edge-partitioned (p2) step, G graph shards on
# one card
# ---------------------------------------------------------------------------

# docs/P2_SCALE_r5.txt leg 1: the plan of the 100,000-drug train graph on 8
# shards (the port's partition equals the JAX package's array for array)
P2_LARGE_DRUGS = 100_000
P2_LARGE_PLAN = {"node_block": 12_500, "halo_size": 12_504,
                 "edge_cap": 2_015_872}
# path H's p2 embeddings of the bf16 model against the single-device
# forward of the same bf16 model, x max(1, max |ref|), or twice the bf16
# noise of that forward where it is larger: the p2 outer GAT computes in
# float32 (JAX's promotion of bf16 rows by float32 weights), the
# single-device one in bf16, whose own distance from the float32 model's
# forward (the noise) reached 1.8e-2 of the largest value in a CPU
# rehearsal at 300 drugs. This coarse bound holds the bf16 layout against
# full propagation; the bf16 kernels are held by the same p2 forward with
# the plain versions, at SERVE_BF16_TOL.
P2_EMB_TOL = 1e-2
LOSS_RTOL = 1e-5  # f32 step-1 losses: one masked mean summed in other orders
G2_TURNS = 12  # path G(ii)'s GIN and GCN steps timed in turns
P2_GAT_FORMS = ("all_to_all:f32", "segment_sum:f32", "block_adjacency:f32",
                "segment_softmax:f32", "segment_softmax_bwd:f32",
                "spmm_multihead:f32", "spmm_multihead_bwd:f32",
                "gather_rows_sorted_grad_bwd:f32")
FLASH_FORMS = ("flash_gat_attention:f32", "flash_gat_attention_bwd:f32")


class P2Trainer:
    """``make_p2_train_step`` behind ``Trainer.train_step``'s interface, so
    ``_timed_steps`` drives it: (epoch, step) keys the negatives as the
    Trainer's do, so both draw the same ones for a batch."""

    def __init__(self, model, train_cfg, mesh, num_drugs, plan_d,
                 overlap=False, remat=False, exchange=None):
        from bignn_tpu_torch.parallel import make_p2_train_step
        from bignn_tpu_torch.train import make_optimizer

        self.model, self.seed, self.plan_d = model, train_cfg.seed, plan_d
        self.step = make_p2_train_step(
            model, make_optimizer(model.parameters(), train_cfg), mesh,
            num_drugs, train_cfg.neg_ratio, overlap=overlap, remat=remat,
            exchange=exchange)

    def train_step(self, pairs, mask, epoch: int, step: int):
        from bignn_tpu_torch import prng

        key = prng.fold_in(prng.fold_in(prng.key(self.seed + 1), epoch),
                           step)
        return self.step(key, pairs, mask, self.plan_d)


class FirstCall:
    """Stands in for an ops function, keeping a copy of the send buffers of
    its first call (a step's own exchange) and of what it returned."""

    def __init__(self, fn):
        self.fn, self.bufs, self.out = fn, None, None

    def __call__(self, bufs, *args):
        first = self.bufs is None
        if first:
            self.bufs = [b.detach().clone() for b in bufs]
        out = self.fn(bufs, *args)
        if first:
            self.out = [o.detach().clone() for o in out]
        return out


def p2_layout(dev, ds, graph: int, inner_layers, overlap: bool = False,
              mesh=None):
    """The outer partition of ``ds``'s train graph, the sharded unions and
    their upload, on ``mesh`` (default: one that names ``dev`` ``graph``
    times); returns ``(mesh, plan, plan_d)``."""
    from bignn_tpu_torch.parallel import (
        build_outer_partition,
        build_sharded_inner,
        device_put_plan,
        make_mesh,
    )

    if mesh is None:
        mesh = make_mesh(dp=1, graph=graph, devices=[dev] * graph)
    train = ds.split_edges("train")
    t0 = time.perf_counter()
    plan = build_outer_partition(train[:, 0], train[:, 1], ds.num_drugs,
                                 graph)
    t1 = time.perf_counter()
    inner = build_sharded_inner(ds.molecules, plan, split_boundary=overlap)
    t2 = time.perf_counter()
    plan_d = device_put_plan(mesh, plan, inner, inner_layers)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stats = plan.stats()
    log(f"  plan {t1 - t0:.3f} s: B {plan.node_block}, S {plan.halo_size}, "
        f"edge_cap {plan.edge_cap}, edges per shard "
        f"{stats['edges_per_shard']}, replication "
        f"{stats['replication_factor']:.4f}")
    for u in (inner if overlap else (inner,)):
        log(f"  unions {t2 - t1:.3f} s: node_cap {u.node_cap}, edge_cap "
            f"{u.edge_cap}, "
            + ("dense blocks" if u.block_cnt is not None else
               "block_spmm" if u.block_estarts is not None else "edge list"))
    log(f"  upload (block_adjacency where dense) {t3 - t2:.3f} s")
    return mesh, plan, plan_d


def a2a_kernels(results: dict, name: str, bufs) -> None:
    """all_to_all on a step's own send buffers, bit for bit against its
    plain version, then timed; the library call is one ``copy_`` of the
    buffers pre-stacked ``[G, G, S, F]`` into its transpose."""
    from bignn_tpu_torch import ops

    got, want = ops.all_to_all(bufs), ops.all_to_all_plain(bufs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the exchange differs from its plain "
                             "version")
    log(f"  {name}: {len(bufs)} send buffers {tuple(bufs[0].shape)} "
        f"{bufs[0].dtype}, {2 * nbytes(*bufs) / 1e6:.1f} MB moved; equal to "
        "the plain version bit for bit")
    stacked = torch.stack(bufs)
    out = torch.empty_like(stacked)
    record(results, name, 0.0, 0.0, lambda: ops.all_to_all(bufs),
           lambda: ops.all_to_all_plain(bufs), 2 * nbytes(*bufs),
           library=lambda: out.copy_(stacked.transpose(0, 1)))


def _check_loss(name: str, got: float, want: float) -> None:
    log(f"  step-1 loss {got:.7f} against {want:.7f} ({name})")
    if abs(got - want) > LOSS_RTOL * max(1.0, abs(want)):
        raise AssertionError(f"step-1 loss off {name}: {got} vs {want}")


def run_p2(dev, ds) -> tuple[list, dict, dict]:
    """Path G: config5 as get_config sets it, on ``ds`` (the DrugBank
    stand-in), 4 graph shards on one card; path G(ii): its outer GAT
    swapped for gcn:128 and for gin:128. Returns the launch counts of the
    four runs, the exchange's comparison at config5's send buffers, and the
    first run's losses and median step (path K's reference)."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import prepare_device_data
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    cfg = get_config("config5")
    graph = cfg.graph_shards
    # the single-device reference packs all molecules in one union, as
    # the shards do theirs (tests/test_p2_step.py)
    data = prepare_device_data(ds, max_buckets=1)
    batches = _epoch_batches(data, cfg.train)
    log(f"  {cfg.model}; batch {cfg.train.batch_size}, lr {cfg.train.lr}; "
        f"mesh dp=1, graph={graph} on one card")
    reset_counts()
    mesh, plan, plan_d = p2_layout(dev, ds, graph, cfg.model.inner_layers)
    model = BiGNN(cfg.model, seed=SEED).to(dev)
    params0 = {k: v.clone() for k, v in model.state_dict().items()}
    rec = FirstCall(ops.all_to_all)
    secs = []
    with mock.patch.object(ops, "all_to_all", rec):
        losses, grads = _timed_steps(
            P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d), batches,
            "p2 step, kernels", secs)
    reference = {"losses": losses, "median_ms": np.median(secs) * 1e3,
                 "grads": grads}
    launches = read_counts()
    log(f"  launches on path G: {launches}")
    require_launched(launches, P2_GAT_FORMS, "on path G")
    require_idle(launches, FLASH_FORMS, "on path G")
    _check_learning(losses, grads)
    results = {}
    a2a_kernels(results, "all_to_all:f32 (config5)", rec.bufs)

    one = batches[:1]
    model.load_state_dict(params0)
    with plain_ops():
        p_losses, p_grads = _timed_steps(
            P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d), one,
            "p2 step 1, plain versions")
    _check_loss("the plain versions", losses[0], p_losses[0])
    _check_step1(grads, p_grads, losses[0], p_losses[0], torch.float32)
    trainer = Trainer(BiGNN(cfg.model), data, cfg.train, device=dev)
    trainer.model.load_state_dict(params0)
    t_losses, t_grads = _timed_steps(trainer, one,
                                     "single-device Trainer step 1")
    _check_loss("the single-device Trainer", losses[0], t_losses[0])
    _check_step1(grads, t_grads, losses[0], t_losses[0], torch.float32)
    del trainer
    model.load_state_dict(params0)
    r_losses, r_grads = _timed_steps(
        P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d, remat=True),
        one, "p2 step 1, remat")
    _check_loss("the step without remat", r_losses[0], losses[0])
    _check_step1(r_grads, grads, r_losses[0], losses[0], torch.float32)

    log("  overlap=True: boundary molecules first, their raw rows exchanged")
    reset_counts()
    _, _, plan_o = p2_layout(dev, ds, graph, cfg.model.inner_layers,
                             overlap=True)
    model.load_state_dict(params0)
    o_losses, o_grads = _timed_steps(
        P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_o,
                  overlap=True), batches, "p2 step, overlap")
    overlapped = read_counts()
    require_launched(overlapped, P2_GAT_FORMS, "on path G, overlap")
    require_idle(overlapped, FLASH_FORMS, "on path G, overlap")
    _check_learning(o_losses, o_grads)
    _check_loss("the step without overlap", o_losses[0], losses[0])
    _check_step1(o_grads, grads, o_losses[0], losses[0], torch.float32)
    del plan_o

    counts = [launches, overlapped]
    trainers = {}
    for outer in (("gcn:128",), ("gin:128",)):
        mcfg = dataclasses.replace(cfg.model, outer_layers=outer)
        log(f"  path G(ii): outer {outer}, 4 steps")
        reset_counts()
        model = BiGNN(mcfg, seed=SEED).to(dev)
        params0 = {k: v.clone() for k, v in model.state_dict().items()}
        trainers[outer[0]] = P2Trainer(model, cfg.train, mesh, ds.num_drugs,
                                       plan_d)
        losses, grads = _timed_steps(trainers[outer[0]], batches[:4],
                                     "p2 step, kernels")
        counts.append(read_counts())
        require_launched(counts[-1], (
            "all_to_all:f32", "spmm_sorted_coo:f32:weighted",
            "spmm_sorted_coo_bwd:f32:weighted"), f"on path G(ii) {outer}")
        _check_learning(losses, grads, fall=False)
        model.load_state_dict(params0)
        with plain_ops():
            p_losses, p_grads = _timed_steps(
                P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d),
                one, "p2 step 1, plain versions")
        _check_loss("the plain versions", losses[0], p_losses[0])
        _check_step1(grads, p_grads, losses[0], p_losses[0], torch.float32)
    # both outer layers' steps in turns, so that the host's drift between
    # runs (the steps are host-bound) falls on both alike
    secs = {outer: [] for outer in trainers}
    for i in range(4, 4 + G2_TURNS):
        pairs, mask = batches[i % len(batches)]
        for outer, tr in trainers.items():
            t0 = time.perf_counter()
            tr.train_step(pairs, mask, 0, i)
            torch.cuda.synchronize()
            secs[outer].append(time.perf_counter() - t0)
    gin, gcn = (np.median(secs[o]) * 1e3 for o in ("gin:128", "gcn:128"))
    log(f"  path G(ii) step medians, {G2_TURNS} steps each in turns: GIN "
        f"{gin:.3f} ms, GCN {gcn:.3f} ms ({gin / gcn:.2f}x)")
    # the GIN outer's two split SpMMs on shard 0 of the real plan: each
    # source order holds a hub row (gin_split_layouts)
    b, n_halo = plan.node_block, plan.n_shards * plan.halo_size
    shard0 = (torch.as_tensor(np.asarray(a[0], np.int32), device=dev)
              for a in (plan.edge_src, plan.edge_dst, plan.src_perm,
                        plan.src_sorted))
    log(f"  split SpMMs on shard 0: B {b}, {n_halo} halo rows")
    for name, kernel, plain, library, tol, nb, flops in gin_split_forms(
            *shard0, b, n_halo):
        _compare(results, name, kernel, plain, tol, nb, flops,
                 library=library)
    return counts, results, reference


# path G(iii): config5 at 64 graph shards on one card, past the 32 shards
# whose pointers row 9's launch takes by value (its table on the card)
G64 = 64
G64_STEPS = 3


def run_p2_g64(dev, ds) -> tuple[dict, dict]:
    """Path G(iii): config5 with ``graph_shards=64`` on one card (the
    DrugBank stand-in: 27 drugs a shard, halo 32), G64_STEPS p2 steps
    through the kernels from the JAX init of SEED; the step's own exchange
    equal to its plain version bit for bit (``a2a_kernels``, timed), and
    the same steps under ``plain_ops()``: step 1's loss within LOSS_RTOL
    and its gradients within GRAD_TOL (as path G), the later losses within
    K_LOSS_RTOL (as path K's). Returns the kernels' launch counts and
    the exchange's comparison."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import prepare_device_data
    from bignn_tpu_torch.models import BiGNN

    cfg = get_config("config5")
    batches = _epoch_batches(prepare_device_data(ds, max_buckets=1),
                             cfg.train)[:G64_STEPS]
    log(f"  config5 at graph_shards={G64}: mesh dp=1, graph={G64} on one "
        f"card, {len(batches)} steps")
    reset_counts()
    mesh, plan, plan_d = p2_layout(dev, ds, G64, cfg.model.inner_layers)
    model = BiGNN(cfg.model, seed=SEED).to(dev)
    params0 = {k: v.clone() for k, v in model.state_dict().items()}
    rec = FirstCall(ops.all_to_all)
    with mock.patch.object(ops, "all_to_all", rec):
        losses, grads = _timed_steps(
            P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d), batches,
            f"p2 step at {G64} shards, kernels")
    launches = read_counts()
    log(f"  launches on path G(iii): "
        f"{ {k: v for k, v in launches.items() if v} }")
    require_launched(launches, P2_GAT_FORMS, "on path G(iii)")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"path G(iii): non-finite loss {losses}")
    results = {}
    a2a_kernels(results, "all_to_all:f32 (g64)", rec.bufs)
    model.load_state_dict(params0)
    with plain_ops():
        p_losses, p_grads = _timed_steps(
            P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d), batches,
            f"p2 step at {G64} shards, plain versions")
    # step 1 as path G holds it; the later steps, whose Adam updates carry
    # step 1's rounding, as path K holds its steps against path G's
    _check_loss(f"the plain versions at {G64} shards", losses[0],
                p_losses[0])
    _check_step1(grads, p_grads, losses[0], p_losses[0], torch.float32)
    for i, (a, b) in enumerate(zip(losses, p_losses)):
        log(f"  step {i + 1} loss {a:.7f} against {b:.7f} (plain)")
        if abs(a - b) > K_LOSS_RTOL * max(1.0, abs(b)):
            raise AssertionError(f"path G(iii) step {i + 1} loss {a} vs {b}")
    del model, plan_d, rec
    gc.collect()
    torch.cuda.empty_cache()
    return launches, results


def _p2_embeddings(model, plan_d) -> torch.Tensor:
    """The p2 forward through the public entry points: every shard's inner
    encode, the distributed outer layers, the shards concatenated."""
    from bignn_tpu_torch.parallel import dist_outer_forward

    inner, esrc, edst, ew, sidx, sperm, ssrt = plan_d
    with torch.no_grad():
        h = dist_outer_forward(model, [model.encode_inner(b) for b in inner],
                               esrc, edst, ew, sidx, src_perm=sperm,
                               src_sorted=ssrt)
        return torch.cat(h)


def run_p2_large(dev, ds, ref_f32: torch.Tensor,
                 ref_bf16: torch.Tensor) -> tuple[dict, dict]:
    """Path H: config5-large as get_config sets it, on ``ds`` (the
    100,000-drug synthetic-large graph), 8 graph shards on one card: the
    plan against docs/P2_SCALE_r5.txt; the p2 embeddings of its model in
    float32 against ``ref_f32`` (phase 7's single-device forward of the
    same parameters) at phase 7's tolerances, which holds the partition and
    the halo against full propagation; those of its model as configured
    (bf16) against the same p2 forward with the plain versions
    (SERVE_BF16_TOL) and, coarsely, against ``ref_bf16`` (phase 7b's); 8
    steps, the launch counts and peak memory read over them alone; step 1's
    loss and gradients against the plain versions' (``_check_step1``, a_l
    by its bf16 noise against the float32 model's plain step); the exchange
    at the step's own send buffers. Returns the launch counts and the
    exchange's comparison."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN

    cfg = get_config("config5-large")
    if cfg.model != get_config("config4").model:
        raise AssertionError("phase 7b's model is not config5-large's")
    graph = cfg.graph_shards
    log(f"  {cfg.model}; batch {cfg.train.batch_size}, lr {cfg.train.lr}; "
        f"mesh dp=1, graph={graph} on one card, no remat")
    mesh, plan, plan_d = p2_layout(dev, ds, graph, cfg.model.inner_layers)
    if ds.num_drugs == P2_LARGE_DRUGS:
        got = {k: getattr(plan, k) for k in P2_LARGE_PLAN}
        if got != P2_LARGE_PLAN:
            raise AssertionError(f"plan {got}, docs/P2_SCALE_r5.txt "
                                 f"{P2_LARGE_PLAN}")
    f32 = BiGNN(dataclasses.replace(cfg.model, dtype="float32"),
                seed=SEED).to(dev)
    emb = _p2_embeddings(f32, plan_d)[: ds.num_drugs]
    scale = ref_f32.abs().max().item()
    diff = (emb - ref_f32).abs()
    log(f"  p2 forward, model in float32: against phase 7's single-device "
        f"forward max_abs_err {diff.max().item():.3e} (max |ref| "
        f"{scale:.3e}; rtol {EMB_RTOL}, atol {EMB_ATOL} x max)")
    if not (emb.shape == ref_f32.shape and bool(
            (diff <= EMB_ATOL * scale + EMB_RTOL * ref_f32.abs()).all())):
        raise AssertionError("float32 p2 embeddings disagree with the "
                             "single-device forward")
    del emb, diff
    model = BiGNN(cfg.model, seed=SEED).to(dev)
    params0 = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    emb = _p2_embeddings(model, plan_d)[: ds.num_drugs]
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    with plain_ops():
        plain = _p2_embeddings(model, plan_d)[: ds.num_drugs]
    p_scale = plain.abs().max().item()
    p_err = (emb - plain).abs().max().item()
    log(f"  p2 forward as configured {fwd_s:.4f} s, embeddings {emb.dtype}; "
        f"against the same p2 forward with the plain versions: max_abs_err "
        f"{p_err:.3e} (max |plain| {p_scale:.3e}; limit {SERVE_BF16_TOL} x "
        "max)")
    if not (emb.shape == plain.shape and p_err <= SERVE_BF16_TOL * p_scale):
        raise AssertionError("bf16 p2 embeddings disagree with the plain "
                             "versions")
    del plain
    scale = max(1.0, ref_bf16.abs().max().item())
    err = (emb - ref_bf16).abs().max().item()
    noise = (ref_bf16 - ref_f32).abs().max().item()
    limit = max(P2_EMB_TOL * scale, 2 * noise)
    log(f"  against phase 7b's single-device bf16 forward: max_abs_err "
        f"{err:.3e} (max |ref| {scale:.3e}, median "
        f"{ref_bf16.abs().median().item():.3e}); that forward's bf16 noise "
        f"(against phase 7's float32) {noise:.3e}; coarse limit {limit:.3e}; "
        f"p2 against the float32 forward "
        f"{(emb - ref_f32).abs().max().item():.3e}")
    if not (emb.shape == ref_bf16.shape and err <= limit):
        raise AssertionError("p2 embeddings disagree with the single-device "
                             "forward")
    del emb
    batches = _train_batches(ds, cfg.train)[:8]
    rec = FirstCall(ops.all_to_all)
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(ops, "all_to_all", rec):
        losses, grads = _timed_steps(
            P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d), batches,
            "config5-large p2 step")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak device memory over the steps {peak:.2f} GiB; launches on "
        f"path H: {launches}")
    # unions above BLOCK_DENSE_MAX_NODES rows (every one at 100K drugs)
    # take block_spmm, smaller ones dense blocks (built at the upload,
    # before the counted steps)
    dense = plan_d[0][0].block_cnt is not None
    if dense and ds.num_drugs == P2_LARGE_DRUGS:
        raise AssertionError("path H's unions have dense blocks")
    require_launched(launches, (
        "all_to_all:f32", "segment_sum:bf16", "segment_softmax:f32",
        "spmm_multihead:f32", "spmm_multihead_bwd:f32",
        "gather_rows_sorted_grad_bwd:f32",
        *(() if dense else ("block_spmm:bf16", "block_spmm_bwd:bf16"))),
        "on path H")
    require_idle(launches, FLASH_FORMS, "on path H")
    _check_learning(losses, grads, fall=False)

    one = batches[:1]
    torch.cuda.reset_peak_memory_stats()
    with plain_ops():
        model.load_state_dict(params0)
        p_losses, p_grads = _timed_steps(
            P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d), one,
            "p2 step 1, plain versions")
        f_losses, f_grads = _timed_steps(
            P2Trainer(f32, cfg.train, mesh, ds.num_drugs, plan_d), one,
            "p2 step 1, float32 model, plain versions")
    log(f"  peak device memory over the plain steps "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; float32 "
        f"step-1 loss {f_losses[0]:.6f}")
    _check_step1(grads, p_grads, losses[0], p_losses[0], torch.bfloat16,
                 f_grads)
    del f32, grads, p_grads, f_grads
    results = {}
    a2a_kernels(results, "all_to_all:f32", rec.bufs)
    # the multi-head forward on shard 0's edges (its destinations, its
    # extended rows), as the step's halo layers give it
    src, dst = (torch.as_tensor(np.asarray(a[0], np.int32), device=dev)
                for a in (plan.edge_src, plan.edge_dst))
    n_src, n_out = plan.ext_size, plan.node_block
    gen = torch.Generator(device=dev).manual_seed(SEED)
    alpha = ops.segment_softmax_plain(3 * torch.randn(
        len(dst), 4, device=dev, generator=gen), dst, n_out)
    v = torch.randn(n_src, 4, 32, device=dev, generator=gen)
    log(f"  kernels at shard 0: {n_out} destinations, {n_src} rows, "
        f"{len(dst)} edge slots, H 4, D 32")
    _compare(results, "spmm_multihead:f32:shard",
             lambda: ops.spmm_multihead(v, src, dst, alpha, n_out),
             lambda: ops.spmm_multihead_plain(v, src, dst, alpha, n_out),
             SPARSE_TOL, nbytes(v, src, dst, alpha), 2 * len(dst) * 128,
             library=multihead_library(src, dst, alpha, n_out, v),
             gathered=gathered_rows(dst, n_out, 128, v.dtype))
    return launches, results


def _train_batches(ds, train_cfg):
    """The first TRAIN_STEPS positive batches of epoch 0 of ``ds``."""
    return _epoch_batches(types.SimpleNamespace(
        train_pairs=ds.split_edges("train").astype(np.int32)), train_cfg)


def profile_p2(dev, ds, name: str) -> None:
    """The p2 step of config ``name`` (its graph shards on one card): step
    medians and the peak device memory, then a trace of one step."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN

    cfg = get_config(name)
    mesh, _, plan_d = p2_layout(dev, ds, cfg.graph_shards,
                                cfg.model.inner_layers)
    batches = _train_batches(ds, cfg.train)
    tr = P2Trainer(BiGNN(cfg.model, seed=SEED).to(dev), cfg.train, mesh,
                   ds.num_drugs, plan_d)
    torch.cuda.reset_peak_memory_stats()
    _timed_steps(tr, batches, "warm-up")
    _timed_steps(tr, batches, "p2 step")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    pairs, mask = batches[0]
    _trace(lambda: tr.train_step(pairs, mask, 1, 0), 1, "step")


def _median_ms(fn, reps: int = 20) -> float:
    """Median host-clock milliseconds of ``fn()`` up to a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _trace(run, reps: int, unit: str) -> None:
    """torch.profiler over ``run()``, which repeats a ``unit`` of work
    ``reps`` times: wall and device-busy time, device launches per unit,
    the device time of the busiest kernels and of the segment kernels'
    bounds pass and sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_ms((e.time_range.start, e.time_range.end) for e in device)
    log(f"  profiled {reps} x {unit}: wall {wall_ms:.3f} ms (profiler on), "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} %), "
        f"{len(device) / reps:.1f} device launches per {unit}")
    per_name: dict[str, list[float]] = {}
    for e in device:
        per_name.setdefault(e.name, []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    ranked = sorted(per_name.items(), key=lambda kv: -sum(kv[1]))
    for i, (name, times) in enumerate(ranked):
        if i < 15 or any(k in name for k in TRACE_ALWAYS):
            log(f"    {sum(times) / reps:8.4f} ms {len(times) / reps:6.1f}x  "
                f"{name[:90]}")


def profile_training(dev, model_cfg, data, train_cfg) -> None:
    """Where a training step's time goes (see --profile above)."""
    from bignn_tpu_torch import prng
    from bignn_tpu_torch.data.sampler import sample_negative_pairs
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.parallel import Replicas
    from bignn_tpu_torch.parallel.dp import dp_loss
    from bignn_tpu_torch.train import Trainer

    batches = _epoch_batches(data, train_cfg)
    trainer = Trainer(BiGNN(model_cfg), data, train_cfg, device=dev)
    trainer.init(SEED)
    _timed_steps(trainer, batches, "warm-up")
    for label in ("kernels", "plain", "plain", "kernels"):
        trainer.init(SEED)
        if label == "plain":
            with plain_ops():
                _timed_steps(trainer, batches, label)
        else:
            _timed_steps(trainer, batches, label)

    pairs, mask = batches[0]
    pos = torch.as_tensor(pairs, device=dev)
    pmask = torch.as_tensor(mask, device=dev)
    key = prng.fold_in(prng.fold_in(prng.key(train_cfg.seed + 1), 0), 0)

    one = Replicas(trainer.model, None, [dev])

    def loss():
        return dp_loss(one, [0], key, pos, pmask,
                       [(trainer.buckets, trainer.graph_index, trainer.outer)],
                       data.num_drugs, train_cfg.neg_ratio)

    def backward():
        trainer.optimizer.zero_grad(set_to_none=True)
        loss().backward()

    parts = {
        "negatives (host threefry + one upload)": lambda: sample_negative_pairs(
            key, pos, data.num_drugs, train_cfg.neg_ratio),
        "forward + loss": loss,
        "forward + loss + backward": backward,
        "optimizer step": trainer.optimizer.step,
    }
    for name, fn in parts.items():
        log(f"  {name}: {_median_ms(fn):.3f} ms (median of 20, synchronized)")

    def five_steps():
        for i, (pairs, mask) in enumerate(batches[:5]):
            trainer.train_step(pairs, mask, 1, i)

    _trace(five_steps, 5, "step")


def profile_config3(dev) -> None:
    """Path D's step (config3, resident tables, host-drawn batches): the
    host draw of a batch, then a chunk of 8 steps over drawn batches, timed
    and traced."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import MinibatchTrainer

    cfg = get_config("config3")
    ds = load_dataset(cfg.dataset, max_atoms=160, **cfg.dataset_kwargs)
    tr = MinibatchTrainer(BiGNN(cfg.model, seed=SEED), ds, cfg.train,
                          fanouts=cfg.fanouts, max_drugs=cfg.max_drugs,
                          device=dev)
    draw_ms, draws = [], []
    for i in range(C4_CHUNK):
        t0 = time.perf_counter()
        draws.append(tr.sampler.sample_compact_at(0, i))
        draw_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"  host draw (sample_compact_at): median {np.median(draw_ms):.3f} "
        f"ms over {C4_CHUNK}")
    step_ms = _median_ms(lambda: tr.train_chunk(draws), reps=5) / C4_CHUNK
    log(f"  chunk of {C4_CHUNK} over drawn batches: {step_ms:.3f} ms a step "
        "(median of 5, synchronized)")
    _trace(lambda: tr.train_chunk(draws), C4_CHUNK, "step")


def profile_sparse_serving(dev, ds) -> None:
    """Where the 100K-drug Scorer's build goes (each part synchronized on
    its own clock; "rest" is the known-partner CSR and the model upload),
    then a trace of 5 refreshes."""
    from bignn_tpu_torch import serve
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.sparse import formats

    _, model_cfg = sparse_config()
    model = BiGNN(model_cfg, seed=SEED)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    parts: dict[str, float] = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    with mock.patch.multiple(
            serve, bucket_graphs=timed("bucket_graphs", serve.bucket_graphs),
            upload_buckets=timed("upload_buckets", serve.upload_buckets),
            build_outer_graph=timed("build_outer_graph",
                                    serve.build_outer_graph)), \
            mock.patch.object(serve.Scorer, "refresh",
                              timed("refresh", serve.Scorer.refresh)):
        t0 = time.perf_counter()
        scorer = serve.Scorer(model, ds, params, device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    for name, sec in parts.items():
        log(f"  {name}: {sec:.3f} s")
    log(f"  rest: {total - sum(parts.values()):.3f} s; Scorer build "
        f"{total:.3f} s")
    train = ds.split_edges("train").astype(np.int64)
    t0 = time.perf_counter()
    src, dst = formats.symmetrize(train[:, 0], train[:, 1])
    t1 = time.perf_counter()
    src, _, _ = formats._build_sorted(src, dst, ds.num_drugs, True, True)
    t2 = time.perf_counter()
    formats.src_sort_arrays(src.astype(np.int32))
    log(f"  build_outer_graph again, by part: symmetrize {t1 - t0:.3f} s, "
        f"dst sort + self-loops + weights {t2 - t1:.3f} s, source sort "
        f"{time.perf_counter() - t2:.3f} s")

    def refreshes():
        for _ in range(5):
            scorer.refresh(params)

    scorer.refresh(params)
    _trace(refreshes, 5, "refresh")


def profile_config4(dev, ds) -> None:
    """Where config4's step goes: chunk medians (kernels and plain versions
    in turns), the synchronized parts of a step, a trace of one chunk."""
    tr = config4_trainer(dev, ds)
    d = tr.dsampler
    tr.init(SEED)

    def chunks(label, first, n=4):
        secs = []
        for c in range(n):
            t0 = time.perf_counter()
            tr.train_chunk_device(0, (first + c) * C4_CHUNK, C4_CHUNK)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        log(f"  {label}: median chunk {np.median(secs) * 1e3:.3f} ms, "
            f"{np.median(secs) * 1e3 / C4_CHUNK:.3f} ms a step ({n} chunks "
            f"of {C4_CHUNK})")

    chunks("warm-up", 0)
    for i, label in enumerate(("kernels", "plain", "plain", "kernels")):
        if label == "plain":
            with plain_ops():
                chunks(label, 4 + 4 * i)
        else:
            chunks(label, 4 + 4 * i)

    cb, _ = d.sample(tr._dev_consts, d.key_at(0, 0))

    def backward():
        tr.optimizer.zero_grad(set_to_none=True)
        tr._loss([cb]).backward()

    parts = {
        "sample (DeviceSampler.sample)": lambda: d.sample(
            tr._dev_consts, d.key_at(0, 1)),
        "expand (_expand_compact, int8 counts)": lambda: tr._expand_compact(
            cb, tr.tables),
        "expand + forward + loss": lambda: tr._loss([cb]),
        "expand + forward + loss + backward": backward,
        "Adam step": tr.optimizer.step,
        "whole step (sample + train_step)": lambda: tr.train_step(
            d.sample(tr._dev_consts, d.key_at(0, 2))[0]),
    }
    for name, fn in parts.items():
        log(f"  {name}: {_median_ms(fn):.3f} ms (median of 20, synchronized)")
    _trace(lambda: tr.train_chunk_device(0, 100 * C4_CHUNK, C4_CHUNK),
           C4_CHUNK, "step")


# ---------------------------------------------------------------------------
# path I: exact evaluation and the entry points
# ---------------------------------------------------------------------------

# the bf16 forms that config4's exact encode and outer pass launch
C4_EXACT_FORMS = ("segment_sum:bf16", "block_adjacency:int8",
                  "segment_softmax:bf16", "spmm_multihead:bf16")


def _check_scores(name: str, got, want) -> float:
    """Exact scores of two routes on the same parameters: ``got`` within
    EMB_RTOL / EMB_ATOL x max |want| of ``want`` (tests/test_exact_eval.py);
    returns the largest difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    atol = EMB_ATOL * float(np.abs(want).max())
    if not (got.shape == want.shape and np.all(np.isfinite(got))
            and np.allclose(got, want, rtol=EMB_RTOL, atol=atol)):
        raise AssertionError(f"{name}: max difference {err:.3e} beyond rtol "
                             f"{EMB_RTOL:g} / atol {atol:.3e}")
    log(f"  {name}: max difference {err:.3e} (atol {atol:.3e})")
    return err


def run_exact_config4(tr) -> dict:
    """Path I(i): phase 9's trainer as its 512 steps left it (config4,
    bf16, int8 counts, device-sampled) evaluated exactly: embed_all_exact
    through the kernels against the same under the plain versions
    (SERVE_BF16_TOL x max), then evaluate(exact=True) on val and test beside
    the sampled evaluate; returns the exact run's launch counts."""
    t0 = time.perf_counter()
    sampled = {split: tr.evaluate(split=split) for split in ("val", "test")}
    torch.cuda.synchronize()
    log(f"  sampled evaluate, val and test: {time.perf_counter() - t0:.3f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outer = tr._full_outer()  # built on the host once, kept on the card
    torch.cuda.synchronize()
    log(f"  the train graph for the exact outer pass: {outer.edge_cap} edges,"
        f" built and uploaded in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    emb = tr.embed_all_exact()
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    exact = {}
    for split in ("val", "test"):
        t0 = time.perf_counter()
        exact[split] = tr.evaluate(split=split, exact=True)
        log(f"  {split}: exact {exact[split]} ({time.perf_counter() - t0:.3f}"
            f" s), sampled {sampled[split]}")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  exact embed {embed_s:.3f} s: {tuple(emb.shape)} {emb.dtype}; "
        f"peak device memory {peak:.2f} GiB")
    log(f"  launches on path I(i): {launches}")
    with plain_ops():
        plain = tr.embed_all_exact()
    err = (emb.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    log(f"  against the plain versions: max_abs_err {err:.3e} (max |plain| "
        f"{scale:.3e}; limit {SERVE_BF16_TOL} x max)")
    if not (emb.shape == (tr.ds.num_drugs, tr.model.embed_dim)
            and bool(torch.isfinite(emb).all())
            and err <= SERVE_BF16_TOL * scale):
        raise AssertionError("config4's exact embeddings off their plain "
                             "version")
    for split, m in exact.items():
        if not m[f"{split}_auc"] > 0.5:
            raise AssertionError(f"config4 exact {split} AUC {m}")
    require_launched(launches, C4_EXACT_FORMS, "on path I(i)")
    require_idle(launches, F32_FORMS, "on path I(i)")
    return launches


def run_exact_config3(dev) -> dict:
    """Path I(ii): config3 as get_config sets it (BioSNAP stand-in,
    molecules up to 48 atoms: block-local, a dense outer graph) with the
    JAX init of seed 0: score_exact of a resident and of a non-resident
    MinibatchTrainer on the val positives and as many negatives, against
    each other and against the full-graph Trainer's scores on
    prepare_device_data; the resident trainer's scores also against its
    own under the plain versions, which holds block_adjacency:int8 and
    flash_gat_attention at config3's shapes; returns the exact runs'
    launch counts."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import MinibatchTrainer, Trainer

    cfg = get_config("config3")
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    pos = ds.split_edges("val")
    pairs = np.concatenate([pos, negatives(ds, pos)])
    params = BiGNN(cfg.model, seed=SEED).state_dict()
    log(f"  dataset {ds.name}: {ds.num_drugs} drugs, {len(pairs)} pairs")
    reset_counts()
    scores, trainers = {}, {}
    for resident in (True, False):
        t0 = time.perf_counter()
        tr = MinibatchTrainer(BiGNN(cfg.model), ds, cfg.train,
                              fanouts=cfg.fanouts, max_drugs=cfg.max_drugs,
                              resident=resident, device=dev)
        built = time.perf_counter() - t0
        if not tr.sampler.block_local:
            raise AssertionError("config3's layout is not block-local")
        t0 = time.perf_counter()
        scores[resident] = tr.score_exact(params, pairs)
        log(f"  resident={resident}: build {built:.3f} s, score_exact "
            f"{time.perf_counter() - t0:.3f} s")
        trainers[resident] = tr
    launches = read_counts()
    log(f"  launches on path I(ii): {launches}")
    del trainers[False]
    with plain_ops():
        plain = trainers[True].score_exact(params, pairs)
    if read_counts() != launches:
        raise AssertionError("a kernel launched under plain_ops()")
    del trainers
    _check_scores("resident against its plain versions", scores[True], plain)
    full = Trainer(BiGNN(cfg.model), prepare_device_data(ds), cfg.train,
                   device=dev)
    full.model.load_state_dict(params)
    with torch.no_grad():
        want = full.model(full.buckets, full.graph_index, full.outer,
                          torch.as_tensor(pairs, device=dev)).cpu().numpy()
    _check_scores("resident against non-resident", scores[True],
                  scores[False])
    for resident, got in scores.items():
        _check_scores(f"resident={resident} against the full-graph Trainer",
                      got, want)
    require_launched(launches, ("block_adjacency:int8",
                                "flash_gat_attention:f32"), "on path I(ii)")
    del full
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# path J: data and feature parallelism, the card named several times
# ---------------------------------------------------------------------------

J_DP4 = 2  # path J(i): config4 on dp = 2
J_CHUNKS = 2  # of C4_CHUNK steps: 16 steps a run
J_DP2 = 4  # path J(ii): config2's full-graph Trainer on dp = 4
J_TP = ((1, 2), (2, 2))  # path J(iii): (dp, tp)
DP_TOL = dict(rtol=1e-4, atol=1e-6)  # JAX tests/test_dp.py, parameters
TP_TOL = dict(rtol=5e-4, atol=1e-5)  # JAX tests/test_tp.py, parameters
J_FORMS = ("segment_sum:bf16", "block_adjacency:int8",
           "segment_softmax:bf16", "spmm_multihead:bf16")
# run --dp 2 against the run without it, epoch losses: the shard sums are
# added in another order, and Adam amplifies that rounding through GAT's
# a_l (J(ii)); config2's two epochs differ by 3.3e-4 on the CPU's plain
# versions, while a dropped shard moves an epoch's loss by percents
DP_RUN_RTOL = 2e-3
DP_RUN_AUC = 5e-3  # test AUC, absolute
# the paths before M run `run` on the first card alone, as on a machine of
# one card (`--device cuda` spreads shards over every visible card)
FIRST_CARD = ["--device", "cuda:0"]


def _c4_run(tr, secs: list, peaks: list) -> tuple[np.ndarray, dict]:
    """J_CHUNKS chunks of config4's steps from the JAX init of SEED, each
    timed to a synchronize (into ``secs``), and the run's peak device memory
    above what was allocated at its start (GiB, into ``peaks``: its
    activations, gradients, Adam moments and batches, not the trainers'
    resident tables); returns the losses and the truncation counters
    summed."""
    tr.init(SEED)
    tr.optimizer.zero_grad(set_to_none=True)  # the last run's gradients
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, stats = [], {}
    for c in range(J_CHUNKS):
        t0 = time.perf_counter()
        ls, st = tr.train_chunk_device(0, c * C4_CHUNK, C4_CHUNK)
        sync_all()
        secs.append(time.perf_counter() - t0)
        losses.append(ls)
        for k, v in st.items():
            stats[k] = stats.get(k, 0) + int(v)
    peaks.append((torch.cuda.max_memory_allocated() - base) / 2**30)
    return torch.cat(losses).float().cpu().numpy(), stats


def _union_reference(tr, batches: list) -> tuple[float, dict]:
    """One step on the union of ``batches`` (on the device) written out on
    ``tr``, a trainer without a mesh: each batch's masked BCE sum and count
    added in order, the backward of their ratio and one optimizer step, all
    through the kernels; returns the loss and the step's gradients."""
    from bignn_tpu_torch.models.loss import bce_with_logits_elementwise

    tr.optimizer.zero_grad(set_to_none=True)
    num = den = None
    for b in batches:
        per = bce_with_logits_elementwise(tr._forward(b), b.labels)
        mask = b.mask.float()
        n, m = (per * mask).sum(), mask.sum()
        num, den = (n, m) if num is None else (num + n, den + m)
    ref = num / den.clamp_min(1.0)
    ref.backward()
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters()}
    tr.optimizer.step()
    return ref.item(), grads


def _close_params(name: str, got: dict, want: dict, tol: dict,
                  a_l: tuple[torch.Tensor, torch.Tensor]) -> None:
    """Every parameter of ``got`` within ``tol`` of ``want``'s, but GAT's
    ``a_l``, whose gradient cancels (its step-1 values are Adam's first
    update, g / (|g| + eps), on a gradient near its rounding noise): its
    step-1 gradients ``a_l = (got's, want's)`` instead, within GRAD_TOL x
    max |want's|."""
    worst, bad = 0.0, []
    for k, w in want.items():
        g = got[k]
        err = (g - w).abs().max().item()
        if k.endswith(".a_l"):
            ga, gw = a_l
            gerr = (ga - gw).abs().max().item()
            scale = gw.abs().max().item()
            log(f"  {name}: {k} after step 1 max|d| {err:.3e}; its "
                f"gradient max|d| {gerr:.3e}, max |g| {scale:.3e}")
            if not gerr <= GRAD_TOL * scale:
                bad.append(f"{k} gradient (max|d| {gerr:.3e})")
            continue
        worst = max(worst, err)
        if not torch.allclose(g, w, **tol):
            bad.append(f"{k} (max|d| {err:.3e})")
    log(f"  {name}: parameters after step 1 max|d| {worst:.3e} "
        f"(rtol {tol['rtol']:g}, atol {tol['atol']:g}); {len(bad)} off")
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))


def _check_loss1(name: str, got: float, want: float) -> None:
    log(f"  {name}: step-1 loss {got:.7f} against {want:.7f}")
    if not abs(got - want) <= LOSS_RTOL * abs(want):
        raise AssertionError(f"{name}: step-1 loss {got} against {want}")


def run_dp_config4(dev, ds, tr1) -> list:
    """Path J(i): config4 as get_config sets it on dp = 2 naming the card
    twice (1024 pairs a shard), beside phase 9's dp = 1 trainer ``tr1``.
    Step 1 against a union-batch reference on ``tr1`` (keys key_at(0, 0)
    and key_at(0, 1), the union masked mean, one update, all through the
    kernels): the loss within LOSS_RTOL, the gradients by _check_step1.
    Then 16 steps on dp = 1, dp = 2, dp = 2 again and dp = 1 in turns: the
    two dp = 2 runs' losses equal to the bit, 32 batches sampled, each
    J_FORMS form launched twice as often as on dp = 1 and no float32 form;
    each run's peak memory above its start. Returns the counts of the first
    dp = 2 run."""
    from bignn_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dp=J_DP4, graph=1, devices=[dev] * J_DP4)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    tr2 = config4_trainer(dev, ds, mesh=mesh)
    torch.cuda.synchronize()
    built = (torch.cuda.memory_allocated() - held) / 2**30
    log(f"  the dp = 2 trainer holds {built:.3f} GiB once built; "
        f"{held / 2**30:.3f} GiB were allocated before it "
        f"(phase 9's dp = 1 trainer among them, "
        f"{sum(tr1.resident_bytes().values()) / 2**30:.3f} GiB resident)")
    tr2.init(SEED)
    loss2 = tr2.train_chunk_device(0, 0, 1)[0].item()
    grads2 = {k: p.grad.clone() for k, p in tr2.model.named_parameters()}
    after2 = tr2.params()
    tr1.init(SEED)
    d = tr1.dsampler
    ref, grads1 = _union_reference(
        tr1, [d.sample(tr1._dev_consts, d.key_at(0, s))[0]
              for s in range(J_DP4)])
    _check_loss1("dp = 2 against the union-batch reference", loss2, ref)
    _check_step1(grads2, grads1, loss2, ref, torch.bfloat16)
    upd = max((after2[k] - v).abs().max().item()
              for k, v in tr1.params().items())
    log(f"  parameters after the update, dp = 2 against the reference: "
        f"max|d| {upd:.3e}")

    secs, peaks = {1: [], 2: []}, {1: [], 2: []}
    reset_counts()
    _c4_run(tr1, secs[1], peaks[1])
    c1 = read_counts()
    reset_counts()
    losses, stats = _c4_run(tr2, secs[2], peaks[2])
    c2 = read_counts()
    again, _ = _c4_run(tr2, secs[2], peaks[2])
    _c4_run(tr1, secs[1], peaks[1])
    med = {k: np.median(v) * 1e3 / C4_CHUNK for k, v in secs.items()}
    log(f"  {J_CHUNKS * C4_CHUNK} steps: losses {losses[0]:.5f} ... "
        f"{losses[-1]:.5f}; stats {stats}")
    log(f"  step time (chunk median / {C4_CHUNK}, turns dp 1, 2, 2, 1): "
        f"dp = 2 {med[2]:.3f} ms (1024 + 1024 pairs a shard), dp = 1 "
        f"{med[1]:.3f} ms; chunks dp 2 "
        + " ".join(f"{x * 1e3:.1f}" for x in secs[2]) + ", dp 1 "
        + " ".join(f"{x * 1e3:.1f}" for x in secs[1])
        + " ms; peak device memory above each run's start: dp = 2 "
        + " ".join(f"{x:.3f}" for x in peaks[2]) + " GiB, dp = 1 "
        + " ".join(f"{x:.3f}" for x in peaks[1]) + f" GiB on {card_line()}")
    log(f"  launches dp = 1: {c1}")
    log(f"  launches dp = 2: {c2}")
    if not (np.all(np.isfinite(losses)) and np.array_equal(losses, again)):
        raise AssertionError(f"dp = 2 losses not finite or not repeated: "
                             f"{losses} against {again}")
    if stats.get("batches_sampled") != J_DP4 * J_CHUNKS * C4_CHUNK:
        raise AssertionError(f"dp = 2 sampled {stats}")
    require_launched(c2, J_FORMS, "on path J(i)")
    require_idle(c2, F32_FORMS, "on path J(i)")
    off = [f for f in J_FORMS if c2[f] != J_DP4 * c1[f]]
    if off:
        raise AssertionError(f"dp = 2 launches not twice dp = 1's: {off}")
    del tr2
    gc.collect()
    torch.cuda.empty_cache()
    return [c2]


def run_dp_tp_config2(dev, ds, cards=None) -> list:
    """Paths J(ii) and J(iii): config2's full-graph Trainer on dp = 4
    naming the card four times (512 pairs a shard), 20 steps against the
    Trainer without a mesh from the same initial parameters: step 1's loss
    within LOSS_RTOL, its parameters within DP_TOL, the flash-GAT forward
    and backward launched once a step; then config2's model on
    J_TP (dp, tp) meshes, one step from the same parameters against the
    no-mesh step 1 (TP_TOL). With ``cards`` (path M(iv)) the meshes lie
    over those cards (``spread_devices``; tp on M_TP): the replicated
    encode runs once a card, so the flash-GAT kernels launch once a card a
    step. Returns the counts of the dp = 4 run and of the tp steps."""
    from bignn_tpu_torch import prng
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import prepare_device_data
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.models.bignn import upload_buckets
    from bignn_tpu_torch.parallel import (
        gather_params_tp,
        make_mesh,
        shard_params_tp,
        spread_devices,
        tp_train_step_fn,
    )
    from bignn_tpu_torch.train import Trainer
    from bignn_tpu_torch.train.trainer import make_optimizer

    def devices(n):
        return [dev] * n if cards is None else spread_devices(n, cards)

    where = "path J" if cards is None else "path M(iv)"
    cfg = get_config("config2")
    data = prepare_device_data(ds)
    batches = _epoch_batches(data, cfg.train)
    runs = {}
    for dp in (J_DP2, None):
        mesh = (None if dp is None
                else make_mesh(dp=dp, graph=1, devices=devices(dp)))
        if mesh is not None:
            log(f"  dp = {dp} over {[str(d) for d in mesh.devices.flat]}")
            encodes = len(mesh.cards)  # the replicated encode, once a card
        reset_counts()
        tr = Trainer(BiGNN(cfg.model), data, cfg.train, device=dev,
                     mesh=mesh)
        tr.init(SEED)
        step1 = {}
        losses, grads = _timed_steps(tr, batches, f"dp = {dp or 'none'}",
                                     step1=step1)
        runs[dp] = (losses, step1, read_counts(), grads["outer.0.a_l"])
        del tr
    (l4, p4, n4, g4), (l1, p1, n1, g1) = runs[J_DP2], runs[None]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l4, l1))
    log(f"  losses dp = 4: {l4[0]:.6f} ... {l4[-1]:.6f}; without a mesh "
        f"{l1[0]:.6f} ... {l1[-1]:.6f}; max relative difference over "
        f"{len(l4)} steps {rel:.3e}")
    _check_loss1("dp = 4 against no mesh", l4[0], l1[0])
    _close_params("dp = 4 against no mesh", p4, p1, DP_TOL, (g4, g1))
    if not np.all(np.isfinite(l4)):
        raise AssertionError(f"dp = 4 losses {l4}")
    for form in FLASH_FORMS:
        if not n4[form] == encodes * n1[form] == encodes * len(batches):
            raise AssertionError(f"{form}: {n4[form]} launches on dp = 4, "
                                 f"{n1[form]} without a mesh, "
                                 f"{len(batches)} steps, {encodes} cards")

    log(f"  {where}: config2's model sharded over tp, one step")
    buckets, gidx = upload_buckets(data.bucketing, cfg.model.inner_layers,
                                   dev)
    outer = data.outer.to(dev)
    pairs, mask = batches[0]
    key = prng.fold_in(prng.fold_in(prng.key(cfg.train.seed + 1), 0), 0)
    reset_counts()
    for dp, tp in (J_TP if cards is None else M_TP):
        mesh = make_mesh(dp=dp, tp=tp, devices=devices(dp * tp))
        model = shard_params_tp(mesh, BiGNN(cfg.model, seed=SEED).to(dev))
        opt = make_optimizer(model.parameters(), cfg.train)
        t0 = time.perf_counter()
        loss = tp_train_step_fn(model, opt, mesh, data.num_drugs,
                                cfg.train.neg_ratio)(
            key, pairs, mask, buckets, gidx, outer).item()
        log(f"  (dp, tp) = ({dp}, {tp}): {len(list(model.parameters()))} "
            f"parameter tensors, first step {time.perf_counter() - t0:.3f} "
            "s")
        _check_loss1(f"tp ({dp}, {tp}) against no mesh", loss, l1[0])
        a_l = dict(model.named_parameters())["outer.0.a_l"].grad
        _close_params(f"tp ({dp}, {tp}) against no mesh",
                      gather_params_tp(model), p1, TP_TOL, (a_l, g1))
        del model, opt
    ct = read_counts()
    log(f"  launches on the tp steps: {ct}")
    require_launched(ct, FLASH_FORMS, f"on the tp steps of {where}")
    del buckets, gidx, outer, data
    gc.collect()
    torch.cuda.empty_cache()
    return [n4, ct]


def _dp_config3_step(dev) -> dict:
    """config3's host-drawn step on dp = 2 (batches (0, 0) and (0, 1),
    resident tables) against the union-batch reference on a trainer
    without a mesh from the same init: the loss within LOSS_RTOL, the
    gradients within GRAD_TOL. Returns the dp = 2 step's counts."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.parallel import make_mesh
    from bignn_tpu_torch.train import MinibatchTrainer

    cfg = get_config("config3")
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    trainers = [MinibatchTrainer(
        BiGNN(cfg.model), ds, cfg.train, fanouts=cfg.fanouts,
        max_drugs=cfg.max_drugs, mesh=mesh, device=dev)
        for mesh in (make_mesh(dp=2, graph=1, devices=[dev] * 2), None)]
    tr2, tr1 = trainers
    tr2.init(SEED)
    hbs = tr2._draw_host(at=(0, 0))
    reset_counts()
    loss2 = tr2.train_step(hbs).item()
    counts = read_counts()
    grads2 = {k: p.grad.clone() for k, p in tr2.model.named_parameters()}
    tr1.init(SEED)
    ref, grads1 = _union_reference(tr1, [b.to(dev) for b in hbs])
    _check_loss1("config3 host-drawn dp = 2 against the union-batch "
                 "reference", loss2, ref)
    _check_step1(grads2, grads1, loss2, ref, torch.float32)
    return counts


def run_dp_entry_points(dev) -> list:
    """Path J(iv): run.main on config2 (2 epochs) and on config3 with
    --exact-eval (1 epoch), each with --dp 2 and without, in-process on the
    default device; each run's seconds, losses, best epoch and test AUC.
    config2's --dp 2 run has the trajectory of the run without it: the same
    best epoch, epoch losses within DP_RUN_RTOL, test AUC within DP_RUN_AUC.
    config3's --dp 2 epoch draws dp * ceil(n / dp) of the n batches the run
    without it draws; its step is held by _dp_config3_step. Returns the
    counts of the --dp runs and of that step."""
    from bignn_tpu_torch import run

    counts, runs = [], {}
    for argv in (["--config", "config2", "--epochs", "2"],
                 ["--config", "config3", "--exact-eval", "--epochs", "1"]):
        for dp in (["--dp", "2"], []):
            reset_counts()
            res = _timed_main(run.main, argv + dp + FIRST_CARD,
                              "run " + " ".join(argv + dp))
            if dp:
                counts.append(read_counts())
            log(f"  losses {[r['loss'] for r in res['history']]}, best "
                f"epoch {res['best_epoch']}, test_auc {res['test_auc']:.6f}"
                + (f", exact test_auc {res['exact_test_auc']:.6f}"
                   if "exact_test_auc" in res else ""))
            aucs = [v for k, v in res.items() if k.endswith("_auc")]
            if not (all(np.isfinite(r["loss"]) for r in res["history"])
                    and all(0.0 < a < 1.0 for a in aucs)):
                raise AssertionError(f"run {argv + dp}: {res}")
            runs[argv[1], bool(dp)] = res
    require_launched(counts[0], FLASH_FORMS, "on run config2 --dp 2")

    got, want = runs["config2", True], runs["config2", False]
    losses = [(g["loss"], w["loss"]) for g, w in zip(got["history"],
                                                      want["history"])]
    worst = max(abs(g - w) / abs(w) for g, w in losses)
    log(f"  config2 --dp 2 against no --dp: epoch losses max relative "
        f"difference {worst:.3e} (bound {DP_RUN_RTOL:g}), test_auc "
        f"{got['test_auc'] - want['test_auc']:+.3e} (bound {DP_RUN_AUC:g})")
    if not (len(losses) == len(want["history"]) == 2
            and worst <= DP_RUN_RTOL
            and got["best_epoch"] == want["best_epoch"]
            and abs(got["test_auc"] - want["test_auc"]) <= DP_RUN_AUC):
        raise AssertionError(f"run config2 --dp 2 {got} against {want}")

    n = runs["config3", False]["history"][0]["batches_sampled"]
    n2 = runs["config3", True]["history"][0]["batches_sampled"]
    log(f"  config3: {n2} batches sampled on --dp 2, {n} without")
    if n2 != 2 * -(-n // 2):
        raise AssertionError(f"config3 --dp 2 sampled {n2} batches, {n} "
                             "without")
    log("  config3's host-drawn step on dp = 2")
    counts.append(_dp_config3_step(dev))
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _timed_main(main, argv: list, what: str):
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    log(f"  {what}: {time.perf_counter() - t0:.3f} s")
    return out


def _untimed(history: list) -> list:
    """Each epoch's record without its seconds."""
    return [{k: v for k, v in r.items() if not k.endswith("_s")}
            for r in history]


def _resume_epoch0(dev, cfg, state: dict, argv: list, run_dir: Path,
                   first: dict) -> None:
    """Path I(iii)'s epoch-0 checkpoint alone in a run dir of its own: its
    Adam state (keyed by parameter name) loads onto the card; ``run.main``
    resumes it to the uninterrupted run's epoch 1 and test AUC bit for
    bit."""
    from bignn_tpu_torch import run
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import CheckpointManager
    from bignn_tpu_torch.train.trainer import (
        load_optimizer_state,
        make_optimizer,
    )

    model = BiGNN(cfg.model).to(dev)
    opt = make_optimizer(model.parameters(), cfg.train)
    load_optimizer_state(opt, model, state["opt_state"])
    for n, p in model.named_parameters():
        s = opt.state[p]
        if not (s["exp_avg"].device == s["exp_avg_sq"].device == dev
                and float(s["step"]) > 0):
            raise AssertionError(f"{n}: Adam's state of epoch 0 loads as "
                                 f"{s['exp_avg'].device}, step {s['step']}")
    CheckpointManager(str(run_dir / "ckpt")).save_state(0, state)
    at = argv.index("--run-dir") + 1
    resumed = _timed_main(run.main, [*argv[:at], str(run_dir),
                                     *argv[at + 1:]],
                          "run config2 resumed from epoch 0")
    if (_untimed(resumed["history"]) != _untimed(first["history"][1:])
            or resumed["test_auc"] != first["test_auc"]):
        raise AssertionError(f"the resume from epoch 0 differs: {resumed} "
                             f"against {first}")
    log("  epoch 0's Adam state on the card; its resume equals the run's "
        "epoch 1 bit for bit")


def run_entry_points(dev) -> list:
    """Path I(iii), in-process: run.main on config2 (2 epochs, checkpoints
    every epoch) and again on the same run directory (it resumes, trains
    no epoch, reports the same best epoch and test AUC), and once more
    from the init with no run directory (the same history and test AUC,
    bit for bit: ROADMAP F7); its epoch-0 checkpoint resumed
    (``_resume_epoch0``); serve.main's
    --topk (with --exclude-known) and --pairs/--out on that checkpoint, bit
    for bit against a Scorer built by hand on its best parameters; run.main
    on config5 for one epoch (4 graph shards on the card). Returns the
    launch counts of the three training runs and of the two serves, and
    the config5 run's result (path K(ii)'s reference)."""
    import shutil

    from bignn_tpu_torch import run, serve
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.serve import Scorer
    from bignn_tpu_torch.train import CheckpointManager

    root = Path(__file__).resolve().parent / "build" / "smoke_runs"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--config", "config2", "--epochs", "2", "--run-dir",
            str(root / "config2"), "--checkpoint-every", "1"]
    counts = []
    reset_counts()
    first = _timed_main(run.main, argv, "run config2, 2 epochs")
    counts.append(read_counts())
    log(f"  losses {[r['loss'] for r in first['history']]}, best epoch "
        f"{first['best_epoch']}, test_auc {first['test_auc']:.6f}")
    require_launched(counts[-1], (
        "segment_sum:f32", "block_adjacency:f32", "flash_gat_attention:f32",
        "flash_gat_attention_bwd:f32"), "on run config2")
    reset_counts()
    again = _timed_main(run.main, argv, "run config2 again (resume)")
    counts.append(read_counts())
    if not (again["history"] == [] and again["best_epoch"]
            == first["best_epoch"] and again["test_auc"] == first["test_auc"]):
        raise AssertionError(f"the resumed run differs: {again}")
    fresh = _timed_main(run.main, ["--config", "config2", "--epochs", "2"],
                        "run config2 from the init again (no run dir)")
    if not (_untimed(fresh["history"]) == _untimed(first["history"])
            and fresh["test_auc"] == first["test_auc"]):
        raise AssertionError(
            "a seeded run did not repeat bit for bit (F7): "
            f"{_untimed(fresh['history'])} against "
            f"{_untimed(first['history'])}")

    ckpt = str(root / "config2" / "ckpt")
    cfg = get_config("config2")
    _resume_epoch0(dev, cfg, CheckpointManager(ckpt).restore_state(0),
                   argv, root / "epoch0", first)
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    best = CheckpointManager(ckpt).restore_state()["best_params"]
    hand = Scorer(BiGNN(cfg.model), ds, best, device=dev)
    pairs = np.concatenate([ds.split_edges("test"),
                            negatives(ds, ds.split_edges("test"))])
    np.save(root / "pairs.npy", pairs)
    reset_counts()
    ids, top = _timed_main(serve.main, [
        "--config", "config2", "--ckpt", ckpt, "--topk", "42,7", "--k",
        "20", "--exclude-known"], "serve --topk 42,7")
    scores = _timed_main(serve.main, [
        "--config", "config2", "--ckpt", ckpt, "--pairs",
        str(root / "pairs.npy"), "--out", str(root / "scores.npy")],
        "serve --pairs")
    counts.append(read_counts())
    want_ids, want_top = hand.top_k_batch([42, 7], 20, exclude_known=True)
    want = hand.score_pairs(pairs)
    if not (np.array_equal(ids, want_ids) and np.array_equal(top, want_top)
            and np.array_equal(scores, want)
            and np.array_equal(np.load(root / "scores.npy"), want)):
        raise AssertionError("serve.main differs from a Scorer built by "
                             "hand on the checkpoint")
    require_launched(counts[-1], ("segment_sum:f32", "block_adjacency:f32",
                                  "flash_gat_attention:f32"),
                     "on serve config2")
    del hand, ds

    reset_counts()
    p2 = _timed_main(run.main, ["--config", "config5", "--epochs", "1",
                                *FIRST_CARD],
                     "run config5, 1 epoch, 4 graph shards")
    counts.append(read_counts())
    log(f"  loss {p2['final_loss']:.5f}, test_auc {p2['test_auc']:.6f}")
    if not (np.isfinite(p2["final_loss"]) and np.isfinite(p2["test_auc"])):
        raise AssertionError(f"run config5: {p2}")
    require_launched(counts[-1], (
        "all_to_all:f32", "segment_softmax:f32", "segment_softmax_bwd:f32",
        "spmm_multihead:f32", "spmm_multihead_bwd:f32"), "on run config5")
    require_idle(counts[-1], ("flash_gat_attention:f32",), "on run config5")
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, p2


# ---------------------------------------------------------------------------
# path K: the multi-process p2 run, two processes on the one card
# ---------------------------------------------------------------------------

K_PROCS = 2
K_STEPS = 8  # of path G's batches
K_TIMEOUT = 300  # seconds for a pair of processes, start to exit
K_REPS = 20  # timed exchanges, plain versions, library calls, barriers
# path K(i)'s losses against path G's one-process run of the same batches:
# the gradients' partial sums are added in another order, and Adam carries
# the difference on (measured on the CPU, config5's model on 300 drugs, 8
# steps: 1.7e-6)
K_LOSS_RTOL = 1e-4
# path K(ii)'s epoch loss against the one-process run: path J's bound for
# a run whose gradients are summed in another order, DP_RUN_RTOL (measured:
# 4.2e-6 on the CPU at 300 drugs, 5.3e-5 on the card at config5's 65 steps)
K_RUN_RTOL = DP_RUN_RTOL
K_RUN_AUC = 5e-3
K_LOGS = Path(__file__).resolve().parent / "build" / "smoke_runs" / "k"
K_FORMS = ("all_to_all:f32:procs",
           *(f for f in P2_GAT_FORMS if f != "all_to_all:f32"))
# path K(v): the same step on the route between hosts
K_HOST_FORMS = ("all_to_all:f32:hosts", *K_FORMS[1:])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_card_env() -> dict | None:
    """Path K's processes share the first card wherever more are visible
    (their environment names it alone), so the path is the same on any
    machine; None (the parent's environment) on one card."""
    if torch.cuda.device_count() < 2:
        return None
    import os

    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return {**os.environ, "CUDA_VISIBLE_DEVICES": first}


def _spawn(argvs: list, what: str, env: dict | None = None) -> list[str]:
    """Run one process per argv from the repository root (environment
    ``env``, default the parent's), their output in files under
    build/smoke_runs/k; raises if any exits non-zero or the group
    outlives K_TIMEOUT, after killing every survivor. Returns each
    process's standard output."""
    root = Path(__file__).resolve().parent
    logs = K_LOGS
    logs.mkdir(parents=True, exist_ok=True)
    files, procs = [], []
    try:
        for r, argv in enumerate(argvs):
            out = open(logs / f"{what}_{r}.out", "w")
            err = open(logs / f"{what}_{r}.err", "w")
            files += [out, err]
            procs.append(subprocess.Popen(argv, cwd=root, stdout=out,
                                          stderr=err, env=env))
        deadline = time.monotonic() + K_TIMEOUT
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"path K {what}: the processes ran "
                                     f"past {K_TIMEOUT} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    texts = [(logs / f"{what}_{r}.out").read_text() for r in range(len(argvs))]
    for r, p in enumerate(procs):
        if p.returncode != 0:
            err = (logs / f"{what}_{r}.err").read_text()
            raise AssertionError(f"path K {what}: process {r} exited "
                                 f"{p.returncode}:\n{texts[r][-2000:]}\n"
                                 f"{err[-4000:]}")
    return texts


def _same_state(a, b) -> bool:
    """Whether two checkpoint states (nests of dicts, lists, tensors and
    numbers) are equal, tensors bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_state, a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).view(torch.uint8),
                                b.reshape(-1).view(torch.uint8)))
    return a == b


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _host_ms(fn, reps: int = K_REPS, cards=None) -> float:
    """Median host milliseconds of ``fn()`` up to a synchronize (of every
    one of ``cards``; default the current card)."""
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        for c in cards or [None]:
            torch.cuda.synchronize(c)
        secs.append(time.perf_counter() - t0)
    return float(np.median(secs) * 1e3)


def queued_ms(fn, reps: int = 100) -> float:
    """Mean device milliseconds per call of ``fn``, the calls queued behind
    a device sleep twice as long as the host takes to queue them, so that
    the host's cost of a call is hidden (as
    scripts/compare_kernel_trees.py's ``device_ms``)."""
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3 * reps / 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    end.synchronize()
    cycles_per_ms = 1_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(2 * queue_ms * cycles_per_ms))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k_exchange_times(exchange, bufs, reps: int = K_REPS) -> dict:
    """Path K(iv) in one process, at a step's own send buffers: every
    process at once, the whole exchange (IPC: staging copies, a launch a
    card, between synchronizes and barriers where processes share a card;
    K(v)'s route between
    hosts: host copies, ``all_to_all_single`` through gloo, the upload,
    one launch), its plain version (every process's whole send buffers
    gathered: through the staging buffers over IPC, through gloo on the
    route between hosts) and the library call (``torch.distributed.all_to_all_single`` on the same
    buffers, arranged by destination process beforehand on the first
    card, its result checked), each a median of host ms over ``reps``; the
    barrier (a synchronize and ``dist.barrier``); then the kernel alone
    (IPC's ``launch_staged``, or the host route's ``all_to_all_launch`` on
    this process's destinations, on the chunks it would have): on one card
    a process (path K, whose processes may share it; ``queued_ms``), each
    process in turn while the others wait; on several cards a process
    (path N), every process at once (``cards_queued_ms`` with a lead call:
    with the semaphores on the cards, a launch waits for every card's),
    with each card's kernel by ``torch.profiler`` (``kernel_by_card``,
    its waits on the cards included)."""
    import torch.distributed as dist

    from bignn_tpu_torch.ops import collectives

    L, G = len(bufs), exchange.num_shards
    inner = tuple(bufs[0].shape[1:])
    cards = exchange.cards
    ipc = isinstance(exchange, collectives.PeerExchange)
    whole = exchange.launch if ipc else exchange.exchange
    want = exchange.all_to_all_plain(bufs)
    sent = exchange.sent_bytes
    times = {"exchange_ms": _host_ms(lambda: whole(bufs), reps, cards),
             "plain_ms": _host_ms(lambda: exchange.all_to_all_plain(bufs),
                                  reps, cards)}
    # bytes through the process group for one exchange (0 over IPC)
    times["host_bytes"] = (exchange.sent_bytes - sent) // reps
    # [destination process, local source, local destination, S, F]
    inp = (torch.stack([b.to(exchange.device) for b in bufs])
           .view(L, exchange.size, L, *inner).transpose(0, 1).contiguous())
    out = torch.empty_like(inp)
    times["library_ms"] = _host_ms(lambda: dist.all_to_all_single(out, inp),
                                   reps)
    # out[p, i, j] = slot j of source p * L + i
    got = out.permute(2, 0, 1, 3, 4).reshape(L, G, *inner)
    if not all(torch.equal(got[jj], want[jj].to(got.device))
               for jj in range(L)):
        raise AssertionError("all_to_all_single differs from the exchange")

    def barrier():
        for c in cards:
            torch.cuda.current_stream(c).synchronize()
        dist.barrier()

    times["barrier_ms"] = _host_ms(barrier, reps)
    if ipc:
        exchange.launch(bufs)  # every staging buffer holds these buffers
        recv = [torch.empty_like(b) for b in bufs]

        def kernel():
            exchange.launch_staged(recv, bufs)
    else:
        # source i's chunks for this process's destinations, as they land
        sources = [torch.stack([w[i].to(exchange.device) for w in want])
                   for i in range(G)]
        recv = []

        def kernel():
            recv[:] = collectives.all_to_all_launch(
                sources, exchange.local[0], ":hosts")
    if len(cards) == 1:  # processes that may share a card: in turn
        for turn in range(exchange.size):
            dist.barrier()
            if turn == exchange.rank:
                times["kernel_ms"] = queued_ms(kernel)
            dist.barrier()
    else:  # every process's cards at once (their kernels wait on each other)
        dist.barrier()
        times["kernel_ms"] = cards_queued_ms(kernel, cards, lead=1)
        dist.barrier()
        times["kernel_by_card"] = kernel_ms_by_card(kernel, cards)
        _sync(cards)
    if not all(torch.equal(a, b.to(a.device)) for a, b in zip(recv, want)):
        raise AssertionError("the kernel alone differs from the plain "
                             "version")
    chunk = bufs[0][0].numel() * bufs[0].element_size()
    times["bytes"] = 2 * L * G * chunk  # this process's reads and writes
    return times


def n_exchange_large(seed: int = SEED) -> dict:
    """Path N(ii) at config5-large's send buffers (M_SHAPES' second: G 8,
    two shards a card over two cards a process): each source's buffer made
    on the first card from ``seed + i`` in every process, this process's
    moved to their cards; the exchange ``make_exchange`` picks equal to
    the plain version exactly, one launch a card; then timed as
    ``k_exchange_times`` times it, over 3 calls (the library call moves
    the 845 MB through gloo)."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.parallel import (
        make_exchange,
        make_hybrid_mesh,
        shard_device,
    )

    _, g, s_, f = M_SHAPES[1]
    mesh = make_hybrid_mesh(graph=g)
    exchange = make_exchange(mesh)
    first = mesh.first_device
    full = []
    for i in range(g):
        gen = torch.Generator(device=first).manual_seed(seed + i)
        full.append(torch.randn(g, s_, f, generator=gen, device=first))
    bufs = [full[j].to(shard_device(mesh, j)) for j in mesh.local_graph]
    reset_counts()
    got = ops.all_to_all(bufs, exchange)
    sync_all()
    by_card = dict(ops.all_to_all.launches_by_device)
    want = [torch.stack([full[i][j] for i in range(g)])
            for j in mesh.local_graph]
    err = max(float((a.to(first) - b).abs().max()) for a, b in zip(got, want))
    if not (all(torch.equal(a.to(first), b) for a, b in zip(got, want))
            and sorted(by_card) == sorted(str(c) for c in exchange.cards)
            and set(by_card.values()) == {1}):
        raise AssertionError(f"path N(ii) config5-large: the exchange "
                             f"differs from its plain version, or launched "
                             f"{by_card} on {exchange.cards}")
    del full, want, got
    times = k_exchange_times(exchange, bufs, reps=3)
    exchange.close()
    return {"max_abs_err": err, "launches_by_card": by_card,
            "route": type(exchange).__name__,
            "devices": [str(d) for d in exchange.devices], **times}


def k_worker_step(rank: int, port: int, route: str = "auto",
                  procs: int = K_PROCS, times: bool = True) -> dict:
    """One process of path K(i): config5 as get_config sets it, graph 4
    over K_PROCS processes on this card (make_hybrid_mesh: 2 shards each),
    dp 1, the first K_STEPS batches of path G from the same init and keys;
    the launch counts over those steps (and the exchange's by card); the
    first exchange across processes against its plain version, exactly;
    the times of K(iv). ``route``: ``auto``, the exchange
    ``make_exchange`` picks (on one host, ``PeerExchange``), or ``hosts``
    (path K(v)), the route between hosts (``ProcessExchange``) built
    directly. Where the process drives several cards (path N: 2 processes
    on four cards, two each, a shard a card), the same, with a replica a
    shard; and, with ``times``, path N(ii) at config5-large's send buffers
    (``n_exchange_large``) and each card's device busy over one more
    traced step and its peak memory."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.ops.collectives import ProcessExchange
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.parallel import (
        init_distributed,
        local_device,
        make_exchange,
        make_hybrid_mesh,
        shard_device,
    )

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    init_distributed(f"127.0.0.1:{port}", procs, rank)
    dev = local_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("config5")
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    mesh = make_hybrid_mesh(graph=cfg.graph_shards)
    cards = mesh.cards
    exchange = (ProcessExchange(mesh.shape["graph"], mesh.local_graph,
                                [shard_device(mesh, j)
                                 for j in mesh.local_graph])
                if route == "hosts" else make_exchange(mesh))
    log(f"process {rank}: {type(exchange).__name__}, mesh {mesh.shape}, "
        "processes "
        f"{mesh.processes.tolist()}, local shards {mesh.local_graph} on "
        f"{[str(shard_device(mesh, j)) for j in mesh.local_graph]}")
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    reset_counts()  # the upload's block builds count, as on path G
    _, _, plan_d = p2_layout(dev, ds, cfg.graph_shards,
                             cfg.model.inner_layers, mesh=mesh)
    model = BiGNN(cfg.model, seed=SEED).to(dev)
    trainer = P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d,
                        exchange=exchange)
    batches = _train_batches(ds, cfg.train)[:K_STEPS]
    rec, secs = FirstCall(ops.all_to_all), []
    with mock.patch.object(ops, "all_to_all", rec):
        losses, grads = _timed_steps(trainer, batches,
                                     f"{procs}-process p2 step", secs)
    K_LOGS.mkdir(parents=True, exist_ok=True)
    grads_file = K_LOGS / f"grads_{rank}.pt"
    torch.save({k: v.cpu() for k, v in grads.items()}, grads_file)
    launches = read_counts()
    by_card = dict(ops.all_to_all.launches_by_device)
    forms, other = ((K_HOST_FORMS, "all_to_all:f32:procs") if route == "hosts"
                    else (K_FORMS, "all_to_all:f32:hosts"))
    require_launched(launches, forms, f"in process {rank}")
    require_idle(launches, ("all_to_all:f32", "all_to_all:f32:cards", other,
                            *FLASH_FORMS), f"in process {rank}")
    if sorted(by_card) != sorted(str(c) for c in cards):
        raise AssertionError(f"process {rank}: the exchange launched on "
                             f"{by_card}, its cards are {cards}")
    want = exchange.all_to_all_plain(rec.bufs)
    err = max(float((a - b).abs().max()) for a, b in zip(rec.out, want))
    if not all(torch.equal(a, b) for a, b in zip(rec.out, want)):
        raise AssertionError("the first exchange across processes differs "
                             "from its plain version")
    digest = hashlib.sha256()
    for v in model.state_dict().values():
        digest.update(v.detach().cpu().numpy().tobytes())
    extra = {}
    if times:
        extra = k_exchange_times(exchange, rec.bufs)
        if len(cards) > 1:
            pairs, mask = batches[0]
            extra["busy_ms"] = busy_by_card(
                lambda: trainer.train_step(pairs, mask, 1, 0), cards)
            extra["peak_gib"] = _peaks(cards)
            extra["large"] = n_exchange_large()
    exchange.close()
    return {"rank": rank, "losses": losses, "digest": digest.hexdigest(),
            "grads": str(grads_file), "device": str(dev),
            "cards": [str(c) for c in cards],
            "route": type(exchange).__name__,
            "median_ms": float(np.median(secs) * 1e3), "max_abs_err": err,
            "launches": {f: n for f, n in launches.items() if n},
            "launches_by_card": by_card,
            "send": [tuple(rec.bufs[0].shape), len(rec.bufs)], **extra}


def _k_step_pair(what: str, route: str = "auto", procs: int = K_PROCS,
                 every_card: bool = False, times: bool = True) -> list[dict]:
    """``procs`` workers of ``k_worker_step``: path K's pair on the first
    card (``_one_card_env``) by default, or on every visible card
    (``every_card``: path M(vi)'s four, a card each; path N's two, two
    cards each)."""
    port = _free_port()
    extra = ([] if procs == K_PROCS else ["--procs", str(procs)]) + (
        [] if times else ["--no-times"])
    env = None if every_card else _one_card_env()
    outs = _spawn([[sys.executable, str(Path(__file__).resolve()),
                    "--worker", "step", "--rank", str(r), "--port",
                    str(port), "--route", route, *extra]
                   for r in range(procs)], what, env)
    return [_last_json(o) for o in outs]


def run_multiprocess(g_ref: dict, one_run: dict | None) -> list[dict]:
    """Path K: the multi-process p2 run, K_PROCS processes on this card.
    (i) ``k_worker_step`` in each, the losses against path G's
    (``g_ref``) within K_LOSS_RTOL, the step-1 gradients (summed over the
    processes) against path G's by ``_check_step1``, and both processes'
    parameters equal to the bit; (iii) the same pair again, the same
    bits; (v) the pair on the route between hosts (``--route hosts``:
    ``ProcessExchange`` through gloo on loopback), its losses and
    parameters equal to (i)'s bit for bit; (ii) ``python -m
    bignn_tpu_torch.run --config config5 --epochs 1 --checkpoint-every 1
    --coordinator ... --num-processes 2 --process-id i`` against the
    one-process ``run`` (``one_run``, or run here): the
    epoch loss within K_RUN_RTOL, the test AUC within K_RUN_AUC, the run
    dir written by process 0 alone; the same command with ``--epochs 2``
    resumes it and must equal a straight 2-epoch pair bit for bit (epoch
    records, result, last checkpoint); (iv) the times, (i)'s and (v)'s.
    Returns the kernels line's rows of ``all_to_all:f32:procs`` and
    ``all_to_all:f32:hosts``."""
    from bignn_tpu_torch import run

    t0 = time.perf_counter()
    log(f"  (i) config5's p2 step, graph 4 over {K_PROCS} processes, "
        f"{K_STEPS} steps")
    first = _k_step_pair("step")
    want = g_ref["losses"][:K_STEPS]
    for w in first:
        rel = max(abs(a - b) / abs(b) for a, b in zip(w["losses"], want))
        log(f"  process {w['rank']}: losses {w['losses']}, worst {rel:.3e} "
            f"off path G's (bound {K_LOSS_RTOL:g}); launches "
            f"{w['launches']}")
        if not (np.all(np.isfinite(w["losses"])) and rel <= K_LOSS_RTOL):
            raise AssertionError(f"path K(i): process {w['rank']}'s losses "
                                 f"{w['losses']} against path G's {want}")
    if first[0]["digest"] != first[1]["digest"] or (
            first[0]["losses"] != first[1]["losses"]):
        raise AssertionError("path K(i): the processes' parameters differ")
    # the gradients themselves: Adam's step hides one off by a constant
    # factor (a replicated parameter counted once a process, say)
    dev = next(iter(g_ref["grads"].values())).device
    log("  process 0's step-1 gradients, summed over the processes, against "
        "path G's:")
    _check_step1({k: v.to(dev) for k, v in
                  torch.load(first[0]["grads"]).items()}, g_ref["grads"],
                 first[0]["losses"][0], want[0], torch.float32)
    log(f"  both processes' parameters equal to the bit "
        f"({first[0]['digest'][:16]})")
    log("  (iii) the pair again from the same seed")
    second = _k_step_pair("step_again")
    for a, b in zip(first, second):
        if (a["digest"], a["losses"]) != (b["digest"], b["losses"]):
            raise AssertionError(f"path K(iii): process {a['rank']} did not "
                                 "repeat bit for bit")
    log("  repeated bit for bit")
    log("  (v) the pair again on the route between hosts (ProcessExchange: "
        "host copies, gloo all_to_all_single on loopback, one launch)")
    hosts = _k_step_pair("step_hosts", "hosts")
    for a, b in zip(first, hosts):
        if (a["digest"], a["losses"]) != (b["digest"], b["losses"]):
            raise AssertionError(
                f"path K(v): process {a['rank']}'s losses {b['losses']} "
                f"and parameters ({b['digest'][:16]}) on the route between "
                f"hosts against K(i)'s {a['losses']} ({a['digest'][:16]})")
    log("  losses and parameters equal to K(i)'s bit for bit")

    log("  (ii) run --config config5 over 2 processes: 1 epoch with a "
        "checkpoint, the same run dir resumed to 2 epochs, 2 epochs straight")
    root = Path(__file__).resolve().parent / "build" / "smoke_runs"
    if one_run is None:
        one_run = _timed_main(run.main, ["--config", "config5", "--epochs",
                                         "1", *FIRST_CARD],
                              "run config5, one process")
    import shutil

    from bignn_tpu_torch.train.checkpoint import CheckpointManager

    def cli(what: str, run_dir: Path, epochs: int):
        """The CLI pair; its seconds, run dir records, result and last
        checkpoint."""
        port = _free_port()
        t1 = time.perf_counter()
        _spawn([[sys.executable, "-m", "bignn_tpu_torch.run", "--config",
                 "config5", "--epochs", str(epochs), "--run-dir",
                 str(run_dir), "--checkpoint-every", "1", "--coordinator",
                 f"127.0.0.1:{port}", "--num-processes", str(K_PROCS),
                 "--process-id", str(r)] for r in range(K_PROCS)], what,
               _one_card_env())
        secs = time.perf_counter() - t1
        records = [json.loads(line) for line in
                   (run_dir / "metrics.jsonl").read_text().splitlines()]
        return (secs, records,
                json.loads((run_dir / "result.json").read_text()),
                CheckpointManager(str(run_dir / "ckpt")))

    run_dir, whole_dir = root / "k_cli", root / "k_cli_whole"
    for d in (run_dir, whole_dir):
        shutil.rmtree(d, ignore_errors=True)
    cli_s, records, got, ckpt = cli("cli", run_dir, 1)
    epochs = [r for r in records if "epoch" in r and "loss" in r]
    mesh = [r for r in records if r.get("event") == "mesh"]
    rel = abs(got["final_loss"] - one_run["final_loss"]) / abs(
        one_run["final_loss"])
    auc = abs(got["test_auc"] - one_run["test_auc"])
    log(f"  {cli_s:.3f} s for both processes (start to exit), the epoch "
        f"{epochs[0]['epoch_time_s']:.3f} s (one process: "
        f"{one_run['history'][0]['epoch_time_s']:.3f} s): loss "
        f"{got['final_loss']:.7f} against {one_run['final_loss']:.7f} "
        f"({rel:.3e}, bound {K_RUN_RTOL:g}), test AUC {got['test_auc']:.6f} "
        f"against {one_run['test_auc']:.6f} ({auc:.3e}, bound "
        f"{K_RUN_AUC:g})")
    if not (rel <= K_RUN_RTOL and auc <= K_RUN_AUC and len(epochs) == 1
            and sum(r.get("event") == "done" for r in records) == 1
            and len(mesh) == 1 and mesh[0]["processes"] == K_PROCS
            and ckpt.steps() == [0]):
        raise AssertionError(f"path K(ii): {got} against {one_run}; "
                             f"records {records}, checkpoints "
                             f"{ckpt.steps()}")
    resume_s, records, resumed, ckpt = cli("cli_resume", run_dir, 2)
    whole_s, whole_records, whole, whole_ckpt = cli("cli_whole", whole_dir,
                                                    2)

    def epoch_records(recs):
        return [{k: v for k, v in r.items()
                 if k not in ("epoch_time_s", "wall_s")}
                for r in recs if "epoch" in r and "loss" in r]

    log(f"  resumed {resume_s:.3f} s, straight {whole_s:.3f} s: "
        f"{resumed} against {whole}")
    if not (epoch_records(records) == epoch_records(whole_records)
            and resumed == whole and ckpt.steps() == whole_ckpt.steps()
            == [0, 1] and _same_state(ckpt.restore_state(),
                                      whole_ckpt.restore_state())):
        raise AssertionError(
            f"path K(ii): the resumed run {epoch_records(records)}, "
            f"{resumed} against the straight one "
            f"{epoch_records(whole_records)}, {whole}")
    log("  the resumed run equals the straight one bit for bit (epochs, "
        "result, last checkpoint)")
    for d in (run_dir, whole_dir):
        shutil.rmtree(d, ignore_errors=True)

    w = first[0]
    log(f"  (iv) two-process step median {w['median_ms']:.3f} ms, "
        f"{first[1]['median_ms']:.3f} ms against path G's one-process "
        f"{g_ref['median_ms']:.3f} ms; send buffers {w['send']}")
    log(f"  (v) two-process step on the route between hosts "
        f"{hosts[0]['median_ms']:.3f} ms, {hosts[1]['median_ms']:.3f} ms "
        "(K(i): above)")
    for what, pair in (("IPC, K(i)", first), ("hosts, K(v)", hosts)):
        for x in pair:
            log(f"  {what}, process {x['rank']}: exchange "
                f"{x['exchange_ms']:.4f} ms host (kernel {x['kernel_ms']:.4f}"
                f" ms device; {x['host_bytes']} bytes sent through gloo), "
                f"plain {x['plain_ms']:.4f} ms, all_to_all_single "
                f"{x['library_ms']:.4f} ms, barrier {x['barrier_ms']:.4f} ms")
    log(f"path K: {time.perf_counter() - t0:.1f} s on {card_line()}")
    source, tpu = KERNELS["all_to_all:f32"]
    rows = []
    for form, pair in (("all_to_all:f32:procs", first),
                       ("all_to_all:f32:hosts", hosts)):
        w = pair[0]
        b, by = bound_ms(w["bytes"])
        rows.append({
            "name": form, "route": "cuda", "source": source, "replaces": tpu,
            "launches": sum(x["launches"][form] for x in pair),
            "max_abs_err": max(x["max_abs_err"] for x in pair),
            "ms": w["kernel_ms"], "plain_ms": w["plain_ms"], "bound_ms": b,
            "bound_by": by, "library_ms": w["library_ms"],
            "exchange_ms": w["exchange_ms"], "barrier_ms": w["barrier_ms"],
            "host_bytes": w["host_bytes"]})
    return rows


# ---------------------------------------------------------------------------
# path M: one process over several cards, and path K a card a process
# ---------------------------------------------------------------------------

M_CARDS = 4  # the most cards path M lays a mesh over
M_TP = ((1, 4), (2, 2))  # path M(iv): (dp, tp) over the cards
# path M(i): (name, G, S, F), the send buffers of config5 (one shard a
# card on four) and of config5-large (two a card: local and peer chunks)
M_SHAPES = (("config5", 4, 432, 132), ("config5-large", 8, 12504, 132))
# path M(i) also spreads path G(iii)'s send buffers (config5 at 64 shards)
M_G64 = ("g64", G64, 32, 132)
M_REPS = 20
M_LOGS = K_LOGS.parent / "m"


def visible_cards() -> list[torch.device]:
    """The cards path M lays its meshes over: the first M_CARDS visible."""
    return [torch.device("cuda", i)
            for i in range(min(torch.cuda.device_count(), M_CARDS))]


def link_rate() -> float | None:
    """The cards' interconnect, logged from ``nvidia-smi topo -m`` and
    ``nvidia-smi nvlink -s``; returns card 0's NVLink rate in one
    direction (the sum of its links' GB/s), None where no link reports."""
    import re

    for argv in (["nvidia-smi", "topo", "-m"],
                 ["nvidia-smi", "nvlink", "-s", "-i", "0"]):
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=60)
        log(f"  $ {' '.join(argv)}")
        for line in (out.stdout + out.stderr).strip().splitlines():
            log(f"    {line}")
        if argv[1] == "nvlink":
            rates = [float(x) for x in
                     re.findall(r"([0-9.]+)\s*GB/s", out.stdout)]
    gbs = sum(rates)
    log(f"  card 0's NVLink: {len(rates)} links, {gbs:.3f} GB/s in one "
        "direction" if rates else "  card 0 reports no NVLink link")
    return gbs * 1e9 if rates else None


def _sync(cards) -> None:
    for c in cards:
        torch.cuda.synchronize(c)


def cards_ms(fn, cards, reps: int = M_REPS) -> float:
    """Device milliseconds per call of ``fn``, work on several cards: after
    a warm-up and a synchronize of every card, an event on each card's
    stream before the calls and after them; the slowest card's span."""
    for _ in range(3):
        fn()
    _sync(cards)
    starts = {c: torch.cuda.Event(enable_timing=True) for c in cards}
    ends = {c: torch.cuda.Event(enable_timing=True) for c in cards}
    for c in cards:
        starts[c].record(torch.cuda.current_stream(c))
    for _ in range(reps):
        fn()
    for c in cards:
        ends[c].record(torch.cuda.current_stream(c))
    _sync(cards)
    return max(starts[c].elapsed_time(ends[c]) for c in cards) / reps


def cards_queued_ms(fn, cards, reps: int = M_REPS, lead: int = 0) -> float:
    """Device milliseconds per call of ``fn``, work on several cards, with
    the host's cost hidden (as ``queued_ms``): the calls queued behind a
    device sleep on every card twice as long as the host takes to queue
    them, an event on each card after its sleep and ``lead`` calls (which
    take up a skew between processes that time their cards at once, each
    behind a sleep of its own) and one after the calls; the slowest card's
    span."""
    for _ in range(3):
        fn()
    _sync(cards)
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    _sync(cards)
    queue_ms = (time.perf_counter() - t0) * 1e3 * reps / 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(cards[0]):
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        end.synchronize()
    cycles = int(2 * queue_ms * 1_000_000 / start.elapsed_time(end))
    starts = {c: torch.cuda.Event(enable_timing=True) for c in cards}
    ends = {c: torch.cuda.Event(enable_timing=True) for c in cards}
    for c in cards:
        with torch.cuda.device(c):
            torch.cuda._sleep(cycles)
    for _ in range(lead):
        fn()
    for c in cards:
        starts[c].record(torch.cuda.current_stream(c))
    for _ in range(reps):
        fn()
    for c in cards:
        ends[c].record(torch.cuda.current_stream(c))
    _sync(cards)
    return max(starts[c].elapsed_time(ends[c]) for c in cards) / reps


def kernel_ms_by_card(fn, cards, reps: int = M_REPS) -> dict:
    """torch.profiler over ``reps`` calls of ``fn`` queued behind a sleep
    on every card, as ``cards_queued_ms`` queues them, after a warm-up:
    each card's device ms a call in row 9's kernel (``exchange`` in its
    name), the kernel alone, without the gaps between launches or what the
    streams wait on outside it (with the semaphores on the cards, its
    waits for the other cards are inside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    _sync(cards)
    t0 = time.perf_counter()
    fn()
    _sync(cards)
    cycles = int(4 * reps * (time.perf_counter() - t0) * 1e3 * 2_000_000)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in cards:
            with torch.cuda.device(c):
                torch.cuda._sleep(cycles)
        for _ in range(reps):
            fn()
        _sync(cards)
    out = {}
    for c in cards:
        out[str(c)] = sum(
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.device_index == c.index
            and "exchange" in e.name) / 1e3 / reps
    return out


def cards_bound(devices, chunk: int, rate: float | None) -> float:
    """Row 9 across cards: per card, the chunks it reads from peers over
    the NVLink rate in one direction, and its local bytes (its own chunks
    read, every receive slot written) over the memory rate, the larger of
    the two; the slowest card's. Without a link rate, the local bytes."""
    g, worst = len(devices), 0.0
    for c in set(devices):
        own = sum(d == c for d in devices)
        remote = (g - own) * own * chunk
        local = (own * own + g * own) * chunk
        t = local / HBM_BYTES_PER_S
        if rate:
            t = max(t, remote / rate)
        worst = max(worst, t * 1e3)
    return worst


def m_exchange(cards, rate: float | None,
               shapes=(*M_SHAPES, M_G64)) -> dict:
    """Path M(i): row 9 across the cards at ``shapes`` (M_SHAPES and M_G64),
    send buffers made from SEED on the host and put on their shards' cards
    (``spread_devices``): forward and backward (the exchange of
    cotangents) equal to ``all_to_all_plain`` exactly, one launch a card
    each way; then the exchange timed: device ms queued behind a sleep on
    every card (``cards_queued_ms``; the first such reading in a process
    runs several times high, so one is taken and discarded first), as the
    host paces it (``cards_ms``), the kernel on each card
    (``torch.profiler``, ``kernel_ms_by_card``: its waits on the other
    cards included; ``scripts/probe_variants.py`` kind ``a2a`` times the
    semaphores without the copy); its plain version; ``cards_bound``. No
    single PyTorch call exchanges between the cards of one process (NCCL's
    all-to-all takes a process a card), so the library time is null."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.parallel import spread_devices

    results = {}
    for name, g, s, f in shapes:
        devices = spread_devices(g, cards)
        used = list(dict.fromkeys(devices))
        gen = torch.Generator().manual_seed(SEED)
        host = [torch.randn(g, s, f, generator=gen) for _ in range(g)]
        ct = [torch.randn(g, s, f, generator=gen) for _ in range(g)]
        bufs = [b.to(d).requires_grad_() for b, d in zip(host, devices)]
        reset_counts()
        got = ops.all_to_all(bufs)
        torch.autograd.backward(got, [c.to(d) for c, d in zip(ct, devices)])
        _sync(used)
        launched = read_counts()["all_to_all:f32:cards"]
        want, want_g = ops.all_to_all_plain(host), ops.all_to_all_plain(ct)
        err = max(float((a.detach().cpu() - b).abs().max())
                  for a, b in zip(got, want))
        if not (all(a.device == d and torch.equal(a.detach().cpu(), b)
                    for a, b, d in zip(got, want, devices))
                and all(torch.equal(b.grad.cpu(), w)
                        for b, w in zip(bufs, want_g))
                and launched == 2 * len(used)):
            raise AssertionError(f"path M(i) {name}: the exchange across "
                                 f"{len(used)} cards differs from its plain "
                                 f"version, or launched {launched} times")
        chunk = s * f * 4
        fwd = [b.detach() for b in bufs]

        def exchange():
            return ops.all_to_all(fwd)

        first = cards_queued_ms(exchange, used)  # discarded
        ms = cards_queued_ms(exchange, used)
        plain_ms = cards_queued_ms(lambda: ops.all_to_all_plain(fwd), used)
        paced = cards_ms(exchange, used)
        by_card = kernel_ms_by_card(exchange, used)
        bound = cards_bound(devices, chunk, rate)
        key = ("all_to_all:f32:cards" if name == "config5"
               else f"all_to_all:f32:cards ({name})")
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by="bytes", library_ms=None,
                            exchange_ms=paced,
                            kernel_ms=max(by_card.values()),
                            kernel_by_card=by_card, first_ms=first)
        log(f"  {key}: G {g}, S {s}, F {f} over {len(used)} cards "
            f"({g // len(used)} shards a card, {chunk / 1e6:.3f} MB a "
            f"chunk): forward and backward equal to the plain version bit "
            f"for bit, {launched} launches; device ms queued behind a "
            f"sleep: exchange {ms:.4f} (the discarded first reading "
            f"{first:.4f}), plain {plain_ms:.4f}; the exchange paced by the "
            f"host (no sleep) {paced:.4f} ms; the kernel by card, its waits "
            f"on the cards included (torch.profiler) "
            + ", ".join(f"{c} {v:.4f}" for c, v in by_card.items())
            + f" ms; bound {bound:.4f} ms (bytes), no library call")
        del bufs, fwd, got
    return results


def _digest(model) -> str:
    digest = hashlib.sha256()
    for v in model.state_dict().values():
        digest.update(v.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def busy_by_card(run, cards) -> dict:
    """torch.profiler over ``run()``: each card's device-busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(cards)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        _sync(cards)
    busy = {}
    for c in cards:
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.device_index == c.index]
        busy[str(c)] = _busy_ms((e.time_range.start, e.time_range.end)
                                for e in events)
    return busy


def _peaks(cards) -> str:
    return ", ".join(f"{torch.cuda.max_memory_allocated(c) / 2**30:.3f}"
                     for c in cards) + " GiB"


def m_p2(cards, ds, g_ref: dict) -> tuple[dict, dict]:
    """Path M(ii): config5 as get_config sets it, its 4 graph shards over
    the cards (``spread_devices``: one a card on four) in one process,
    path G's first K_STEPS batches from the same init and keys: the losses
    within K_LOSS_RTOL of path G's, the step-1 gradients (replica 0's: the
    replicas' sum) within GRAD_TOL of path G's (``_check_step1``), every
    replica's parameters equal to the bit after each run, and a second
    run from the same seed equal to the first bit for bit;
    all_to_all:f32:cards and path G's other forms launched, the
    one-card all_to_all:f32 not. Then the step median, each card's device
    busy ms over one traced step and its peak memory. Returns the first
    run's counts and its losses and digest (path M(vi)'s reference)."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.parallel import make_mesh, spread_devices

    cfg = get_config("config5")
    mesh = make_mesh(dp=1, graph=cfg.graph_shards,
                     devices=spread_devices(cfg.graph_shards, cards))
    log(f"  mesh {mesh.shape} over {[str(d) for d in mesh.devices.flat]}")
    reset_counts()
    _, _, plan_d = p2_layout(cards[0], ds, cfg.graph_shards,
                             cfg.model.inner_layers, mesh=mesh)
    batches = _train_batches(ds, cfg.train)[:K_STEPS]
    runs = []
    for again in (False, True):
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        model = BiGNN(cfg.model, seed=SEED).to(cards[0])
        tr = P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d)
        secs = []
        losses, grads = _timed_steps(
            tr, batches, "p2 step over the cards" + (" again" if again
                                                     else ""), secs)
        if not again:
            counts = read_counts()
            peaks = _peaks(cards)
        reps = tr.step.replicas
        digests = [_digest(m) for m in reps.models]
        if len(set(digests)) != 1:
            raise AssertionError(f"path M(ii): the {len(digests)} replicas' "
                                 "parameters differ")
        runs.append((losses, grads, digests[0], secs, tr))
    (losses, grads, digest, secs, tr), (l2, _, d2, _, _) = runs
    log(f"  launches on path M(ii): {counts}")
    require_launched(counts, ("all_to_all:f32:cards", *K_FORMS[1:]),
                     "on path M(ii)")
    require_idle(counts, ("all_to_all:f32", "all_to_all:f32:procs",
                          "all_to_all:f32:hosts", *FLASH_FORMS),
                 "on path M(ii)")
    want = g_ref["losses"][:K_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    log(f"  losses {losses}, worst {rel:.3e} off path G's (bound "
        f"{K_LOSS_RTOL:g})")
    if not (np.all(np.isfinite(losses)) and rel <= K_LOSS_RTOL):
        raise AssertionError(f"path M(ii): losses {losses} against path "
                             f"G's {want}")
    log("  step-1 gradients (the replicas' sum) against path G's:")
    _check_step1(grads, g_ref["grads"], losses[0], want[0], torch.float32)
    if (l2, d2) != (losses, digest):
        raise AssertionError("path M(ii): a second run from the same seed "
                             f"gave {l2} ({d2[:16]}), the first {losses} "
                             f"({digest[:16]})")
    log(f"  {len(tr.step.replicas)} replicas equal to the bit "
        f"({digest[:16]}); the second run equal to the first bit for bit")
    pairs, mask = batches[0]
    busy = busy_by_card(lambda: tr.train_step(pairs, mask, 1, 0), cards)
    log(f"  path M(ii) step median {np.median(secs) * 1e3:.3f} ms (path G, "
        f"one card: {g_ref['median_ms']:.3f} ms); device busy over one "
        "traced step: "
        + ", ".join(f"{c} {b:.3f} ms" for c, b in busy.items())
        + f"; peak memory by card {peaks} on {card_line()}")
    return counts, {"losses": losses, "digest": digest,
                    "median_ms": float(np.median(secs) * 1e3)}


def m_config4(cards, ds, tr1) -> dict:
    """Path M(iii): config4 as get_config sets it on dp = 4 over the cards
    (one shard a card on four; each card draws its shards' batches on its
    own generator and trains its replica on them), step 1 against path
    J's union-batch reference on phase 9's dp = 1 trainer ``tr1`` (loss
    within LOSS_RTOL, gradients by _check_step1 in bf16); then J_CHUNKS
    chunks twice from the same init, the losses equal to the bit and the
    replicas' parameters equal to the bit, 4 x 16 batches sampled; the
    chunk medians / C4_CHUNK and each card's peak memory. Returns the
    first run's counts."""
    from bignn_tpu_torch.parallel import make_mesh, spread_devices

    mesh = make_mesh(dp=4, graph=1, devices=spread_devices(4, cards))
    log(f"  mesh {mesh.shape} over {[str(d) for d in mesh.devices.flat]}")
    tr4 = config4_trainer(cards[0], ds, mesh=mesh)
    tr4.init(SEED)
    loss4 = tr4.train_chunk_device(0, 0, 1)[0].item()
    grads4 = {k: p.grad.clone() for k, p in tr4.model.named_parameters()}
    tr1.init(SEED)
    d = tr1.dsampler
    ref, grads1 = _union_reference(
        tr1, [d.sample(tr1._dev_consts, d.key_at(0, s))[0] for s in range(4)])
    _check_loss1("dp = 4 over the cards against the union-batch reference",
                 loss4, ref)
    _check_step1(grads4, grads1, loss4, ref, torch.bfloat16)
    secs, peaks, runs = [], [], []
    for _ in range(2):
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        reset_counts()
        runs.append(_c4_run(tr4, secs, peaks))
        if len(runs) == 1:
            counts, card_peaks = read_counts(), _peaks(cards)
        digests = {_digest(m) for m in tr4._reps.models}
        if len(digests) != 1:
            raise AssertionError("path M(iii): the replicas' parameters "
                                 "differ")
    (losses, stats), (again, _) = runs
    log(f"  {J_CHUNKS * C4_CHUNK} steps: losses {losses[0]:.5f} ... "
        f"{losses[-1]:.5f}; stats {stats}; step time (chunk median / "
        f"{C4_CHUNK}) {np.median(secs) * 1e3 / C4_CHUNK:.3f} ms; peak "
        f"memory by card {card_peaks} on {card_line()}")
    log(f"  launches: {counts}")
    if not (np.all(np.isfinite(losses)) and np.array_equal(losses, again)):
        raise AssertionError(f"path M(iii): losses not finite or not "
                             f"repeated: {losses} against {again}")
    if stats.get("batches_sampled") != 4 * J_CHUNKS * C4_CHUNK:
        raise AssertionError(f"path M(iii) sampled {stats}")
    require_launched(counts, J_FORMS, "on path M(iii)")
    log("  the second run equal to the first bit for bit, the replicas "
        "equal to the bit")
    del tr4
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def m_entry_points(cards) -> list:
    """Path M(v): ``run.main`` over every visible card: config4 with --dp 4
    (one epoch cut to 8 steps, ``MinibatchTrainer.fit``'s
    ``steps_per_epoch`` set under the run; its graph cut to its
    max_drugs, 16,384, as phase 8 cuts it, so that the sampled evaluation
    of its val and test pairs takes seconds) and config5 (one epoch, its
    4 graph shards spread over the cards), each exiting normally with
    finite losses, AUCs in (0, 1) and its mesh over the cards. Returns the
    runs' counts."""
    from bignn_tpu_torch import run

    import shutil

    from bignn_tpu_torch.config import get_config

    def cut(name):  # config4's graph cut to its max_drugs, as phase 8's
        cfg = get_config(name)
        if name != "config4":
            return cfg
        return dataclasses.replace(cfg, dataset_kwargs=dict(
            cfg.dataset_kwargs, num_drugs=cfg.max_drugs))

    fit = run.MinibatchTrainer.fit

    def short_fit(self, *a, **k):  # an epoch of 8 steps
        return fit(self, *a, **{**k, "steps_per_epoch": 8})

    counts = []
    for argv in (["--config", "config4", "--dp", "4", "--epochs", "1"],
                 ["--config", "config5", "--epochs", "1"]):
        run_dir = M_LOGS / argv[1]
        shutil.rmtree(run_dir, ignore_errors=True)
        reset_counts()
        with mock.patch.object(run, "get_config", cut), \
                mock.patch.object(run.MinibatchTrainer, "fit", short_fit):
            res = _timed_main(run.main, [*argv, "--run-dir", str(run_dir)],
                              "run " + " ".join(argv))
        counts.append(read_counts())
        records = [json.loads(line) for line in
                   (run_dir / "metrics.jsonl").read_text().splitlines()]
        mesh = [r for r in records if r.get("event") == "mesh"]
        aucs = [v for k, v in res.items() if k.endswith("_auc")]
        log(f"  losses {[r['loss'] for r in res['history']]}, test_auc "
            f"{res['test_auc']:.6f}, mesh {mesh}")
        if not (all(np.isfinite(r["loss"]) for r in res["history"])
                and all(0.0 < a < 1.0 for a in aucs) and len(mesh) == 1
                and len(set(mesh[0]["devices"])) == min(4, len(cards))):
            raise AssertionError(f"run {argv}: {res}; mesh {mesh}")
        shutil.rmtree(run_dir, ignore_errors=True)
    require_launched(counts[1], ("all_to_all:f32:cards",),
                     "on run --config config5")
    return counts


def m_processes(cards, ref: dict) -> None:
    """Path M(vi): path K's worker as 4 processes, one card each
    (``init_distributed`` gives each its index among the host's
    processes), config5's graph 4 (one shard a process), the exchange
    ``make_exchange`` picks (``PeerExchange``: staging buffers on each
    card, read through peer access): every process's losses and
    parameters equal to path M(ii)'s bit for bit (a card in one process
    plays a process's part: ``parallel/comm.py``)."""
    t0 = time.perf_counter()
    outs = _k_step_pair("m_step", procs=4, every_card=True, times=False)
    for w in outs:
        log(f"  process {w['rank']} on {w['device']}: losses {w['losses']}, "
            f"parameters {w['digest'][:16]}, median step "
            f"{w['median_ms']:.3f} ms, launches {w['launches']}")
    if len({w["device"] for w in outs}) != min(4, len(cards)):
        raise AssertionError(f"path M(vi): devices {[w['device'] for w in outs]}")
    bad = [w["rank"] for w in outs
           if (w["losses"], w["digest"]) != (ref["losses"], ref["digest"])]
    if bad:
        raise AssertionError(f"path M(vi): processes {bad} differ from path "
                             f"M(ii)'s {ref['losses']} ({ref['digest'][:16]})")
    log(f"  every process's losses and parameters equal to path M(ii)'s bit "
        f"for bit ({time.perf_counter() - t0:.1f} s)")
    return [w["median_ms"] for w in outs]


# ---------------------------------------------------------------------------
# path N: several cards a process across processes
# ---------------------------------------------------------------------------

N_PROCS = 2  # processes of path N, each on N_CARDS // N_PROCS cards
N_CARDS = 4


def run_n(cards, m_ref: dict, m_medians: list, one_run: dict,
          rate: float | None) -> dict:
    """Path N: JAX's hybrid mesh over each process's own cards, N_PROCS
    processes of two cards each (``init_distributed``: a host's processes
    split its cards), path K's worker: (i) config5 as get_config sets it,
    graph 4 (a shard a card), path G's first K_STEPS batches: every
    process's losses and parameters equal to path M(ii)'s (``m_ref``) bit
    for bit, the exchange (``PeerExchange`` over two cards a process,
    ``all_to_all:f32:procs``) launched on both cards of each process, and
    a second pair equal to the first; (ii) row 9 across processes of
    several cards at config5's send buffers (the step's own) and
    config5-large's (``n_exchange_large``), exact, timed, bounded by
    ``cards_bound`` at ``rate``; (iii) the pair on the route between hosts
    (``--route hosts``) equal to (i) bit for bit; (iv) ``python -m
    bignn_tpu_torch.run --config config5 --epochs 1 --coordinator ...
    --num-processes 2`` on the default device: each process logs its two
    cards, the epoch loss within K_RUN_RTOL and the test AUC within
    K_RUN_AUC of the one-process run (``one_run``, path I(iii)). The step
    medians beside M(ii)'s and M(vi)'s, with each card's busy ms and peak.
    Returns the kernels line's row of the new form."""
    from bignn_tpu_torch.parallel import spread_devices

    t0 = time.perf_counter()
    log(f"  (i) config5's p2 step, graph 4 over {N_PROCS} processes of "
        f"{N_CARDS // N_PROCS} cards, {K_STEPS} steps")
    first = _k_step_pair("n_step", procs=N_PROCS, every_card=True)
    for w in first:
        log(f"  process {w['rank']} on {w['cards']} ({w['route']}): losses "
            f"{w['losses']}, parameters {w['digest'][:16]}, launches "
            f"{w['launches']}, the exchange by card {w['launches_by_card']}")
        if len(set(w["cards"])) != N_CARDS // N_PROCS or (
                w["route"] != "PeerExchange"):
            raise AssertionError(f"path N(i): process {w['rank']} drove "
                                 f"{w['cards']} by {w['route']}")
        if sorted(w["launches_by_card"]) != sorted(w["cards"]) or min(
                w["launches_by_card"].values()) <= 0:
            raise AssertionError(f"path N(i): process {w['rank']}'s "
                                 "exchange did not launch on each of its "
                                 f"cards: {w['launches_by_card']}")
    if len({c for w in first for c in w["cards"]}) != N_CARDS:
        raise AssertionError(f"path N(i): cards {[w['cards'] for w in first]}")
    bad = [w["rank"] for w in first
           if (w["losses"], w["digest"]) != (m_ref["losses"], m_ref["digest"])]
    if bad:
        raise AssertionError(f"path N(i): processes {bad} differ from path "
                             f"M(ii)'s {m_ref['losses']} "
                             f"({m_ref['digest'][:16]})")
    log("  every process's losses and parameters equal to path M(ii)'s bit "
        f"for bit ({m_ref['digest'][:16]})")
    log("  (i) the pair again from the same seed")
    again = _k_step_pair("n_step_again", procs=N_PROCS, every_card=True,
                         times=False)
    log("  (iii) the pair on the route between hosts (ProcessExchange: "
        "host copies from each card, gloo all_to_all_single, a launch a "
        "card)")
    hosts = _k_step_pair("n_step_hosts", "hosts", procs=N_PROCS,
                         every_card=True, times=False)
    for what, pair in (("(i) again", again), ("(iii)", hosts)):
        for a, b in zip(first, pair):
            if (a["digest"], a["losses"]) != (b["digest"], b["losses"]):
                raise AssertionError(
                    f"path N{what}: process {a['rank']}'s losses "
                    f"{b['losses']} ({b['digest'][:16]}) against (i)'s "
                    f"{a['losses']} ({a['digest'][:16]})")
    log("  both equal to (i) bit for bit")

    log("  (iv) run --config config5 over 2 processes on the default device")
    run_dir = Path(__file__).resolve().parent / "build" / "smoke_runs" / "n"
    import shutil

    shutil.rmtree(run_dir, ignore_errors=True)
    port = _free_port()
    t1 = time.perf_counter()
    texts = _spawn([[sys.executable, "-m", "bignn_tpu_torch.run", "--config",
                     "config5", "--epochs", "1", "--run-dir", str(run_dir),
                     "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                     str(N_PROCS), "--process-id", str(r)]
                    for r in range(N_PROCS)], "n_cli")
    cli_s = time.perf_counter() - t1
    logged = [[line for line in text.splitlines()
               if line.startswith("wall_s=") and "event=mesh" in line]
              for text in texts]
    got = json.loads((run_dir / "result.json").read_text())
    rel = abs(got["final_loss"] - one_run["final_loss"]) / abs(
        one_run["final_loss"])
    auc = abs(got["test_auc"] - one_run["test_auc"])
    for r, lines in enumerate(logged):
        log(f"  process {r}: {lines}")
    log(f"  {cli_s:.3f} s for both processes: loss {got['final_loss']:.7f} "
        f"against {one_run['final_loss']:.7f} ({rel:.3e}, bound "
        f"{K_RUN_RTOL:g}), test AUC {got['test_auc']:.6f} against "
        f"{one_run['test_auc']:.6f} ({auc:.3e}, bound {K_RUN_AUC:g})")
    import ast

    # the record's last key: this process's cards
    two_cards = [len(lines) == 1 and len(set(ast.literal_eval(
        lines[0].split("local_devices=")[1]))) == N_CARDS // N_PROCS
        for lines in logged]
    if not (all(two_cards) and rel <= K_RUN_RTOL and auc <= K_RUN_AUC):
        raise AssertionError(f"path N(iv): {got} against {one_run}; mesh "
                             f"records {logged}")
    shutil.rmtree(run_dir, ignore_errors=True)

    w = first[0]
    log(f"  step median {first[0]['median_ms']:.3f} ms, "
        f"{first[1]['median_ms']:.3f} ms (two processes of two cards) "
        f"against path M(ii)'s {m_ref['median_ms']:.3f} ms (one process "
        f"over four) and M(vi)'s {', '.join(f'{m:.3f}' for m in m_medians)}"
        " ms (four processes of one); busy over one traced step "
        + "; ".join(f"process {x['rank']}: "
                    + ", ".join(f"{c} {b:.3f} ms"
                                for c, b in x["busy_ms"].items())
                    + f", peak {x['peak_gib']}" for x in first))
    # (ii) the exchange, at both shapes
    shapes = {"config5": (M_SHAPES[0], w), "config5-large": (M_SHAPES[1],
                                                             w["large"])}
    row = {}
    for name, ((_, g, s_, f), x) in shapes.items():
        bound = cards_bound(spread_devices(g, cards[:N_CARDS]), s_ * f * 4,
                            rate)
        by_card = x["kernel_by_card"]
        log(f"  (ii) {name}: G {g} over {N_PROCS} processes of two cards, "
            f"exact; process 0: launches {x['kernel_ms']:.4f} ms device "
            f"(every process's cards at once, queued behind a sleep), the "
            f"kernel by card, its waits on the cards included "
            f"(torch.profiler) "
            + ", ".join(f"{c} {v:.4f}" for c, v in by_card.items())
            + f" ms; the whole exchange {x['exchange_ms']:.4f} ms host, plain "
            f"{x['plain_ms']:.4f} ms, all_to_all_single (gloo) "
            f"{x['library_ms']:.4f} ms, a host barrier (synchronize and "
            f"gloo) {x['barrier_ms']:.4f} ms; bound {bound:.4f} ms (bytes)")
        vals = dict(ms=x["kernel_ms"], plain_ms=x["plain_ms"],
                    bound_ms=bound, library_ms=x["library_ms"],
                    exchange_ms=x["exchange_ms"],
                    barrier_ms=x["barrier_ms"],
                    kernel_ms=max(by_card.values()))
        if name == "config5":
            row.update(vals, max_abs_err=max(y["max_abs_err"] for y in first))
        else:
            row.update({f"{k}_config5_large": v for k, v in vals.items()},
                       max_abs_err_config5_large=max(
                           y["large"]["max_abs_err"] for y in first),
                       launches_by_card_config5_large=[
                           y["large"]["launches_by_card"] for y in first])
    log(f"path N: {time.perf_counter() - t0:.1f} s on {card_line()}")
    source, tpu = KERNELS["all_to_all:f32:procs"]
    return {"name": "all_to_all:f32:procs:cards", "route": "cuda",
            "source": source, "replaces": tpu,
            "launches": sum(x["launches"]["all_to_all:f32:procs"]
                            for x in first),
            "bound_by": "bytes", **row,
            "launches_by_card": [x["launches_by_card"] for x in first]}


# ---------------------------------------------------------------------------
# path O: a wide BI-GNN, configs 2 and 4 with wider layer specs
# ---------------------------------------------------------------------------

# W1 (config2 and config4): OGB's molecular GIN width inside (emb_dim 300,
# examples/graphproppred/mol), GAT's PPI layers outside (4 heads of 256,
# Velickovic et al. 2018, section 3.3); W2 (config4): the same inside,
# Graphormer's base width and heads outside (768, 32; Ying et al. 2021)
WIDE_INNER = ("gin:300", "gin:300")
WIDE_OUTER = {"W1": ("gat:1024:4:identity",),
              "W2": ("dotattn:768:32:identity",)}
WIDE_SHAPES = {"W1": (4, 256), "W2": (32, 24)}  # (heads, head_dim) outside
O_STEPS = 10  # O(ii): config2's full-graph steps with W1
O_CHUNKS = 2  # O(iii): config4's chunks of C4_CHUNK steps, W1 and W2
O_FULL_STEPS = 4  # O(iv): config4's model with W1 on 16,384 drugs


def wide_config(name: str, wide: str):
    """Config ``name`` with ``wide``'s layer specs (its dtype, readout,
    scorer, data and trainer as registered)."""
    from bignn_tpu_torch.config import get_config

    cfg = get_config(name)
    return get_config(name, model=dataclasses.replace(
        cfg.model, inner_layers=WIDE_INNER, outer_layers=WIDE_OUTER[wide]))


def wide_multihead_forms(dev, results: dict, tag: str, outer, n: int,
                         heads: int, head_dim: int, dtypes) -> None:
    """Rows 4 and 8 at ``heads`` x ``head_dim`` over an outer edge list of
    ``n`` drugs, in each of ``dtypes`` (seeded scores, values, cotangents),
    against their plain versions (``_compare``, kernel time queued), as
    ``<form>:<dtype>:<tag>``; row 4 only where heads are above 8."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.ops import cuda_lib

    gen = torch.Generator(device=dev).manual_seed(SEED)
    e = outer.edge_cap
    dst, src = outer.edge_dst, outer.edge_src
    perm, ssorted = outer.edge_src_perm, outer.edge_src_sorted
    log(f"  kernels at N {n}, E {e}, H {heads}, D {head_dim}")
    s32 = 3 * torch.randn(e, heads, device=dev, generator=gen)
    g32 = torch.randn(e, heads, device=dev, generator=gen)
    v32 = torch.randn(n, heads, head_dim, device=dev, generator=gen)
    gv32 = torch.randn(n, heads, head_dim, device=dev, generator=gen)
    for dt in dtypes:
        t = cuda_lib.dtype_name(dt)
        bf16 = dt == torch.bfloat16
        s, g_e, v, gv = (x.to(dt) for x in (s32, g32, v32, gv32))
        if heads > 8:
            _compare(results, f"segment_softmax:{t}:{tag}",
                     lambda: ops.segment_softmax(s, dst, n),
                     lambda: ops.segment_softmax_plain(s, dst, n),
                     BF16_STEP if bf16 else SPARSE_TOL, nbytes(s, dst),
                     library=softmax_library(s, dst, n), per_element=bf16,
                     queued=True)
            kernel, plain, a_k, num_bytes = softmax_bwd_calls(s, g_e, dst, n)
            _compare(results, f"segment_softmax_bwd:{t}:{tag}", kernel,
                     plain, BF16_STEP if bf16 else BWD_TOL, num_bytes,
                     library=softmax_library(a_k, dst, n, g_e),
                     per_element=bf16, queued=True)
            del kernel, plain, a_k
        alpha = ops.segment_softmax_plain(s, dst, n)
        width = heads * head_dim
        _compare(results, f"spmm_multihead:{t}:{tag}",
                 lambda: ops.spmm_multihead(v, src, dst, alpha, n),
                 lambda: ops.spmm_multihead_plain(v, src, dst, alpha, n),
                 BF16_TOL if bf16 else SPARSE_TOL,
                 nbytes(v, src, dst, alpha), 2 * e * width,
                 library=multihead_library(src, dst, alpha, n, v),
                 queued=True, gathered=gathered_rows(dst, n, width, dt))
        mh = (v, src, dst, alpha, n, gv, perm, ssorted)
        _compare(results, f"spmm_multihead_bwd:{t}:{tag}",
                 lambda: ops.spmm_multihead_bwd(*mh),
                 lambda: ops.spmm_multihead_bwd_plain(*mh),
                 BF16_TOL if bf16 else BWD_TOL,
                 nbytes(v, dst, alpha, gv, perm, ssorted), 4 * e * width,
                 library=multihead_library(src, dst, alpha, n, v, gv),
                 queued=True, gathered=gathered_rows(dst, n, width, dt))
        del s, g_e, v, gv, alpha, mh
        torch.cuda.empty_cache()


def run_wide_config2(dev, ds, outer_host) -> tuple[dict, dict]:
    """O(i) rows 3 and 3b at config2's mask with W1's outer heads (H 4, D
    256), then O(ii): config2 with W1, O_STEPS full-graph steps through
    the kernels from the JAX init of SEED, step 1 against the same step
    with the plain versions; the losses fall. Returns the steps' launch
    counts and the kernel comparisons."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.data import prepare_device_data
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    cfg = wide_config("config2", "W1")
    heads, head_dim = WIDE_SHAPES["W1"]
    results = {}
    n = ds.num_drugs
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cnt = torch.as_tensor(outer_host.dense_cnt, device=dev)
    sl = torch.randn(n, heads, device=dev, generator=gen)
    sr = torch.randn(n, heads, device=dev, generator=gen)
    v = torch.randn(n, heads, head_dim, device=dev, generator=gen)
    log(f"  kernels at config2's mask: N {n}, H {heads}, D {head_dim}")
    out, lse = ops.flash_gat_attention(sl, sr, v, cnt)
    err = _check_close("flash_gat_attention:f32:d256", (out, lse),
                       ops.flash_gat_attention_plain(sl, sr, v, cnt),
                       FLASH_TOL)
    flops, tf32_flops = flash_fwd_flops(n, heads, head_dim)
    record(results, "flash_gat_attention:f32:d256", err, FLASH_TOL,
           lambda: ops.flash_gat_attention(sl, sr, v, cnt),
           lambda: ops.flash_gat_attention_plain(sl, sr, v, cnt),
           nbytes(sl, sr, v, cnt, out, lse), flops, tf32_flops=tf32_flops,
           queued=True)
    g = torch.randn(n, heads, head_dim, device=dev, generator=gen)
    args = (sl, sr, v, cnt, lse, out, g)
    got = ops.flash_gat_attention_bwd(*args)
    err = _check_close("flash_gat_attention_bwd:f32:d256", got,
                       ops.flash_gat_attention_bwd_plain(*args), BWD_TOL)
    flops, tf32_flops = flash_bwd_flops(n, heads, head_dim)
    record(results, "flash_gat_attention_bwd:f32:d256", err, BWD_TOL,
           lambda: ops.flash_gat_attention_bwd(*args),
           lambda: ops.flash_gat_attention_bwd_plain(*args),
           nbytes(*args, *got), flops, tf32_flops=tf32_flops, queued=True)
    del cnt, sl, sr, v, out, lse, g, args, got
    torch.cuda.empty_cache()

    data = prepare_device_data(ds)
    batches = _epoch_batches(data, cfg.train)[:O_STEPS]
    log(f"  O(ii): config2 with W1 ({', '.join(cfg.model.inner_layers)} -> "
        f"{cfg.model.readout} -> {cfg.model.outer_layers[0]} -> "
        f"{cfg.model.scorer}), {len(batches)} steps")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(BiGNN(cfg.model), data, cfg.train, device=dev)
    params0, _ = trainer.init(SEED)
    losses, grads = _timed_steps(trainer, batches, "kernels")
    launches = read_counts()
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches: { {k: v for k, v in launches.items() if v} }")
    require_launched(launches, ("flash_gat_attention:f32",
                                "flash_gat_attention_bwd:f32",
                                "segment_sum:f32", "block_adjacency:f32"),
                     "on path O(ii)")
    _check_learning(losses, grads)
    with plain_ops():
        plain = Trainer(BiGNN(cfg.model), data, cfg.train, device=dev)
        plain.model.load_state_dict(params0)
        plain_losses, plain_grads = _timed_steps(plain, batches[:1],
                                                 "plain versions")
    _check_step1(grads, plain_grads, losses[0], plain_losses[0],
                 torch.float32)
    if abs(losses[0] - plain_losses[0]) > 1e-4 * max(1.0,
                                                     abs(plain_losses[0])):
        raise AssertionError(f"path O(ii) step-1 loss {losses[0]} against "
                             f"{plain_losses[0]}")
    return launches, results


def run_wide_config4(dev, ds) -> tuple[dict, dict]:
    """O(iii): config4's MinibatchTrainer (bf16, device-sampled, 100,000
    drugs) with W1 and with W2: rows 4 and 8 at the batch (0, 0)'s outer
    edges and W's heads against their plain versions (O(i); float32 off the
    path beside them), step 1 against the plain versions (a GAT's a_l by
    its bf16 noise), then O_CHUNKS chunks of C4_CHUNK steps timed, with
    their launches. Returns W -> launch counts, and the comparisons."""
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import MinibatchTrainer

    counts, results = {}, {}
    for wide in ("W1", "W2"):
        cfg = wide_config("config4", wide)
        heads, head_dim = WIDE_SHAPES[wide]
        inner = ", ".join(cfg.model.inner_layers)
        log(f"  O(iii) {wide}: config4 with {inner} -> "
            f"{cfg.model.outer_layers[0]}, {cfg.model.dtype}")
        t0 = time.perf_counter()
        tr = MinibatchTrainer(
            BiGNN(cfg.model, seed=SEED), ds, cfg.train, fanouts=cfg.fanouts,
            max_drugs=cfg.max_drugs, dispatch_chunk=cfg.dispatch_chunk,
            device_sample=cfg.device_sample, device=dev)
        log(f"  MinibatchTrainer build {time.perf_counter() - t0:.3f} s")
        d = tr.dsampler
        tr.init(SEED)
        cb, _ = d.sample(tr._dev_consts, d.key_at(0, 0))
        outer = tr._derive_outer(cb)
        wide_multihead_forms(dev, results, wide.lower(), outer,
                             cb.drug_budget, heads, head_dim,
                             (torch.bfloat16, torch.float32))
        del outer
        _step1_vs_plain(tr, cb, witness=True)
        del cb
        tr.init(SEED)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, secs = [], []
        for c in range(O_CHUNKS):
            t0 = time.perf_counter()
            ls, _ = tr.train_chunk_device(0, c * C4_CHUNK, C4_CHUNK)
            sync_all()
            secs.append(time.perf_counter() - t0)
            losses.append(ls)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = torch.cat(losses).float().cpu().numpy()
        log(f"  {wide}: losses " + " ".join(f"{x:.5f}" for x in losses))
        log(f"  {wide}: chunks " + " ".join(f"{x * 1e3:.3f}" for x in secs)
            + f" ms; step {secs[-1] * 1e3 / C4_CHUNK:.3f} ms (last chunk / "
            f"{C4_CHUNK}); peak device memory {peak:.2f} GiB on "
            f"{card_line()}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"path O(iii) {wide}: non-finite loss")
        # GAT's scores are bf16; DotAttn's softmax runs on float32 scores
        t = "bf16" if wide == "W1" else "f32"
        require_launched(launches, (
            "segment_sum:bf16", "block_adjacency:int8",
            f"segment_softmax:{t}", f"segment_softmax_bwd:{t}",
            "spmm_multihead:bf16", "spmm_multihead_bwd:bf16",
            "gather_rows_sorted_grad_bwd:bf16"), f"on path O(iii) {wide}")
        counts[wide] = launches
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    return counts, results


def run_wide_full(dev) -> tuple[dict, dict]:
    """O(iv): config4's model with W1 (bf16) in the full-graph Trainer on
    16,384 drugs, whose largest buckets lie above the block-dense threshold
    and take row 6: first row 6 at F 300 (W1's inner width; bf16 and
    float32, unweighted and weighted) at the largest bucket against its
    plain versions, then O_FULL_STEPS steps through the kernels (no plain
    step here: the plain multi-head backward would hold five [E, 1024]
    float32 tensors, ~54 GB at this graph's 2.6M edges). Returns their
    launch counts and the comparisons."""
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    cfg = wide_config("config4", "W1")
    t0 = time.perf_counter()
    data = prepare_device_data(load_dataset(cfg.dataset,
                                            num_drugs=cfg.max_drugs))
    log(f"  O(iv): {cfg.max_drugs} drugs, data + layouts "
        f"{time.perf_counter() - t0:.2f} s")
    results = {}
    big = max(data.bucketing.batches, key=lambda b: b.node_cap)
    for dt in (torch.bfloat16, torch.float32):
        results.update(block_spmm_kernels(dev, big, dt, feat=300))
        torch.cuda.empty_cache()
    batches = _epoch_batches(data, cfg.train)[:O_FULL_STEPS]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(BiGNN(cfg.model), data, cfg.train, device=dev)
    trainer.init(SEED)
    losses, grads = _timed_steps(trainer, batches, "kernels")
    launches = read_counts()
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB on {card_line()}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    require_launched(launches, (
        "block_spmm:bf16:tiled", "block_spmm_bwd:bf16:tiled",
        "segment_sum:bf16", "segment_softmax:bf16",
        "segment_softmax_bwd:bf16", "spmm_multihead:bf16",
        "spmm_multihead_bwd:bf16"), "on path O(iv)")
    _check_learning(losses, grads, fall=False)
    del trainer, data
    gc.collect()
    torch.cuda.empty_cache()
    return launches, results


# ---------------------------------------------------------------------------
# path L: the samplers' learning gate on the card
# ---------------------------------------------------------------------------

# JAX tests/test_device_vs_host_learning.py:21-47, as
# tests/test_torch_learning.py takes them
L_DATA = dict(num_drugs=150, feat_dim=16, avg_degree=10.0, min_atoms=4,
              max_atoms=12, latent_dim=4, seed=7)
L_MODEL = dict(feat_dim=16, dim=32, heads=2)
L_TRAIN = dict(lr=3e-3, epochs=10, batch_size=48, eval_every=10)
L_TRAINER = dict(fanouts=(6,), calibrate_caps=4, dispatch_chunk=4)
L_SEEDS = (0, 1, 2)
L_STEPS = 16
L_GATE_AUC = 0.58
L_GATE_DELTA = 0.03
L_FORMS = ("segment_sum:f32", "block_adjacency:int8", "segment_softmax:f32",
           "segment_softmax_bwd:f32", "spmm_multihead:f32",
           "spmm_multihead_bwd:f32")


def run_learning_gate(dev) -> list:
    """Path L: JAX's device-vs-host learning gate on the card, three seeds
    a mode; the device sampler draws from the card's ``torch.Generator``
    and the steps run the kernels. Returns each mode's launch counts."""
    from bignn_tpu_torch.config import TrainConfig
    from bignn_tpu_torch.data import make_synthetic_ddi
    from bignn_tpu_torch.models import BiGNN, BiGNNConfig
    from bignn_tpu_torch.train import MinibatchTrainer

    t0 = time.perf_counter()
    ds = make_synthetic_ddi(**L_DATA)
    means, counts = {}, []
    for mode, device_sample in (("device", True), ("host", False)):
        torch.cuda.synchronize()
        reset_counts()
        aucs = []
        for seed in L_SEEDS:
            tr = MinibatchTrainer(
                BiGNN(BiGNNConfig.full_bignn(**L_MODEL)), ds,
                TrainConfig(seed=seed, **L_TRAIN),
                device_sample=device_sample, device=dev, **L_TRAINER)
            _, result = tr.fit(steps_per_epoch=L_STEPS)
            aucs.append(result["test_auc"])
        launches = read_counts()
        require_launched(launches, L_FORMS, f"on path L ({mode})")
        counts.append(launches)
        means[mode] = float(np.mean(aucs))
        log(f"  {mode}-sampled test AUC by seed "
            f"{[round(a, 4) for a in aucs]}")
    delta = means["device"] - means["host"]
    log(f"path L: mean test AUC device {means['device']:.4f}, host "
        f"{means['host']:.4f}, device - host {delta:+.4f} (gate: both >= "
        f"{L_GATE_AUC}, |delta| <= {L_GATE_DELTA}); "
        f"{time.perf_counter() - t0:.1f} s on {card_line()}")
    if not (min(means.values()) >= L_GATE_AUC
            and abs(delta) <= L_GATE_DELTA):
        raise AssertionError(f"path L: the learning gate failed: {means}")
    return counts


def worker(argv: list) -> int:
    """``--worker step --rank R --port P [--route hosts] [--procs N
    --no-times]``: one process of path K(i) (or K(v), of path M(vi)'s
    four, or of path N's two, each on its share of the visible cards);
    its result is the last line of its output."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py --worker")
    ap.add_argument("kind", choices=["step"])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--route", choices=["auto", "hosts"], default="auto")
    ap.add_argument("--procs", type=int, default=K_PROCS)
    ap.add_argument("--no-times", dest="times", action="store_false")
    args = ap.parse_args(argv)
    print(json.dumps(k_worker_step(args.rank, args.port, args.route,
                                   args.procs, args.times)), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return worker(sys.argv[2:])
    profiling = sys.argv[1:] == ["--profile"]
    if sys.argv[1:] and not profiling:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    t_start = time.perf_counter()
    dev = check_device()
    # path M's cards: every visible card up to M_CARDS, none on one card
    cards = visible_cards() if torch.cuda.device_count() >= 2 else []
    log("== build")
    build_kernels()

    from bignn_tpu_torch import native
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.sparse import bucket_graphs, build_outer_graph

    log(f"native host library loaded: {native.available()} "
        f"({native.LIB_PATH.name})")
    t0 = time.perf_counter()
    ds = load_dataset("drugbank")
    log(f"dataset {ds.name}: {ds.num_drugs} drugs, "
        f"{sum(m.num_nodes for m in ds.molecules)} atoms, "
        f"{len(ds.edges)} DDI edges ({len(ds.train_idx)} train), "
        f"{time.perf_counter() - t0:.2f} s")
    bucketing = bucket_graphs(ds.molecules)
    train = ds.split_edges("train")
    outer = build_outer_graph(train[:, 0], train[:, 1], ds.num_drugs)

    if profiling:
        from bignn_tpu_torch.config import get_config
        from bignn_tpu_torch.data import prepare_device_data

        log("== profile: config2 training step, full width")
        cfg = get_config("config2")
        profile_training(dev, cfg.model, prepare_device_data(ds), cfg.train)
        log("== profile: config4's model served over 100,000 drugs")
        large = load_large()
        profile_sparse_serving(dev, large)
        gc.collect()
        torch.cuda.empty_cache()
        log("== profile: config4's model, training step on 16,384 drugs")
        cfg, model_cfg = sparse_config()
        data = prepare_device_data(load_dataset(cfg.dataset,
                                                num_drugs=cfg.max_drugs))
        profile_training(dev, model_cfg, data, cfg.train)
        del data
        gc.collect()
        torch.cuda.empty_cache()
        log("== profile: config4's step (MinibatchTrainer, bf16, "
            "device-sampled)")
        profile_config4(dev, large)
        gc.collect()
        torch.cuda.empty_cache()
        log("== profile: path H, config5-large's p2 step, 8 graph shards")
        profile_p2(dev, large, "config5-large")
        del large
        gc.collect()
        torch.cuda.empty_cache()
        log("== profile: path A, config2 training step, molecules up to 160 "
            "atoms")
        cfg = get_config("config2")
        profile_training(dev, cfg.model, prepare_device_data(
            load_dataset("drugbank", max_atoms=160)), cfg.train)
        log("== profile: path D, config3's step")
        profile_config3(dev)
        log("== profile: path G, config5's p2 step, 4 graph shards")
        profile_p2(dev, ds, "config5")
        return 0

    log("== kernels vs plain (config2 shapes)")
    results = compare_kernels(dev, ds, bucketing, outer)

    log("== serving path: config2 served by Scorer")
    counts = [run_serving(dev, ds)]
    log("== training path: config2 Trainer, full width")
    counts.append(run_training(dev, ds))
    log("== config2-real through the kernels")
    run_real_gate(dev)
    log("== sparse serving: config4's model over 100,000 drugs")
    large = load_large()
    served, fwd, scorer = run_sparse_serving(dev, large)
    ref_f32 = scorer.embeddings.clone()  # the plain refresh of phase 7
    log("== phase 7b: config4's model as configured (bf16) over 100,000 "
        "drugs")
    served_bf16, fwd_bf16 = run_sparse_serving_bf16(dev, large, scorer)
    ref_bf16 = scorer.embeddings.float()  # the plain refresh of phase 7b
    del scorer
    gc.collect()
    torch.cuda.empty_cache()
    log("== path H: config5-large, p2 on 8 graph shards of one card, "
        "100,000 drugs")
    p2_large, a2a = run_p2_large(dev, large, ref_f32, ref_bf16)
    del ref_f32, ref_bf16
    gc.collect()
    torch.cuda.empty_cache()
    log("== sparse training: config4's model, full graph of 16,384 drugs")
    trained, bwd = run_sparse_training(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("== config4's step: MinibatchTrainer, bf16, device-sampled, 100,000 "
        "drugs")
    stepped, c4, c4_trainer = run_config4_step(dev, large)
    counts += [served, served_bf16, p2_large, *trained, stepped]
    log("== path I(i): config4's exact evaluation after phase 9's 512 steps")
    path_i0 = time.perf_counter()
    counts.append(run_exact_config4(c4_trainer))
    path_i_s = time.perf_counter() - path_i0
    log("== path J: data and feature parallelism, the card named several "
        "times; (i) config4 on dp = 2")
    path_j0 = time.perf_counter()
    path_j = run_dp_config4(dev, large, c4_trainer)
    path_m = []
    if cards:
        log(f"== path M(iii): config4 on dp = 4 over {len(cards)} cards, "
            "beside phase 9's trainer")
        path_m.append(m_config4(cards, large, c4_trainer))
    del c4_trainer
    gc.collect()
    torch.cuda.empty_cache()
    log("== path O: the wide BI-GNN (GIN 300, GAT 4 x 256, DotAttn 32 "
        "heads); (i) the widened forms, (ii) config2 with W1")
    path_o0 = time.perf_counter()
    o2, o_res = run_wide_config2(dev, ds, outer)
    log("== path O(iii): config4's step with W1 and with W2, 100,000 drugs")
    o3, o3_res = run_wide_config4(dev, large)
    del large
    gc.collect()
    torch.cuda.empty_cache()
    log("== path O(iv): config4's model with W1, full graph of 16,384 drugs")
    o4, o4_res = run_wide_full(dev)
    for r in (o3_res, o4_res):
        o_res.update(r)
    counts += [o2, o3["W1"], o3["W2"], o4]
    path_o_s = time.perf_counter() - path_o0
    path_j0 += path_o_s  # path J's own seconds leave path O's out
    log(f"path O: {path_o_s:.1f} s on {card_line()}")
    log("== path J(ii): config2's Trainer on dp = 4; (iii) tp")
    path_j += run_dp_tp_config2(dev, ds)
    if cards:
        log(f"== path M(iv): config2's Trainer on dp = 4, and tp, over "
            f"{len(cards)} cards")
        path_m += run_dp_tp_config2(dev, ds, cards)
    log("== path J(iv): run --dp 2, config2 and config3 --exact-eval")
    path_j += run_dp_entry_points(dev)
    counts += path_j
    log(f"path J: {time.perf_counter() - path_j0:.1f} s on {card_line()}; "
        "launches " + ", ".join(f"{f} {sum(c[f] for c in path_j)}"
                                for f in KERNELS
                                if any(c[f] for c in path_j)))
    gc.collect()
    torch.cuda.empty_cache()
    log("== path A: config2 and config1 streaming, molecules up to 160 atoms")
    streamed, spmm = run_streaming(dev)
    log("== path C: config2 with the max readout, 20 steps f32, 20 bf16")
    maxed, smax = run_max_readout(dev, ds, bucketing)
    log("== path D: config3's MinibatchTrainer on molecules up to 160 atoms")
    sampled = run_config3(dev)
    log("== path E: config4 host-sampled, 16,384 drugs up to 160 atoms")
    hosted, spmm_bf16 = run_config4_host(dev)
    log("== path F: GAT inner, DotAttn outer, 20 steps on each route")
    attended = run_attention(dev, ds)
    log("== path G: config5, p2 on 4 graph shards of one card; G(ii): GCN "
        "and GIN outer layers")
    p2_counts, a2a_small, g_ref = run_p2(dev, ds)
    log(f"== path G(iii): config5 at {G64} graph shards of one card")
    g64_counts, a2a_g64 = run_p2_g64(dev, ds)
    counts += [*streamed, *maxed, *sampled, hosted, *attended, *p2_counts,
               g64_counts]
    log("== path I(ii): config3's exact scores, resident and not, against "
        "the full-graph Trainer")
    path_i0 = time.perf_counter()
    counts.append(run_exact_config3(dev))
    log("== path I(iii): the entry points, run.main and serve.main")
    entry_counts, one_run = run_entry_points(dev)
    counts += entry_counts
    path_i_s += time.perf_counter() - path_i0
    log(f"path I: {path_i_s:.1f} s on {card_line()}")
    log(f"== path K: the multi-process p2 run, {K_PROCS} processes on this "
        "card")
    gc.collect()
    torch.cuda.empty_cache()
    k_rows = run_multiprocess(g_ref, one_run)
    m_results, m_main = {}, []
    if cards:
        path_m0 = time.perf_counter()
        log(f"== path M: one process over {len(cards)} cards; (i) row 9 "
            "across the cards")
        m_rate = link_rate()
        m_results = m_exchange(cards, m_rate)
        log("== path M(ii): config5's p2 step, its 4 graph shards over the "
            "cards")
        m2, m_ref = m_p2(cards, ds, g_ref)
        log("== path M(v): run --dp 4 (config4) and run --config config5 "
            "over the cards")
        m5 = m_entry_points(cards)
        log("== path M(vi): path K as 4 processes, a card each")
        m_medians = m_processes(cards, m_ref)
        m_main = [m2, m5[1]]  # the exchange at config5's shapes
        path_m += [m2, *m5]
        counts += path_m
        log(f"path M: {time.perf_counter() - path_m0:.1f} s after path K "
            f"(M(iii) and M(iv) ran beside path J) on {card_line()}")
    else:
        log("== path M: needs two or more cards, this machine shows "
            f"{torch.cuda.device_count()}: not run")
    n_row = None
    if len(cards) >= N_CARDS:
        log(f"== path N: {N_PROCS} processes of {N_CARDS // N_PROCS} cards "
            "each, JAX's hybrid mesh over each process's own cards")
        n_row = run_n(cards, m_ref, m_medians, one_run, m_rate)
    else:
        log(f"== path N: needs {N_CARDS} cards, this machine shows "
            f"{torch.cuda.device_count()}: not run")
    log("== path L: the samplers' learning gate, 3 seeds a mode")
    counts += run_learning_gate(dev)
    for r in (fwd, fwd_bf16, bwd, c4, spmm, smax, spmm_bf16, a2a, a2a_small,
              a2a_g64, o_res):
        results.update(r)

    def row(name: str, form: str, paths) -> dict:
        r = results[name]
        source, tpu = KERNELS[form]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": sum(c[form] for c in paths),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    kernels = [row(form, form, counts) for form in KERNELS
               if form not in ("all_to_all:f32:procs",
                               "all_to_all:f32:hosts",
                               "all_to_all:f32:cards")
               and not form.endswith(":tiled")]
    # the exchange timed at config5's send buffers too, with the launches
    # of paths G and G(ii), which give it that shape; then across the
    # processes of path K, at config5's send buffers, with their launches:
    # through CUDA IPC (K(i)) and on the route between hosts (K(v))
    kernels.append(row("all_to_all:f32 (config5)", "all_to_all:f32",
                       p2_counts))
    # and at path G(iii)'s 64 shards (the launch's table on the card), with
    # that run's launches
    kernels.append(row("all_to_all:f32 (g64)", "all_to_all:f32",
                       [g64_counts]))
    kernels += k_rows
    # across the cards of one process (path M): at config5's send buffers,
    # with the launches of M(ii) and of M(v)'s config5 run, and the
    # numbers at config5-large's beside them; on one card nothing ran
    source, tpu = KERNELS["all_to_all:f32:cards"]
    cards_row = {"name": "all_to_all:f32:cards", "route": "cuda",
                 "source": source, "replaces": tpu,
                 "launches": sum(c["all_to_all:f32:cards"] for c in m_main),
                 **{k: None for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")}}
    if m_results:
        cards_row.update(m_results["all_to_all:f32:cards"])
        for tag, shape in (("config5_large", "config5-large"),
                           ("g64", "g64")):
            more = m_results[f"all_to_all:f32:cards ({shape})"]
            cards_row.update({f"{k}_{tag}": v for k, v in more.items()
                              if k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "exchange_ms",
                                       "kernel_ms")})
    else:
        cards_row["note"] = "path M needs two or more cards"
    kernels.append(cards_row)
    # across processes of two cards each (path N): at config5's send
    # buffers, with N(i)'s launches, config5-large's beside them; on fewer
    # than four cards nothing ran
    if n_row is None:
        source, tpu = KERNELS["all_to_all:f32:procs"]
        n_row = {"name": "all_to_all:f32:procs:cards", "route": "cuda",
                 "source": source, "replaces": tpu, "launches": 0,
                 **{k: None for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")},
                 "note": f"path N needs {N_CARDS} cards"}
    kernels.append(n_row)
    # rows 4 and 8 at the other shapes the paths give them, each with the
    # launches of the paths that run that shape: the 100K graph in bf16
    # (7b), the 16,384-drug graph (8 in f32, 8b in bf16), shard 0 of path
    # H's plan, config4's sampled batch in float32 (no path: its step runs
    # bf16)
    for name, form, paths in (
            ("segment_softmax:bf16:100k", "segment_softmax:bf16",
             [served_bf16]),
            ("spmm_multihead:bf16:100k", "spmm_multihead:bf16",
             [served_bf16]),
            ("segment_softmax:f32:16k", "segment_softmax:f32", trained[:1]),
            ("segment_softmax:bf16:16k", "segment_softmax:bf16", trained[2:]),
            ("segment_softmax_bwd:bf16:16k", "segment_softmax_bwd:bf16",
             trained[2:]),
            ("spmm_multihead:f32:shard", "spmm_multihead:f32", [p2_large]),
            ("segment_softmax:f32:config4", "segment_softmax:f32", [stepped]),
            ("segment_softmax_bwd:f32:config4", "segment_softmax_bwd:f32",
             [stepped]),
            # row 7 at path G(ii)'s GIN split, with the GIN run's launches
            ("spmm_sorted_coo:f32:hub", "spmm_sorted_coo:f32:weighted",
             p2_counts[-1:]),
            ("spmm_sorted_coo_bwd:f32:hub",
             "spmm_sorted_coo_bwd:f32:weighted", p2_counts[-1:])):
        kernels.append(row(name, form, paths))
    # path O's widened forms at its shapes, each with the launches of the
    # path that runs that shape (none for a form off the path: W2's
    # softmax in bf16, the multi-head forms in float32 at config4's batch;
    # row 6 at F 300 counts its tiled forms on O(iv), whose bf16 model runs
    # the unweighted bf16 ones alone)
    for name, form, paths in (
            ("flash_gat_attention:f32:d256", "flash_gat_attention:f32",
             [o2]),
            ("flash_gat_attention_bwd:f32:d256",
             "flash_gat_attention_bwd:f32", [o2]),
            ("spmm_multihead:bf16:w1", "spmm_multihead:bf16", [o3["W1"]]),
            ("spmm_multihead_bwd:bf16:w1", "spmm_multihead_bwd:bf16",
             [o3["W1"]]),
            ("spmm_multihead:f32:w1", "spmm_multihead:f32", []),
            ("spmm_multihead_bwd:f32:w1", "spmm_multihead_bwd:f32", []),
            ("segment_softmax:f32:w2", "segment_softmax:f32", [o3["W2"]]),
            ("segment_softmax_bwd:f32:w2", "segment_softmax_bwd:f32",
             [o3["W2"]]),
            ("segment_softmax:bf16:w2", "segment_softmax:bf16", []),
            ("segment_softmax_bwd:bf16:w2", "segment_softmax_bwd:bf16", []),
            ("spmm_multihead:bf16:w2", "spmm_multihead:bf16", [o3["W2"]]),
            ("spmm_multihead_bwd:bf16:w2", "spmm_multihead_bwd:bf16",
             [o3["W2"]]),
            ("spmm_multihead:f32:w2", "spmm_multihead:f32", []),
            ("spmm_multihead_bwd:f32:w2", "spmm_multihead_bwd:f32", []),
            *((f"block_spmm{b}:{t}{w}:f300", f"block_spmm{b}:{t}{w}:tiled",
               [o4]) for t in ("bf16", "f32") for b in ("", "_bwd")
              for w in ("", ":weighted"))):
        kernels.append(row(name, form, paths))
    log(f"smoke: {time.perf_counter() - t_start:.1f} s from start to the "
        "kernels line")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
