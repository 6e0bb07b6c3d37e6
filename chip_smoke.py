#!/usr/bin/env python3
"""Drive the PyTorch port's GCN, GAT and GraphSAGE serving paths, its
node-classifier training, its LM serving (every arch of
`configs.ARCHS`: the dense, MoE, SSM, hybrid, encoder-decoder and
vision-prefix families), its serving examples and its LM training on one
NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
last line; there is no CPU path):

  1. build — compile every CUDA kernel of the path from
     `src/repro_torch/kernels/csrc/` (one nvcc per source, in parallel),
     print ptxas's register/shared-memory lines, and count the tensor-core
     instructions of the redesigned libraries in their SASS
     (`cuobjdump -sass`): HGMMA and UTMALDG in flash_attention's bf16
     route, HMMA ... TF32 in block_matmul, in the three GAT libraries
     (gat_attention, fused_gat_full, fused_gat_precombined), in
     fused_sage, in the GCN layers (fused_gcn_dense, fused_gcn_grasp) and
     in bitmap_spmm (the GraSp walk), IMMA in the two int8 libraries
     (int8_matmul, fused_gcn_int8); a count of 0 fails. Beside them, four
     timing variants of block_matmul's tile (tc_gemm_tile.cuh's
     TC_GEMM_PRODUCTS, TC_GEMM_SPLIT and TC_SPLIT_INT), four of the GAT
     attention body
     (gat_tile.cuh's GAT_PRODUCTS and GAT_EXP, and TC_SPLIT_INT) and five
     of fused_sage (fused_sage.cu's SAGE_WALK, SAGE_COMBINE,
     SAGE_SELF_LOOP, SAGE_NEIGH_LOOP and SAGE_SPLIT), timed in phase 24
     (`[breakdown]`);
  2. kernels — `block_matmul` and `fused_gcn_dense` (both 3xTF32 on the
     tensor cores; the layer at every activation) against their plain
     PyTorch versions at the serving shapes (4 Cora-sized graphs padded to
     3072 nodes, features 1433 -> 1536, widths padded to 128), each also
     against float64 within twice cuBLAS's fp32 error, and
     `int8_matmul` (the int8 tier's four products) and `fused_gcn_int8`
     (both layers) at the same shapes with a real Cora calibration, where
     they must equal their plain versions bit for bit;
  3. serving — a GraphServe on the card with the Cora 2-layer GCN four
     times, on CacheG (the default, as in phases 4–6): each request's
     structure crosses as bit-packed adjacency and is materialized on the
     card, so `operand_bytes_h2d` must equal the compact forms of the
     one-shot requests and of the attached graph's first query (its
     second query is a cache hit and ships nothing). The fp32 path: `gcn` with `fusion="layer"` (fused_gcn_dense)
     and `gcn_mm` with `use_pallas` (block_matmul). The int8 path: `gcn_q`
     (tiers fp32 + int8, `fusion="layer"`, fused_gcn_int8) and `gcn_qmm`
     (a tier dict with `use_pallas`, int8_matmul), both calibrated on Cora
     first. Cora and five Planetoid-like graphs go to each model, and one
     graph per path is attached and queried twice. Each path runs with
     every launch count set to 0 just before it; the counts read just
     after must equal what its dispatched batches imply, and every logit
     is held against a forward through the plain versions over the
     host-built Â;
  4. serve-grasp — a second GraphServe with the same Cora GCN weights on
     the GraSp backend: `gcn_sp` (`agg_backend="grasp"`,
     `fusion="layer"`, fused_gcn_grasp) and `gcn_sp_auto`
     (`agg_backend="auto"`, bitmap_spmm with the combine as x @ w) get five
     clustered graphs and Cora, `gcn_dense` the clustered graphs, and one
     clustered graph is attached to `gcn_sp` and queried twice. Before it,
     `bitmap_spmm` and `fused_gcn_grasp` are held against their plain
     versions at both buckets' serving shapes and budgets, once with NaN in
     every padded tail block. Launch counts (set to 0 just before the
     phase) must match its batch log, `backend_fallbacks` the ineligible
     forced requests, and every logit the plain forward and the dense
     model. Each graph's backend decision is printed under core/costs.py's
     constants and under the SIMT-tile constants they replaced;
  5. serve-gat — `gat_attention`, `fused_gat_full` and
     `fused_gat_precombined` against their plain versions at both buckets'
     4-graph serving shapes (layer 1: 8 heads of 8 over 1433 features;
     layer 2: 1 head of 7), with NodePad's all -1e9 rows, a 32-row block
     whose first 64 columns are all -1e9, and a ragged 1000-node graph
     through `kernels.ops`; then a third GraphServe with the paper's Cora
     GAT twice, calibrated on Cora: `gat` (tiers fp32 and int8,
     `fusion="layer"`: fused_gat_full, fused_gat_precombined) and `gat_mm`
     (the same tiers with `use_pallas`, `fusion="none"`: gat_attention,
     and int8_matmul for the int8 combine). Each model and tier gets Cora
     and the five Planetoid-like graphs, and one 900-node graph attached
     and queried twice. Launch counts (set to 0 just before the phase)
     must match its batch log and every logit the plain forward (an int8
     request layer by layer) over the host-built masks, which the masks
     materialized on the card must equal exactly;
  6. serve-sage — `sage_max` (bit for bit) and `fused_sage` (mean and max,
     none and relu) against their plain versions at both buckets' 4-graph
     serving shapes, with real `sage_sample_adjacency` masks (NodePad's
     rows empty), a row whose every column is set, and NaN in the pooled
     rows that no mask row selects; then a fourth GraphServe with the
     paper's Cora GraphSAGE four times, each calibrated on Cora:
     `sage_max` (tiers fp32 and int8+grax, `fusion="layer"`: fused_sage;
     the int8 tier does not fuse), `sage_max_mm` (the same tiers with
     grax3 and `use_pallas`: sage_max, and int8_matmul for the int8
     combines), `sage_mean` (fp32 and int8, `fusion="layer"`) and
     `sage_mean_mm` (`use_pallas`: block_matmul, int8_matmul). Each model
     and tier gets Cora and the five Planetoid-like graphs, and one
     900-node graph attached and queried twice. Launch counts (set to 0
     just before the phase) must match its batch log and every logit the
     plain forward (an int8 request layer by layer) over the host-built
     sample, which the materialized masks must equal exactly;
  7. intake — each host piece of a request's intake at buckets 1024 and
     3072 (pad_graph; the edge keys, symmetry check, SymG pack and degree
     GraphServe runs, and the dense-matrix versions beside them; the
     compact upload; the materializer, by CUDA events and from the host;
     the eager upload of Â), the host link's pinned and pageable rates
     (`core/costs.py`'s `transfer_cost`), and phase 3's fp32 GCN burst
     with `use_cacheg=False` and with CacheG, three runs each in turns
     after one untimed burst each:
     intake_s, operand bytes, device_busy_s, p50/p99. The bytes must be
     each path's own, and CacheG's intake may not exceed the eager one's
     beyond the runs' spread; then, printed, three bursts each beside
     one busy-looping process per core, CacheG also with the
     `Tensor.pin_memory` staging it had before `pinned_copy`;
  8. cacheg — the masks and Â the card materializes for GCN, GAT and
     SAGE at both buckets against the host's (masks bit for bit, Â
     within 1e-6), then five attached cap-3072 GCN graphs churned under a
     budget that holds two: resident <= budget and evictions == spilled +
     dropped after every step, the spilled forms in pinned memory, each
     re-query answering bit for bit as its first answer while moving only
     compact bytes, and `assert_warm()`;
  9. delta — GrAd edge deltas on attached cap-3072 graphs: Cora to the
     Cora GCN (tiers fp32 and int8, `fusion="layer"`: fused_gcn_dense,
     fused_gcn_int8) and to the Cora GAT (fp32 and int8: fused_gat_full,
     fused_gat_precombined), a 2700-node clustered graph to an `auto` GCN
     (fused_gcn_grasp, and bitmap_spmm with `fusion="none"`). With every
     launch count set to 0 just before, 20 deltas of 8 adds and 8 removes
     each go to each graph through `update_delta` (the clustered graph's
     inside one 128-node community; the GCN graph's odd ones flip one
     pair each way, so its int8 Â takes the row patch too), each followed
     by queries of every served path. After each delta the patched entry must equal the
     materializer's output for the patched compact form, the int8 Â a
     whole re-quantization, and the logits a fresh `attach` of the same
     structure, bit for bit; the logits also meet TOL against the plain
     forward. Launch counts must match the batch log, `assert_warm()`
     hold, and one 200-pair delta fall back to `update()` (exactly one
     `delta_fallbacks`). Prints the bytes a delta ships against a
     rebuild's compact upload, `update_delta`'s host ms by piece and the
     patch's device ms (CUDA events) on one cap-3072 graph, beside
     `update()`'s host ms and the next query's materializer device ms;
  10. pipeline — phase 3's fp32 burst to the fused Cora GCN (Cora and the
     five Planetoid-like graphs, then a 900-node graph attached and
     queried twice) once through the sync path, then through
     `GraphServe.scheduler(PipelineConfig(host_workers=h, window_ms=2.0))`
     for h = 1, 2, 4 and 4 again, each request submitted from this thread
     as it comes, then `drain()`: the host workers prepare requests on
     their own CUDA streams while the dispatcher runs the kernels. One
     untimed burst through the sync path and one with 4 workers come
     first, so the streams' allocator pools are warm. With
     every launch count set to 0 just before each burst, every answer
     must equal the sync burst's bit for bit (which meets TOL against the
     plain forward), fused_gcn_dense launch twice a batch, `assert_warm()`
     hold and every accepted request complete. Prints each burst's span,
     throughput, p50/p99 ms (from the submit call), device_busy_s, the
     device's idle share, host_busy_s, batches and occupancy. Then the
     SLO loop on the card: four requests with a 0.001 ms deadline expire
     flagged with no launch and four with 60 s are served; a governor
     whose p99 target is below the measured p99 steps the default tier of
     a calibrated fp32/int8 GCN to int8 (fused_gcn_int8 launches); a
     `tolerance=` request takes the tier of lower measured latency at its
     bucket; and an `auto` GCN, after serving Cora dense and clustered
     graphs through fused_gcn_grasp, decides from the measured dense/GraSp
     pair, each decision printed beside the model's;
  11. shard — multi-device GraphSplit on one card, the shard axis a
     leading tensor dimension: clustered graphs (128-node communities, a
     tenth of the edges across) of 10,000 nodes for the Cora GCN (4 x 3072,
     full_rows 12288) and 5,000 for the Cora GAT and SAGE (2 x 3072) on
     ladder (1024, 3072) with shard counts (2, 4). Prints the partitioner's
     host ms, cut edges and halo nodes (multilevel and greedy) and the
     slice build's host and device ms; then a GraphServe with
     `halo_compress=False` and `replica_groups=2` serves `gcn` (default
     techniques) and, with `use_pallas`, `gcn_mm`, `gat_mm`,
     `sage_max_mm` (GrAx3: the rectangular sage_max) and `sage_mean_mm`,
     fp32 and int8 each, a second fp32 query of each `use_pallas` model
     filling its second replica row. With every launch count set to 0
     just before, the launches of block_matmul, int8_matmul and sage_max
     must equal the batch log's (and be nonzero); every answer must meet
     TOL against the plain single-device forward at full_rows (GAT and
     SAGE int8 layer by layer), each replica row equal its single-replica
     dispatch bit for bit, and the halo counters their formula. The int8
     wire: every exchanged element within scale/2 of the exact exchange
     (the worst ratio printed) and the logits within 0.05; one dispatch's
     CUDA-event ms split into the exchanges and the rest, beside the
     plain unsharded forward at full_rows and `modelled_sharded_latency`.
     The rectangular sage_max against its plain version, timed; the same
     sharded requests through the pipeline scheduler, bit for bit; a
     mixed sharded/unsharded burst (`assert_warm()`); `update()` growing
     a 2,000-node graph into 2 x 3072 and shrinking it back; and one
     `update_delta` on the 4 x 3072 graph whose slices and logits must
     equal a sharded rebuild under the kept partition bit for bit, with
     the delta-halo counters equal to their formula;
  11b. mesh — the same sharded serving on a mesh of processes
     (`GraphServe(mesh=)`, one rank per (replica, shard) cell, started by
     `launch.shard_serve.spawn_local`; every rank on this card through
     gloo, whose CUDA all_reduce crosses the host): the Cora GCN at 4 x
     3072 (fp32 and int8, the halo's int8 wire off and on, and an
     `update_delta` whose patched row blocks must equal a mesh rebuild),
     GAT, SAGE-max and SAGE-mean at 2 x 3072 (fp32 and int8, and the
     GAT's `update()` from 2,000 nodes into 2 x 3072 and back), and the
     GCN on a 2 x 2 replica mesh. Each rank's answers must equal the
     single-process engine's on the same calls bit for bit, its launches
     of block_matmul, int8_matmul and sage_max its batch log's (the sum
     over the phase nonzero), the lead's counters the single-process
     engine's; per rank it prints the cache residency, one dispatch's
     CUDA-event ms with the all_reduce time apart, beside the
     single-process dispatch and `modelled_sharded_latency`, and the
     bytes handed to all_reduce beside `ring_psum_nbytes`' price. Then
     the group collectives on an NCCL world of one rank, bit for bit,
     and NCCL's answer to two ranks on one card, printed;
  11c. mesh-pipeline — the pipeline scheduler on a mesh
     (`GraphServe(mesh=).scheduler(PipelineConfig(host_workers=2,
     window_ms=2.0))`, `shard_serve --pipeline 2`): the Cora GCN on 4
     gloo ranks at 4 x 3072 (an `update_delta` while it is open) and on
     the 2 x 2 x 3072 replica mesh, fp32 and int8 queries through the
     lead's batches, tiers and expiries, then a burst with 0.001 ms
     deadlines. Each rank's pipelined answers must equal its sync mesh
     run()'s bit for bit, its batch log (uids included) the lead's, its
     launches of block_matmul and int8_matmul its batch log's, the
     deadline burst expired alike on every rank, accepted == completed;
     per rank it prints the pipelined burst's wall seconds beside the
     sync run()'s, host_busy_s, device_busy_s and the idle share;
  12. train — the paper's four Cora models (GCN 1433 -> 64 -> 7, GAT 8
     heads of 8 then 1 of 7, SAGE-max and SAGE-mean over 10 sampled
     neighbours) trained on the card from a seeded init, 100 epochs of
     full-batch AdamW at lr 0.01 and weight decay 5e-4, on
     `accuracy_table`'s training forwards (the dense GCN and exact-mask
     GAT, SAGE on the edge-list baseline); `train_node_classifier` fails
     the run if a parameter gets no gradient at any epoch. Each model
     prints its training ms (CUDA events) and ms an epoch, its first and
     final loss and its fp32 test accuracy; then each tier through the
     kernels, held against the plain forward of the same tier at TOL
     (GAT int8 layer by layer, GCN int8 argmax equal), with its accuracy
     and its delta in points: GCN fp32 (block_matmul, fused_gcn_dense),
     offline int8 from `calibrate_quant` and the serving int8 tier
     (int8_matmul, fused_gcn_int8), GAT GrAx1+2 (gat_attention,
     fused_gat_full) and int8+grax (int8_matmul with gat_attention),
     SAGE-max GrAx3 (sage_max, fused_sage), SAGE-mean fp32
     (block_matmul, fused_sage). The trained GCN's edge-list forward
     must match its dense one at the reference's bar (rtol 1e-4, atol
     1e-5); CiteSeer's GCN (3328 nodes, K 3703, random weights) through
     fused_gcn_dense and fused_gcn_int8 at TOL. With every launch count
     set to 0 just before, each of the eight kernels must have launched.
     Then `forward_baseline` timed against `forward_grannite` (plain
     fp32, fused fp32, offline int8 fused) on Cora (2816) and CiteSeer
     (3328): the paper's speedup over the default mapping on this card;
  13. flash — `flash_attention` against its plain version
     (`flash_attention_ref`) in fp32 and bf16, each case through the route
     it takes (bf16 at head dim 64, 96 and 128: the wgmma/TMA kernel;
     fp32 and head dim 32: the SIMT kernel), at SmolLM's serving shapes (B 4, S
     64/128/256, 9 query heads over 3 KV heads of 64, causal), ragged S of
     63, 65, 127, 129 and 200, qwen3's heads (32 over 8 of 128) at S 64,
     65 and 129, gemma2's heads (32 over 16 of 128) with window 64 and
     softcap 50, non-causal, q_offset 192 over 256 keys, rows that no key
     may reach (at head dim 64 and 128), head_dim 32, Whisper-base's
     encoder (B 4, non-causal over 1500 frames) and cross-attention (256
     queries over the 1500 frames), Phi-3-vision's prefill (32/32 heads of
     96 at S 1280) and head dim 96 at a ragged S 65 and non-causal 65 x
     129, chatglm3's 32/2 and Llama-4-Scout's 40/8 heads of 128 at B 4, S
     256, and gemma2's long wave (B 1, S 4608, 32/16 heads, window 4096,
     softcap 50);
  14. serve-lm — an LM Server with SmolLM-135M at full width (30 layers,
     d_model 576, 9/3 heads, vocab 49152; random fp32 weights from numpy,
     bf16 compute), buckets (64, 128, 256), max_len 512, 4 slots: after a
     warm-up wave per bucket, 12 requests of 16 new tokens (one wave per
     bucket) with every launch count set to 0 just before; flash_attention
     must launch 30 times per prefill, every one on the tensor-core route,
     and nothing else at all, the counters
     must hold (at most len(buckets) + 1 step callables), and the last
     wave's prefill logits must match a rerun with the plain attention
     (LM_LOGIT_BAR) and give the served first tokens. Prints time to first
     token per bucket, decode ms per step and tokens/s;
  15. serve-moe — OLMoE-1B-7B at full width and depth (16 layers, d_model
     2048, 16 heads of 128 with qk-norm, 64 experts top-8 of 1024 in every
     layer, vocab 50304; 6.92 B parameters), random bf16 weights drawn on
     the card from a seed (`lm_init(dtype=...)`: each matrix rounded as it
     is made), served as [serve-lm] does (buckets 64/128/256, 4 slots, 12
     requests of 16 tokens after a warm-up wave per bucket): launch counts
     (flash_attention 16 a prefill wave, nothing else), counters, finite
     logits giving the served first tokens; prints the parameter and
     active-parameter counts, time to first token per bucket, decode ms a
     step, a bucket-256 prefill's and a step's device time and idle share
     (torch.profiler) and the prefill's largest kernels, and the dispatch
     and combine einsums timed alone at the prefill's group against its
     device time. Then the layer-by-layer check (`nn/layerwise.py`) on the
     last wave: every layer's attention through the kernel and through
     the plain version on the same input; mixer branches and the outputs
     over tokens whose routes and kept assignments agree within
     LM_LOGIT_BAR, routes agreeing on ROUTE_AGREE_MIN of tokens and no
     less than the float32 attention's, less ROUTE_MARGIN;
  16. serve-ssm — Mamba2-2.7B in full (64 SSD layers, 2.70 B parameters),
     served the same way on prompts of bucket length (waves): every
     request's tokens must equal `greedy_generate`'s; one full-width SSD
     layer in fp32 (B 2, S 512, two chunks) against the sequential oracle
     `ssm_reference` within SSD_BAR; times as phase 15;
  17. serve-hybrid — Jamba-v0.1 at full width with one 8-layer superblock
     of its 32 (13.3 B parameters; the whole model would not fit), checked
     and timed as phase 15, flash_attention once a prefill wave. Each of
     phases 15–19 frees its model before the next and prints its seconds;
  18. serve-audio — Whisper-base at full width and depth (6 encoder and 6
     decoder layers, d_model 512, 8 heads of 64, vocab 51865; 71 M
     parameters), bf16 weights drawn on the card: 4 requests of each
     bucket's length (64/128/256) with 1500 stub frames each, one wave a
     bucket of `lm_prefill(enc_embeds=)` and 15 greedy `lm_decode_step`s
     after a warm-up pass; with every count 0 just before, exactly 18
     flash_attention launches a prefill (6 encoder, 6 decoder, 6 cross),
     all on the tensor-core route, and nothing else; the bucket-256
     prefill's logits against the plain attention (LM_LOGIT_BAR) and
     giving the served first tokens; time to first token per bucket, the
     encoder's device ms, decode ms a step, idle shares (torch.profiler),
     peak memory;
  19. serve-vlm — Phi-3-vision-4.2B's backbone at full width and depth (32
     layers, d_model 3072, 32 heads of 96, d_ff 8192, vocab 32064; 3.8 B
     parameters), bf16 weights drawn on the card: 4 requests of 1024 stub
     patches before a 256-token prompt (S 1280, max_len 1296), one
     `lm_prefill(prefix_embeds=)` and 15 decode steps: 32 launches at
     head dim 96 on the tensor-core route, the logits check and times as
     phase 18; then one text-only wave through `Server`, as the
     reference's server serves this config (32 launches, its counters);
  20. serve-dense — qwen3-4b (36 layers, 32/8 heads of 128, qk-norm,
     vocab 151936), chatglm3-6b (28 layers, 32/2 heads of 128, half-width
     rope, untied head) and gemma2-27b (46 layers alternating a 4096-key
     local window and global attention, 32/16 heads of 128, softcaps 50
     and 30, sandwich norms; 54.4 GB in bf16), each at full width and
     depth with bf16 weights drawn on the card, served as phase 15 serves
     OLMoE: one flash_attention launch per attention layer and wave, all
     on the tensor-core route, nothing else, the counters, the last
     wave's prefill logits against the plain attention (LM_LOGIT_BAR;
     gemma2's before its final softcap, which caps every logit at 30),
     the float32 attention's beside them as a control, times and idle
     shares. Then gemma2-27b's long wave: one slot, one
     4608-token prompt in bucket 4608 and 3 decode steps, so its local
     layers mask keys past the window in the kernel and in the plain
     decode; 46 tensor-core launches, its first token against a rerun of
     the prefill, and the prefill against the plain attention layer by
     layer (`nn/layerwise.py`: a whole-model plain prefill does not fit
     beside the weights); each model prints its seconds and peak memory;
  21. serve-scout — Llama-4-Scout at full width (d_model 5120, 40/8
     heads of 128, 16 experts top-1 of 8192 and a shared expert in every
     layer, vocab 202048, untied head) cut to 12 of its 48 layers (28.5 B
     of 107.8 B parameters), through phase 15's checks: launches, routes,
     counters, times, and the route agreement layer by layer at phase
     15's bars;
  22. examples — the port's serving examples (`repro_torch.examples.`
     serve_llm, dynamic_graph_serving, sparse_serving, async_pipeline),
     each in a subprocess with `--device cuda`, all four at once: each
     must exit 0, its own assertions held;
  23. train-lm — `flash_attention_bwd` (the gradient of flash_attention;
     bf16 at head dim 64, 96 and 128 on the tensor-core route
     `csrc/flash_attention_bwd_tc.cu`, the rest on the SIMT route
     `csrc/flash_attention_bwd.cu`) against its plain version
     (`flash_attention_bwd_ref`) at SmolLM's training shape (B 4, S 1024,
     9/3 heads of 64, bf16, causal), Whisper's encoder (non-causal, S
     1500) and cross-attention (256 x 1500), Phi-3-vision's head dim 96,
     a reduced gemma2 with window 64 and softcap 50, fp32 at head dim 32
     and 64, rows that no key may reach, and on the tensor-core route D 64
     with window 64 and softcap 50 and D 128 with softcap 30, Sq != Skv
     and q_offset: dq, dk and dv each within twice the plain version's
     error against a float64 autograd oracle, in the same dtype, each case
     on the route it was meant to take (its route counter), and a second
     call bit-equal to the first. Then SmolLM-135M at full width and depth (30
     layers, float32 parameters from `lm_init`, bf16 compute, remat):
     one step of 8 x 1024 tokens in 2 microbatches through the kernels,
     with every count 0 just before (flash_attention 2 x 30 x 2 launches,
     flash_attention_bwd 30 x 2, all on the tensor-core route, nothing
     else, and the plain attention
     never called on a CUDA tensor), its loss and every leaf's gradient
     against the same step through the plain attention (max |difference|
     at most 5e-2 of the leaf's max |entry|, every leaf's gradient
     nonzero); then `Trainer.run()`: 20 steps at lr 1e-3, warmup 5,
     checkpoints every 5 steps into a temporary directory under `build/`,
     a failure injected at step 12 and restored from step 10 (restarts
     1, the loss falling, the launches exact, every backward on the
     tensor-core route); prints ms a step by CUDA
     events, tokens/s, the device idle share and the backward kernel's
     share of the step's device time (torch.profiler), peak card memory;
  23b. mesh-lm — the LM's placement: SmolLM-135M at full width trained
     on ("data", "model") meshes of gloo ranks sharing this card
     (`python -m repro_torch.launch.train --mesh DxM`, started by
     `spawn_local`): 3 steps of 8 x 1024 tokens in 2 microbatches, lr
     1e-3, on (1, 2), (2, 1) and (2, 2), each rank holding its blocks of
     the parameters and AdamW's moments and gathering one superblock at a
     time. Held against the single-process step on the card (the same
     seed's weights and batches): each rank's losses and gradient norms
     within 5e-2 of the single process's; after the steps (the
     checkpoint the mesh's origin assembles) each leaf's AdamW first
     moment (a fixed sum of the steps' clipped gradients) within 5e-2 of
     its largest, at most 5% of a leaf's entries beyond 5e-2 of its
     largest update, and every entry within 2 lr a step (two AdamW runs
     part by at most that whatever their gradients); the check first
     refuses three planted states (the parameters at init, the update
     reversed, m halved); the first loss on (1, 2) bit-equal;
     every rank of a mesh alike; each rank's flash_attention and
     flash_attention_bwd launches equal to its batch log (2 x 30 x 2 and
     30 x 2 a step), all on the tensor-core route. A checkpoint written on
     (2, 1) after 2 steps is restored on (1, 2) and its third step held to
     the single-process one. Then `python -m repro_torch.launch.serve
     --mesh 1x2`: a greedy batch (4 prompts of 256 tokens, 8 new tokens)
     on the placement, its tokens equal to the single-process greedy
     tokens on the card. Prints per rank ms a step (CUDA events), the
     all_reduce's ms and share, the bytes handed to all_reduce, the
     parameter bytes and peak card memory;
  23c. dryrun — `python -m repro_torch.launch.dryrun --all --mesh both
     --jobs N` (every arch x shape on (16, 16) and (2, 16, 16), run as the
     origin rank of an abstract mesh on meta tensors, on the host's
     cores): exits 0 with no FAILED row; prints its table of per-rank
     argument bytes and H100 time terms;
  24. times — CUDA-event times of each kernel, its plain version and the
     matching library call at the serving shapes, beside the card's bound
     (flash_attention at the serving shape, at B 1, S 4096, 32/8 heads
     of 128, at the Whisper encoder's, Whisper cross-attention's,
     Phi-3-vision prefill's and Llama-4-Scout prefill's shapes, and at
     gemma2's long wave, where SDPA is not timed: it takes no softcap),
     and the dense and GraSp aggregation times per bucket queued
     behind a spin, with the GraSp cost rule's terms they measure (`[agg]`:
     a launch's fixed cost from bitmap_spmm with every count 0, the walk's
     and the dense products' rates); for the redesigned kernels also the
     times queued behind a spin (block_matmul and flash_attention with
     TFLOP/s, the three GAT kernels, fused_sage, fused_gcn_dense and
     fused_gcn_grasp with bounds for 3xTF32 and for fp32 FMA products,
     bitmap_spmm with every count 0 too and on the batch's first 1-4
     graphs, the two int8 kernels, and torch._int_mm beside int8_matmul;
     int8_matmul's layer-1 Aq @ Hq also on the batch's first 1-4 graphs;
     fused_sage's layer 1 split into the walk and the combine, the
     combine's X and AGG loops apart, a split-K grid without its
     reduction, the pair run one graph at a time, and the combine on the
     batch's first 1-4 graphs);
     flash_attention's SIMT kernel, which served bf16 at head dim 64 and
     128 before, timed on the same inputs, and each route's host cost per
     call; block_matmul's time on its earlier fp32 SIMT tile, the GAT
     kernels' on their earlier SIMT body, the int8 kernels' on their
     earlier __dp4a tile, fused_sage's on its earlier SIMT combine, the
     GCN layers' on their earlier SIMT products and the GraSp kernels' on
     their earlier SIMT walk, copied from PERF.md and printed as copied;
     flash_attention_bwd at SmolLM's training shape and Phi-3-vision's
     prefill shape by CUDA events and queued behind a spin, on its
     tensor-core route, beside its plain version, the backward of
     scaled_dot_product_attention (`torch.autograd.grad` through it, a
     yardstick only) and its bounds on the bf16 tensor cores and in fp32
     FMA over the five products, and its SIMT route, which took bf16 at
     head dim 64 before, at SmolLM's shape on the same inputs.

Output: progress lines, the card's name and power limit, one
`{"kernels": [...]}` line, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.bridge import (lm_params_from_jax,  # noqa: E402
                                params_from_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.gnn import GNN_MODELS, gat, gcn, sage  # noqa: E402
from repro_torch.core.graph import (BucketLadder,  # noqa: E402
                                    add_self_loops, adjacency_keys, apply_edge_delta,
                                    edge_index_from_adjacency,
                                    is_symmetric_adjacency, keys_symmetric,
                                    pad_graph, patch_adjacency_keys,
                                    symg_pack_adjacency_bits, symg_pack_keys,
                                    triangular_nbits)
from repro_torch.core.layers import Techniques  # noqa: E402
from repro_torch.core import costs  # noqa: E402
from repro_torch.core import layers as glayers  # noqa: E402
from repro_torch.core import models as gmodels  # noqa: E402
from repro_torch.core.quant import apply_quantized_linear  # noqa: E402
from repro_torch.core.partition import (  # noqa: E402
    modelled_sharded_latency, partition_for_ladder)
from repro_torch.dist.compress import INV_INT8_MAX  # noqa: E402
from repro_torch.core.models import (OPERAND_FIELDS,  # noqa: E402
                                     build_materializer, build_operands,
                                     calibrate_tier, compact_operands,
                                     derive_tier_operands, gcn_degree,
                                     materialize_operands, patch_operands,
                                     patch_tier_operands, stack_operands)
from repro_torch.core.sparsity import (agg_cost_model,  # noqa: E402
                                       block_stats, compact_block_sparse,
                                       grasp_max_nnz, select_agg_backend,
                                       stack_block_sparse)
from repro_torch.data.graphs import (citeseer_like,  # noqa: E402
                                     clustered_like, cora_like,
                                     planetoid_like)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._launch import launch  # noqa: E402
from repro_torch.kernels.timing import card_line, queued_ms  # noqa: E402
from repro_torch.launch import shard_serve as ss  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from repro_torch.kernels import bitmap_spmm as bs  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_layers as fl  # noqa: E402
from repro_torch.kernels import gat_attention as ga  # noqa: E402
from repro_torch.kernels import int8_matmul as im  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import sage_max as sm  # noqa: E402
from repro_torch.nn import lm  # noqa: E402
from repro_torch.nn import moe, multimodal, ssm  # noqa: E402
from repro_torch.nn.layerwise import (  # noqa: E402
    compare_attention_paths, exact_attention)
from repro_torch.runtime.cache import (  # noqa: E402
    estimate_dense_entry_bytes)
from repro_torch.runtime import gnn_server as gserver  # noqa: E402
from repro_torch.runtime.gnn_server import (GraphServe,  # noqa: E402
                                            GraphServeConfig)
from repro_torch.runtime.scheduler import PipelineConfig  # noqa: E402
from repro_torch.runtime.server import ServeConfig, Server  # noqa: E402
from repro_torch.runtime import trainer  # noqa: E402
from repro_torch.ckpt import (restore_checkpoint, tree_items,  # noqa: E402
                              tree_replace)
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.runtime.slo import SLOConfig  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3, fp32 outside the tensor
# cores (the fp32 SIMT kernels' roofline), the int8 tensor cores (the
# least time any int8 kernel could take) and the special-function units'
# exp2 (132 SMs x 16 a clock x 1.98 GHz: the GAT softmax's expf).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# the TF32 tensor cores (dense): block_matmul's 3xTF32 does three TF32
# products per fp32 product
TF32_FLOPS_PER_S = 495e12
INT8_OPS_PER_S = 1979e12
SFU_EXP_PER_S = 132 * 16 * 1.98e9
LADDER, SLOTS = (1024, 3072), 4
CAP, FIN_PAD, TILE = 3072, 1536, 128
PLANETOID_SIZES = (300, 700, 1000, 1800, 2700)
CLUSTERED_SIZES = PLANETOID_SIZES
# fp32 kernel vs cuBLAS fp32 (TF32 off): same products, other summation
# order over K <= 3072
TOL = dict(rtol=1e-4, atol=1e-5)
SOURCES = {"block_matmul": ("src/repro_torch/kernels/csrc/block_matmul.cu",
                            "src/repro/kernels/block_matmul.py:35"),
           "fused_gcn_dense": ("src/repro_torch/kernels/csrc/"
                               "fused_gcn_dense.cu",
                               "src/repro/kernels/fused_layers.py:97"),
           "int8_matmul": ("src/repro_torch/kernels/csrc/int8_matmul.cu",
                           "src/repro/kernels/int8_matmul.py:39"),
           "fused_gcn_int8": ("src/repro_torch/kernels/csrc/"
                              "fused_gcn_int8.cu",
                              "src/repro/kernels/fused_layers.py:170"),
           "bitmap_spmm": ("src/repro_torch/kernels/csrc/bitmap_spmm.cu",
                           "src/repro/kernels/bitmap_spmm.py:46"),
           "fused_gcn_grasp": ("src/repro_torch/kernels/csrc/"
                               "fused_gcn_grasp.cu",
                               "src/repro/kernels/fused_layers.py:246"),
           "gat_attention": ("src/repro_torch/kernels/csrc/gat_attention.cu",
                             "src/repro/kernels/gat_attention.py:42"),
           "fused_gat_full": ("src/repro_torch/kernels/csrc/"
                              "fused_gat_full.cu",
                              "src/repro/kernels/fused_layers.py:334"),
           "fused_gat_precombined": ("src/repro_torch/kernels/csrc/"
                                     "fused_gat_precombined.cu",
                                     "src/repro/kernels/fused_layers.py:394"),
           "sage_max": ("src/repro_torch/kernels/csrc/sage_max.cu",
                        "src/repro/kernels/sage_max.py:47"),
           "fused_sage": ("src/repro_torch/kernels/csrc/fused_sage.cu",
                          "src/repro/kernels/fused_layers.py:470"),
           "flash_attention": ("src/repro_torch/kernels/csrc/"
                               "flash_attention_tc.cu",
                               "src/repro/kernels/flash_attention.py:94")}
# the libraries redesigned for the card's tensor cores and the SASS
# instructions that show it (cuobjdump -sass; 0 fails the run): the bf16
# routes of flash_attention and of its backward, block_matmul's 3xTF32
# tile (also fused_sage's combine, both launches of fused_gcn_dense and of
# fused_gcn_grasp, and the GraSp walk of bitmap_spmm), the GAT attention
# body and the s8 tile of the two int8 kernels (mma.sync m16n8k32:
# IMMA.16832.S8.S8)
SASS = {**{lib: {"HGMMA": ("HGMMA",), "UTMALDG": ("UTMALDG",)}
           for lib in ("flash_attention_tc", "flash_attention_bwd_tc")},
        **{lib: {"HMMA TF32": ("HMMA", "TF32")}
           for lib in ("block_matmul", "gat_attention", "fused_gat_full",
                       "fused_gat_precombined", "fused_sage",
                       "fused_gcn_dense", "fused_gcn_grasp", "bitmap_spmm")},
        **{lib: {"IMMA": ("IMMA",)}
           for lib in ("int8_matmul", "fused_gcn_int8")}}
# block_matmul per 4 x 3072 batch on the fp32 SIMT tile it had before the
# tensor-core redesign, copied from PERF.md section 6 (table row 1, NVIDIA
# H100 80GB HBM3, 700 W): that tile is not built any more, so this run
# prints the number as copied and never as its own
BLOCK_MATMUL_SIMT_MS = 1.0023
# the GAT kernels per 4 x 3072 batch on the SIMT attention body they had
# before the tensor-core redesign, copied from PERF.md section 6 (rows 4,
# 10 and 11, NVIDIA H100 80GB HBM3, 700 W): printed as copied, never as
# this run's own
GAT_SIMT_MS = {"gat_attention": 1.1226, "fused_gat_full": 1.3134,
               "fused_gat_precombined": 1.1306}
# the int8 kernels per 4 x 3072 batch on the __dp4a tile they had before
# the s8 tensor-core tile, copied from PERF.md section 6 (rows 2 and 8,
# NVIDIA H100 80GB HBM3, 700 W): printed as copied, never as this run's own
INT8_DP4A_MS = {"int8_matmul": 0.6146, "fused_gcn_int8": 0.6027}
INT8_KERNELS = ("int8_matmul", "fused_gcn_int8")
# fused_sage per 4 x 3072 batch (both layers) with the fp32 SIMT combine it
# had before the 3xTF32 tile, by aggregator, copied from PERF.md section 6
# (row 12, NVIDIA H100 80GB HBM3, 700 W): printed as copied, never as this
# run's own
FUSED_SAGE_SIMT_MS = {"mean": 0.5381, "max": 0.5486}
# the GCN layers per 4 x 3072 batch (both layers, CUDA events) with their
# products on the fp32 SIMT tile before the 3xTF32 kernel (fused_gcn_grasp:
# its combine), copied from PERF.md section 6 (rows 7 and 9, NVIDIA H100
# 80GB HBM3, 700 W): printed as copied, never as this run's own
GCN_SIMT_MS = {"fused_gcn_dense": 0.9914, "fused_gcn_grasp": 0.2723}
GCN_KERNELS = ("fused_gcn_dense", "fused_gcn_grasp")
# the GraSp kernels per 4 x 3072 batch, queued behind a spin, with the walk
# on the fp32 SIMT tile before the 3xTF32 tile (bitmap_spmm's two calls, the
# same calls with every count 0, and fused_gcn_grasp's two layers), copied
# from PERF.md section 6 (rows 3 and 9, NVIDIA H100 80GB HBM3, 700 W):
# printed as copied, never as this run's own
WALK_SIMT_MS = {"bitmap_spmm": 0.0427, "bitmap_spmm, every count 0": 0.0120,
                "fused_gcn_grasp": 0.1652}
# the GraSp cost rule's constants while both backends ran on the fp32 SIMT
# tile (core/costs.py before they were measured on the card: 0.38 of the
# 67 TFLOP/s fp32 peak for both, a guessed 20 ns a list step, no launch
# cost); [serve-grasp] prints the rule's decisions under them beside the
# decisions under today's constants
SIMT_RULE_COSTS = {"DENSE_RATE": 67e12 * 0.38, "GRASP_RATE": 67e12 * 0.38,
                   "GRASP_STEP_OVERHEAD_S": 2e-8, "AGG_CALL_S": 0.0}
# timing variants, by library: block_matmul's tile (the switches of
# tc_gemm_tile.cuh), timed on the batch's products, the GAT attention
# body (gat_tile.cuh's switches, in the gat_attention library), timed on
# the layer-1 and layer-2 serving batches, and fused_sage's parts (its
# own switches), timed on the layer-1 serving batches. Built beside the
# libraries; what the split, the two extra products, the exponentials,
# the walk and each K loop cost. Their results are not the kernels' (one
# product is not fp32-accurate, a multiply is no exponential, and a part
# is not the whole).
VARIANTS = {"block_matmul": {"3 products, no split": ("-DTC_GEMM_SPLIT=0",),
                             "1 product": ("-DTC_GEMM_PRODUCTS=1",),
                             "1 product, no split": ("-DTC_GEMM_PRODUCTS=1",
                                                     "-DTC_GEMM_SPLIT=0"),
                             "split by cvt.rna": ("-DTC_SPLIT_INT=0",)},
            "gat_attention": {"1 product": ("-DGAT_PRODUCTS=1",),
                              "exp as a multiply": ("-DGAT_EXP=0",),
                              "1 product, exp as a multiply": (
                                  "-DGAT_PRODUCTS=1", "-DGAT_EXP=0"),
                              "split by cvt.rna": ("-DTC_SPLIT_INT=0",)},
            "fused_sage": {"walk alone": ("-DSAGE_COMBINE=0",),
                           "combine alone": ("-DSAGE_WALK=0",),
                           "combine, X loop alone": ("-DSAGE_WALK=0",
                                                     "-DSAGE_NEIGH_LOOP=0"),
                           "combine, AGG loop alone": ("-DSAGE_WALK=0",
                                                       "-DSAGE_SELF_LOOP=0"),
                           "combine as a split-K without its reduction": (
                               "-DSAGE_WALK=0", "-DSAGE_SPLIT=1")}}
# each kernel's launch counter: (module, attribute)
COUNTERS = {"block_matmul": (bm, "LAUNCHES"),
            "fused_gcn_dense": (fl, "LAUNCHES"),
            "int8_matmul": (im, "LAUNCHES"),
            "fused_gcn_int8": (fl, "INT8_LAUNCHES"),
            "bitmap_spmm": (bs, "LAUNCHES"),
            "fused_gcn_grasp": (fl, "GRASP_LAUNCHES"),
            "gat_attention": (ga, "LAUNCHES"),
            "fused_gat_full": (fl, "GAT_FULL_LAUNCHES"),
            "fused_gat_precombined": (fl, "GAT_PRE_LAUNCHES"),
            "sage_max": (sm, "LAUNCHES"),
            "fused_sage": (fl, "SAGE_LAUNCHES"),
            "flash_attention": (fa, "LAUNCHES")}
GAT_HEADS, GAT_F, GAT_CLASSES = 8, 8, 7
GAT_KERNELS = ("gat_attention", "fused_gat_full", "fused_gat_precombined")
SAGE_KERNELS = ("sage_max", "fused_sage")
SAGE_HIDDEN, SAGE_CLASSES = 64, 7
LM_KERNELS = ("flash_attention",)
# [delta]: deltas a graph, adds (and removes) each, the fallback's adds,
# and the kernels its served paths launch
DELTA_STEPS, DELTA_FLIPS, DELTA_FALLBACK_PAIRS = 20, 8, 200
DELTA_KERNELS = ("fused_gcn_dense", "fused_gcn_int8", "fused_gcn_grasp",
                 "bitmap_spmm", "fused_gat_full", "fused_gat_precombined")


# [train]: the paper's hyper-parameters, its four Cora models, the kernels
# their trained weights are evaluated through, and the reference's bar for
# the edge-list GCN against the dense one (tests/test_gnn_paths.py)
TRAIN_EPOCHS, TRAIN_LR, TRAIN_WD = 100, 0.01, 5e-4
TRAIN_MODELS = ("gcn", "gat", "sage-max", "sage-mean")
TRAIN_KERNELS = ("block_matmul", "fused_gcn_dense", "int8_matmul",
                 "fused_gcn_int8", "gat_attention", "fused_gat_full",
                 "sage_max", "fused_sage")
BASELINE_BAR = dict(rtol=1e-4, atol=1e-5)


def compact_bytes(cap, sage=False):
    """Bytes of one CacheG compact form at bucket `cap`: the packed bits
    (SymG triangle, or the full SAGE sample), the degree vector and the
    node count."""
    bits = cap * cap if sage else triangular_nbits(cap)
    return -(-bits // 8) + 4 * cap + 4


_HOST_OPS = {}


def host_operands(r, cfg, dev, cache=True):
    """The host-built operands of a served request's graph (the yardstick
    of its logits), built once per (graph, kind) unless `cache` is False
    (a graph whose structure changes under one node count); the masks the
    card materialized from the compact form, or patched, must equal them
    exactly."""
    key = (r.pg.num_nodes, r.pg.capacity, cfg.kind, cfg.max_neighbors)
    if not cache:
        _HOST_OPS.pop(key, None)
    if key not in _HOST_OPS:
        _HOST_OPS[key] = build_operands(r.pg, cfg, device=dev)
    host = _HOST_OPS[key]
    for f in ("mask_mult", "bias_add", "sample_mask", "mean_mask"):
        if getattr(host, f) is not None:
            check(torch.equal(getattr(r.ops, f), getattr(host, f)),
                  f"request {r.uid}: the materialized {f} differs from the "
                  f"host's")
    return host


def gcn_plain(r, params, dev, cal=None):
    """The plain forward a served GCN request is held to, on its first
    num_nodes rows (on the host): both layers over the host-built Â, fused
    through `fused_gcn_dense_plain`, unfused as two products; a GraSp
    request over its block structure through `fused_gcn_grasp_plain` or
    `bitmap_spmm_plain`; an int8 request (`cal`, its tier's calibration)
    through `fused_gcn_int8_plain` over the row-quantized host Â."""
    n = r.pg.num_nodes
    a = torch.from_numpy(r.pg.norm_adj).to(dev)[None]
    x = torch.from_numpy(r.pg.features).to(dev)[None]
    p1, p2 = params["l1"], params["l2"]
    if cal is not None:
        t = derive_tier_operands(a)
        h = x
        for layer, (ql, hs, act) in enumerate(
                ((cal["l1"], cal["agg1_h"], "relu"),
                 (cal["l2"], cal["agg2_h"], "none")), start=1):
            h = fl.fused_gcn_int8_plain(
                h, ql.wq, (ql.x_scale * ql.w_scale).reshape(1, -1),
                ql.x_scale, hs, t.agg_aq, t.agg_a_scale,
                params[f"l{layer}"]["b"], act)
        return h[0, :n].cpu()
    if r.backend == "grasp":
        st_ = tuple(t[None] for t in (r.ops.block_sparse.blocks,
                                      r.ops.block_sparse.block_cols,
                                      r.ops.block_sparse.counts))
        if r.fusion == "layer":
            h = fl.fused_gcn_grasp_plain(*st_, x, p1["w"], p1["b"], "relu")
            ref = fl.fused_gcn_grasp_plain(*st_, h, p2["w"], p2["b"])
        else:
            h = torch.relu(bs.bitmap_spmm_plain(*st_, x @ p1["w"])
                           + p1["b"])
            ref = bs.bitmap_spmm_plain(*st_, h @ p2["w"]) + p2["b"]
    elif r.fusion == "layer":
        h = fl.fused_gcn_dense_plain(a, x, p1["w"], p1["b"], "relu")
        ref = fl.fused_gcn_dense_plain(a, h, p2["w"], p2["b"], "none")
    else:
        h = torch.relu(bm.block_matmul_plain(
            a, bm.block_matmul_plain(x, p1["w"])) + p1["b"])
        ref = bm.block_matmul_plain(
            a, bm.block_matmul_plain(h, p2["w"])) + p2["b"]
    return ref[0, :n].cpu()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def glorot(rng, fan_in, fan_out):
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)


def pad_to(a, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def time_ms(fn, iters=20):
    """Mean device time of one call, by CUDA events over `iters` warm calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops, nbytes, peak=FP32_FLOPS_PER_S):
    """(least ms the card needs, what bounds it) at the published peaks:
    `ops` at `peak` per second, `nbytes` at the HBM rate."""
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def matmul_work(a, b):
    """(ops, bytes) of one batched product: inputs read once, the float32
    output written once."""
    bsz, m, _ = a.shape
    n = b.shape[-1]
    return (2.0 * bsz * m * n * a.shape[-1],
            nbytes(a, b) + 4.0 * bsz * m * n)


def fused_work(adj, x, w, *rest):
    bsz, n, fin = x.shape
    o = w.shape[1]
    flops = 2.0 * bsz * n * fin * o + 2.0 * bsz * n * n * o
    return flops, nbytes(adj, x, w, *rest) + 4.0 * bsz * n * o


def rule_with(constants, *args, **kwargs):
    """select_agg_backend(*args, **kwargs) with core/costs.py's names set
    to `constants` for the call."""
    saved = {k: getattr(costs, k) for k in constants}
    try:
        for k, v in constants.items():
            setattr(costs, k, v)
        return select_agg_backend(*args, **kwargs)
    finally:
        for k, v in saved.items():
            setattr(costs, k, v)


def launches_now():
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


def reset_launches():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    fa.TC_LAUNCHES = fa.SIMT_LAUNCHES = 0


def flash_routes_now():
    """flash_attention's launches by route."""
    return {"wgmma": fa.TC_LAUNCHES, "simt": fa.SIMT_LAUNCHES}


def start_variants():
    """Start one nvcc per timing variant, into
    build/repro_torch_kernels/variants/: {(library, label): (process,
    variant library)}."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, variants in VARIANTS.items():
        for i, (label, flags) in enumerate(variants.items()):
            lib = out_dir / f"{name}_variant{i}.so"
            procs[name, label] = (subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
                 str(lib), str(_build.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                lib)
    return procs


def bind_variants(procs, logs):
    """Each built variant library's entry point: {library: {label: fn}}."""
    fns = {name: {} for name in VARIANTS}
    for (name, label), (proc, lib) in procs.items():
        check(proc.returncode == 0, f"{name} variant {label}: nvcc exit "
              f"{proc.returncode}\n{logs[name, label]}")
        symbol, kinds = _build.ENTRY_POINTS[name]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = [_build._CTYPES[k] for k in kinds]
        fn.restype = ctypes.c_int
        fns[name][label] = fn
    return fns


def run_tile_variant(fn, a, b, out):
    """One launch of a block_matmul variant, as the wrapper launches the
    library (a 2-D operand broadcasts), counted nowhere."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    launch("block_matmul", fn, a.device, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), out.shape[0], m, n, k,
           m * k if a.dim() == 3 else 0, k * n if b.dim() == 3 else 0)


def run_gat_variant(fn, h, alpha_dst, alpha_src, bias, out):
    """One launch of a gat_attention variant, as the wrapper launches the
    library, counted nowhere."""
    launch("gat_attention", fn, h.device, h.data_ptr(), alpha_dst.data_ptr(),
           alpha_src.data_ptr(), bias.data_ptr(), out.data_ptr(),
           *h.shape)


def run_sage_variant(fn, mask, xk, x, w_self, w_neigh, b, aggregator,
                     activation):
    """One launch of a fused_sage variant, with the scratch and output the
    wrapper allocates, counted nowhere."""
    batch, n, fin = x.shape
    agg = fl.sage_scratch(x)
    out = torch.empty(batch, n, w_self.shape[1], device=x.device)
    launch("fused_sage", fn, x.device, mask.data_ptr(), xk.data_ptr(),
           x.data_ptr(), w_self.data_ptr(), w_neigh.data_ptr(), b.data_ptr(),
           agg.data_ptr(), out.data_ptr(), batch, n, fin, agg.shape[-1],
           w_self.shape[1], int(aggregator == "max"),
           fl.ACTIVATIONS[activation])


def graphs():
    cora = cora_like(seed=0)
    others = [planetoid_like(num_nodes=n, num_edges=2 * n, num_feats=1433,
                             num_classes=7, seed=1 + i)
              for i, n in enumerate(PLANETOID_SIZES)]
    return cora, others


def clustered(n):
    """The GraSp traffic: community graphs of 128-node blocks, no cross
    edges, so every block row of Â holds one non-zero block."""
    return clustered_like(num_nodes=n, num_feats=1433, num_classes=7,
                          within_density=0.05, cross_frac=0.0, seed=n)


def grasp_batch(graphs, cap, dev):
    """A 4-graph serving batch at `cap`: Â, the features padded to 1536
    columns, and the block structure at the bucket budget, derived on the
    card from Â as the query path derives it."""
    pgs = [pad_graph(g, capacity=cap) for g in graphs]
    adj = torch.from_numpy(np.stack([p.norm_adj for p in pgs])).to(dev)
    x = torch.from_numpy(np.stack([pad_to(p.features, (cap, FIN_PAD))
                                   for p in pgs])).to(dev)
    budget = grasp_max_nnz(cap)
    parts = [compact_block_sparse(a, max_nnz=budget) for a in adj]
    check(all(int(t.max()) <= budget for _, t in parts),
          f"a graph of the {cap} batch exceeds the budget {budget}")
    sp = stack_block_sparse([p for p, _ in parts])
    return adj, x, (sp.blocks, sp.block_cols, sp.counts)


def nan_tail(blocks, cols, counts):
    """The same blocks with NaN in every padded tail entry (k >= counts)."""
    b, rb, k = cols.shape
    live = (torch.arange(k, device=cols.device)[None, None, :]
            < counts[:, :, None])
    out = blocks.clone().reshape(b, rb, k, TILE, TILE)
    out[~live] = float("nan")
    return out.reshape(blocks.shape)


def grasp_work(cols, counts, f, fin=None):
    """(ops, bytes) of one Â @ H over the real blocks: each real block and
    its column index read once, each H row block that a real entry names
    read once (NodePad's blocks are named by none), the output written
    once. With `fin`, H = X @ W is made on chip: those blocks' X rows are
    read once and multiplied by W instead; W and b are the caller's."""
    bsz, rb = counts.shape
    live = (torch.arange(cols.shape[-1], device=cols.device)[None, None, :]
            < counts[:, :, None])
    graph = torch.arange(bsz, device=cols.device)[:, None, None].expand_as(
        cols)
    named = torch.unique(graph[live] * rb + cols[live].long()).numel()
    nnz = float(counts.sum().item())
    h_rows = float(named * TILE)
    ops = 2.0 * nnz * TILE * TILE * f
    moved = 4.0 * (nnz * TILE * TILE + nnz + bsz * rb + bsz * rb * TILE * f)
    if fin is None:
        return ops, moved + 4.0 * h_rows * f
    return ops + 2.0 * h_rows * fin * f, moved + 4.0 * h_rows * fin


def gat_layer_np(rng, fin, heads, f):
    """numpy weights of one GAT layer: w (fin, heads*f), a_src and a_dst
    (heads, f), and a small random bias."""
    return {"w": glorot(rng, fin, heads * f), "a_src": glorot(rng, heads, f),
            "a_dst": glorot(rng, heads, f),
            "b": (0.1 * rng.standard_normal(heads * f)).astype(np.float32)}


def gat_combine(p, x, heads, f, quant=None):
    """h (B, N, heads, f) and the alpha terms of one GAT layer, through the
    plain int8 combine when `quant` is given."""
    h = (x @ p["w"] if quant is None else apply_quantized_linear(x, quant))
    h = h.reshape(*x.shape[:-1], heads, f)
    # einsum may return a permuted view on the card; the kernels take
    # contiguous operands
    return (h, torch.einsum("...nhf,hf->...nh", h, p["a_dst"]).contiguous(),
            torch.einsum("...nhf,hf->...nh", h, p["a_src"]).contiguous())


def gat_layer_plain(p, x, bias, heads, f, act, quant=None, fused=True):
    """One GAT layer through the plain versions, as a plan runs it: the fp32
    fused layer through `fused_gat_full_plain`; an int8 combine, or the
    unfused `gat_attention` path, as combine, alpha einsums and
    `fused_gat_precombined_plain` (attention, bias, activation)."""
    b = p["b"].reshape(heads, f)
    if quant is None and fused:
        out = fl.fused_gat_full_plain(x, p["w"].reshape(-1, heads, f),
                                      p["a_src"], p["a_dst"], bias, b, act)
    else:
        out = fl.fused_gat_precombined_plain(
            *gat_combine(p, x, heads, f, quant), bias, b, act)
    return out.reshape(*x.shape[:-1], heads * f)


def gat_plain_check(r, e, dev, cache=True):
    """Hold a served GAT request of model entry `e` to the plain forward
    over the host-built masks (which its own masks must equal exactly):
    fp32 whole, at TOL; int8 layer by layer. Returns (max_abs_err, int8
    inputs one step off the all-plain chain, int8 inputs, argmax ties
    within atol); any failure raises."""
    n = r.pg.num_nodes
    check(r.logits is not None and r.logits.shape == (n, GAT_CLASSES)
          and np.isfinite(r.logits).all(),
          f"request {r.uid}: logits missing, misshapen or not finite")
    t = e.tiers[r.tier]
    fused = r.fusion == "layer"
    cal = e.calibrations[r.tier] if t.quantgr else {}
    x = torch.from_numpy(r.pg.features).to(dev)[None]
    ops1 = stack_operands([host_operands(r, e.cfg, dev, cache)])
    h1 = gat_layer_plain(e.params["l1"], x, ops1.bias_add, GAT_HEADS,
                         GAT_F, "elu", cal.get("l1"), fused)
    flips = q_inputs = 0
    if t.quantgr:
        # layer 2 rounds layer 1's fp32 output to int8: where the kernels'
        # and the plain versions' sums straddle a rounding tie, the step
        # moves and the logits with it. So the int8 request is held layer
        # by layer: layer 1 through the served kernels against the plain
        # layer 1, then the logits against the plain layer 2 over the
        # kernels' layer 1.
        kw = dict(heads=GAT_HEADS, out_feats=GAT_F, quant=cal["l1"])
        if fused:
            h1_k = glayers.gat_grannite_fused(
                e.params["l1"], x, ops1.bias_add, t, activation="elu", **kw)
        else:
            h1_k = torch.nn.functional.elu(glayers.gat_grannite(
                e.params["l1"], x, ops1.mask_mult, ops1.bias_add, t, **kw))
        d1 = (h1_k - h1)[0, :n].abs().max().item()
        check(d1 <= TOL["atol"], f"request {r.uid}: layer 1 differs from "
              f"the plain version by {d1}")
        torch.testing.assert_close(h1_k[0, :n], h1[0, :n], **TOL)
        xs = cal["l2"].x_scale
        flips = int((torch.round(h1_k[0, :n] / xs)
                     != torch.round(h1[0, :n] / xs)).sum())
        q_inputs = h1[0, :n].numel()
        h1 = h1_k
    ref = gat_layer_plain(e.params["l2"], h1, ops1.bias_add, 1, GAT_CLASSES,
                          "none", cal.get("l2"), fused)[0, :n].cpu()
    got = torch.from_numpy(r.logits)
    d = (got - ref).abs().max().item()
    check(d <= TOL["atol"], f"request {r.uid}: max_abs_err {d}")
    torch.testing.assert_close(got, ref, **TOL)
    top2 = ref.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= TOL["atol"]
    check(bool((torch.from_numpy(r.preds) == ref.argmax(-1))[~tie].all()),
          f"request {r.uid}: argmax differs")
    return d, flips, q_inputs, int(tie.sum())


def gat_work(h_shape, nbytes_in, fin=0):
    """(flops, expf count, bytes) of one batched GAT attention: 2*F flops
    and one expf per (head, row, column), inputs read once and the
    (B, N, H, F) output written once. With `fin`, the combine H = X @ W
    too."""
    bsz, n, heads, f = h_shape
    flops = 2.0 * heads * bsz * n * n * f + 2.0 * bsz * n * fin * heads * f
    return flops, float(heads * bsz * n * n), nbytes_in + 4.0 * bsz * n * \
        heads * f


def sage_layer_np(rng, fin, fout, aggregator):
    """numpy weights of one SAGE layer: w_self, w_neigh (fin, fout) and a
    small random bias; max adds the pool combine w_pool (fin, fin) and
    b_pool."""
    p = {"w_self": glorot(rng, fin, fout), "w_neigh": glorot(rng, fin, fout),
         "b": (0.1 * rng.standard_normal(fout)).astype(np.float32)}
    if aggregator == "max":
        p["w_pool"] = glorot(rng, fin, fin)
        p["b_pool"] = (0.1 * rng.standard_normal(fin)).astype(np.float32)
    return p


def sage_pooled(p, x):
    """The max aggregator's pool combine relu(x @ w_pool + b_pool)."""
    return torch.relu(x @ p["w_pool"] + p["b_pool"])


def sage_layer_plain(p, x, sample, mean, aggregator, act, quant=None):
    """One SAGE layer through the plain versions, as a plan runs it: the
    mean product or the pool combine and `sage_max_plain`, then both
    combines, bias and activation; the combines through the plain int8
    chain when `quant` (self, neigh, pool) is given."""
    q = quant or {}

    def lin(v, w, name):
        return v @ w if name not in q else apply_quantized_linear(v, q[name])
    if aggregator == "mean":
        agg = torch.matmul(mean, x)
    else:
        agg = sm.sage_max_plain(sample, torch.relu(
            lin(x, p["w_pool"], "pool") + p["b_pool"]))
    z = lin(x, p["w_self"], "self") + lin(agg, p["w_neigh"], "neigh") + p["b"]
    return torch.relu(z) if act == "relu" else z


def walk_work(mask, f):
    """(ops, bytes) of one masked walk over a (B, N, N) mask to F features:
    a multiply and a max (or one fma, counted as 2) per set entry and
    feature; the whole mask read once (the scan must read every entry to
    find the set ones), each feature row that a set entry names read once
    (NodePad's rows are named by none), the (B, N, F) output written
    once."""
    nz = mask != 0
    bsz, n, _ = mask.shape
    named = float(nz.any(dim=-2).sum().item())
    return (2.0 * float(nz.sum().item()) * f,
            nbytes(mask) + 4.0 * named * f + 4.0 * bsz * n * f)


def fused_sage_work(mask, xk, x, w_self, w_neigh, b, aggregator, act):
    """(walk ops, combine flops, bytes) of one fused SAGE layer: the walk's
    multiply-max (or fma) per set entry and feature, both combines'
    products; the mask, X, the weights and the bias read once, for max
    also each pooled row that a set entry names, and the (B, N, O) output
    written once."""
    bsz, n, fin = x.shape
    o = w_self.shape[1]
    nz = mask != 0
    moved = nbytes(mask, x, w_self, w_neigh, b) + 4.0 * bsz * n * o
    if aggregator == "max":
        moved += 4.0 * float(nz.any(dim=-2).sum().item()) * fin
    return (2.0 * float(nz.sum().item()) * fin, 4.0 * bsz * n * fin * o,
            moved)


def sage_bound(walk_ops, flops, nbytes_, tf32=True):
    """(least ms, what bounds it): the walk's operations at the fp32 rate,
    then the combine's products as the kernel does them (three TF32
    products per fp32 product on the tensor cores) or with tf32=False on
    fp32 FMA; or the HBM bytes."""
    t_ops = walk_ops / FP32_FLOPS_PER_S + (
        3 * flops / TF32_FLOPS_PER_S if tf32 else flops / FP32_FLOPS_PER_S)
    t_bytes = nbytes_ / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def gat_bound(flops, exps, nbytes_, tf32=True):
    """(least ms, what bounds it): the products as the kernels do them
    (three TF32 products per fp32 product on the tensor cores), or with
    tf32=False on fp32 FMA; the expf on the SFUs; the HBM bytes."""
    t_ops = max(3 * flops / TF32_FLOPS_PER_S if tf32
                else flops / FP32_FLOPS_PER_S, exps / SFU_EXP_PER_S)
    t_bytes = nbytes_ / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------ the LM path
# bf16 tensor-core peak (H100 SXM data sheet, dense): the flash bound's
# operation term, as for any attention kernel on this card
BF16_FLOPS_PER_S = 989e12
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# (B, Sq, Skv, H, KV, D, causal, window, softcap, q_offset), each in fp32
# and bf16 (bf16 at D 64, 96, 128 takes the tensor-core route, the rest the
# SIMT one): SmolLM's serving shapes (9 query heads over 3 KV heads of
# 64), a ragged S, gemma2's heads with its window and softcap, non-causal,
# q_offset (a prompt's last 64 positions over a 256-key cache), rows that
# no key may reach, the reduced configs' head_dim 32, and Sq = Skv on both
# sides of the tensor-core key tiles (128 keys at D 64, 64 at D 128)
FLASH_CASES = {
    "smollm S64": (4, 64, 64, 9, 3, 64, True, None, None, 0),
    "smollm S128": (4, 128, 128, 9, 3, 64, True, None, None, 0),
    "smollm S256": (4, 256, 256, 9, 3, 64, True, None, None, 0),
    "ragged S200": (4, 200, 200, 9, 3, 64, True, None, None, 0),
    "gemma2 window 64 softcap 50": (1, 256, 256, 32, 16, 128, True, 64,
                                    50.0, 0),
    "non-causal": (4, 128, 128, 9, 3, 64, False, None, None, 0),
    "q_offset 192": (4, 64, 256, 9, 3, 64, True, None, None, 192),
    "window past the keys": (1, 64, 256, 4, 2, 64, True, 48, None, 250),
    "head_dim 32": (2, 96, 96, 4, 2, 32, True, None, None, 0),
    "ragged S63": (4, 63, 63, 9, 3, 64, True, None, None, 0),
    "ragged S65": (4, 65, 65, 9, 3, 64, True, None, None, 0),
    "ragged S127": (4, 127, 127, 9, 3, 64, True, None, None, 0),
    "ragged S129": (4, 129, 129, 9, 3, 64, True, None, None, 0),
    "qwen3 D128 S64": (2, 64, 64, 32, 8, 128, True, None, None, 0),
    "qwen3 D128 S65": (2, 65, 65, 32, 8, 128, True, None, None, 0),
    "qwen3 D128 S129": (2, 129, 129, 32, 8, 128, True, None, None, 0),
    "D128 window past the keys": (1, 65, 129, 8, 4, 128, False, 30, None,
                                  120),
    # the prefill shapes of [serve-moe] (OLMoE, 16/16 heads of 128) and
    # [serve-hybrid] (Jamba, 32/8 heads of 128) at bucket 256
    "olmoe S256": (4, 256, 256, 16, 16, 128, True, None, None, 0),
    "jamba S256": (4, 256, 256, 32, 8, 128, True, None, None, 0),
    # [serve-audio]'s Whisper-base: the encoder, non-causal over 1500
    # frames (a multiple of neither the 64-row q tile nor the 128-key
    # tile), and the decoder's cross-attention, bucket 256 over the frames;
    # [serve-vlm]'s Phi-3-vision (32/32 heads of 96: 1024 patches and a
    # 256-token prompt), and head dim 96 ragged and non-causal (the
    # tensor-core route runs D 96 on the D 128 tiles, zero-filled)
    "whisper encoder S1500": (4, 1500, 1500, 8, 8, 64, False, None, None, 0),
    "whisper cross 256x1500": (4, 256, 1500, 8, 8, 64, False, None, None,
                               0),
    "phi3v S1280 D96": (4, 1280, 1280, 32, 32, 96, True, None, None, 0),
    "D96 ragged S65": (4, 65, 65, 32, 32, 96, True, None, None, 0),
    "D96 non-causal 65x129": (4, 65, 129, 32, 32, 96, False, None, None, 0),
    # [serve-dense]'s and [serve-scout]'s head layouts at full width:
    # chatglm3's group of 16 (32/2), Llama-4-Scout's group of 5 (40/8),
    # and gemma2's long wave, whose local layers mask keys past the 4096
    # window
    "chatglm3 32/2 D128 S256": (4, 256, 256, 32, 2, 128, True, None, None,
                                0),
    "llama4 40/8 D128 S256": (4, 256, 256, 40, 8, 128, True, None, None, 0),
    "gemma2 S4608 window 4096 softcap 50": (1, 4608, 4608, 32, 16, 128,
                                            True, 4096, 50.0, 0),
}
# (B, Sq, Skv, H, KV, D, causal[, window, softcap]) timed in [time]: the
# row's own numbers are the first's
FLASH_TIMED = {"serving (B 4, S 256, 9/3 heads of 64)": (4, 256, 256, 9, 3,
                                                        64, True),
               "long (B 1, S 4096, 32/8 heads of 128)": (1, 4096, 4096, 32,
                                                         8, 128, True),
               "olmoe prefill (B 4, S 256, 16/16 heads of 128)": (
                   4, 256, 256, 16, 16, 128, True),
               "whisper encoder (B 4, S 1500, 8/8 heads of 64, non-causal)":
                   (4, 1500, 1500, 8, 8, 64, False),
               "whisper cross (B 4, 256 x 1500, 8/8 heads of 64, "
               "non-causal)": (4, 256, 1500, 8, 8, 64, False),
               "phi3v prefill (B 4, S 1280, 32/32 heads of 96)": (
                   4, 1280, 1280, 32, 32, 96, True),
               "llama4 prefill (B 4, S 256, 40/8 heads of 128)": (
                   4, 256, 256, 40, 8, 128, True),
               "gemma2 long wave (B 1, S 4608, 32/16 heads of 128, window "
               "4096, softcap 50)": (1, 4608, 4608, 32, 16, 128, True, 4096,
                                     50.0)}
# the [time] keys of the FLASH_TIMED shapes in the kernels line
FLASH_TIMED_KEYS = ("serving", "long", "olmoe_prefill", "whisper_encoder",
                    "whisper_cross", "phi3v_prefill", "llama4_prefill",
                    "gemma2_long")
# the __global__ names of flash_attention.cu and flash_attention_tc.cu, as
# torch.profiler reports them
FLASH_KERNELS = ("flash_kernel", "flash_tc_kernel")
LM_ARCH, LM_BUCKETS, LM_MAX_LEN, LM_SLOTS, LM_NEW = (
    "smollm-135m", (64, 128, 256), 512, 4, 16)
LM_LAYERS_SMOLLM = 30               # flash_attention calls per prefill
# prefill logits with the kernel against the plain attention, both bf16
# through 30 layers: the largest difference relative to the largest |logit|
LM_LOGIT_BAR = 5e-2


def flash_inputs(rng, shape, dtype, dev):
    b, sq, skv, h, kv, d = shape[:6]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             ).to(dev, dtype)
            for s in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))]


def flash_work(q, k, causal=True, window=None, q_offset=0):
    """(operations, bytes) of one flash_attention call: 4*D per (row,
    key) pair the inputs need (a row that no key may reach averages every
    key), q, k, v read and out written once."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qpos = np.arange(sq) + q_offset
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    pairs = np.where(lo <= hi, hi - lo + 1, skv).sum()
    return 4.0 * d * b * h * float(pairs), 2 * nbytes(q) + 2 * nbytes(k)


def flash_phase(dev):
    """[flash]: the kernel against flash_attention_ref on the card at every
    case in both dtypes, through whichever route each takes. Returns the
    largest error per route."""
    rng = np.random.default_rng(21)
    worst = {}
    for label, (b, sq, skv, h, kv, d, causal, window, cap,
                off) in FLASH_CASES.items():
        opts = dict(causal=causal, window=window, softcap=cap, q_offset=off)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(rng, (b, sq, skv, h, kv, d), dtype, dev)
            route = fa.flash_route(dtype, d)
            before = (fa.LAUNCHES, flash_routes_now())
            got = fa.flash_attention(q, k, v, **opts)
            torch.cuda.synchronize()
            want_routes = dict(before[1])
            want_routes[route] += 1
            check(fa.LAUNCHES == before[0] + 1
                  and flash_routes_now() == want_routes,
                  f"[flash] {label}: no launch on the {route} route")
            want = kref.flash_attention_ref(q, k, v, **opts)
            e = (got.float() - want.float()).abs().max().item()
            key = f"{route} {str(dtype)[6:]}"
            worst[key] = max(worst.get(key, 0.0), e)
            torch.testing.assert_close(got.float(), want.float(),
                                       **FLASH_TOL[dtype])
            print(f"[flash] {label}, {str(dtype)[6:]}, {route} route: "
                  f"max_abs_err {e:.3e}", flush=True)
    return worst


def lm_params_np(cfg, rng):
    """Random weights of a dense `cfg` in numpy, in the bridge's layout
    (leaves stacked over superblocks): N(0, 1/fan_in) matrices, a unit
    normal embedding, norm scales 1 + 0.1 N(0, 1)."""
    nsb, d, hh, kv = (cfg.num_superblocks, cfg.d_model, cfg.num_heads,
                      cfg.num_kv_heads)
    hd, ff = cfg.head_dim_, cfg.d_ff

    def dense(*shape, fan_in):
        a = rng.standard_normal((nsb, *shape), dtype=np.float32)
        a *= np.float32(fan_in ** -0.5)
        return a

    def norm(*lead):
        return {"scale": (1.0 + 0.1 * rng.standard_normal(
            (*lead, d))).astype(np.float32)}

    def head_norm():
        return ((1.0 + 0.1 * rng.standard_normal((nsb, hd))
                 ).astype(np.float32) if cfg.qk_norm else None)

    stack = []
    for _ in cfg.superblock:
        layer = {"pre_norm": norm(nsb),
                 "mixer": {"wq": dense(d, hh, hd, fan_in=d),
                           "wk": dense(d, kv, hd, fan_in=d),
                           "wv": dense(d, kv, hd, fan_in=d),
                           "wo": dense(hh, hd, d, fan_in=hh * hd),
                           "q_norm": head_norm(), "k_norm": head_norm()},
                 "pre_mlp_norm": norm(nsb),
                 "mlp": {"w_in": dense(d, ff, fan_in=d),
                         "w_up": dense(d, ff, fan_in=d),
                         "w_out": dense(ff, d, fan_in=ff)}}
        if cfg.post_norms:
            layer.update(post_norm=norm(nsb), post_mlp_norm=norm(nsb))
        stack.append(layer)
    embed = rng.standard_normal((cfg.vocab_size, d), dtype=np.float32)
    unembed = (None if cfg.tie_embeddings else
               rng.standard_normal((d, cfg.vocab_size), dtype=np.float32)
               * np.float32(d ** -0.5))
    return {"embed": embed, "stack": stack, "final_norm": norm(),
            "unembed": unembed}


def device_kernels(fn, iters=1, host=None):
    """The CUDA kernels of `iters` calls of `fn`, from torch.profiler:
    {kernel name: (own device ms summed, launches)}. A dict passed as
    `host` gets the host's operators likewise: {name: (own CPU ms under
    the profiler, calls)}."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():      # one name may head several entries
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
        elif host is not None:
            ms, n = host.get(e.key, (0.0, 0))
            host[e.key] = (ms + e.self_cpu_time_total / 1e3, n + e.count)
    return out


def device_busy(fn):
    """What torch.profiler recorded of one call: (device ms of its kernels,
    kernels, device ms and launches of the flash_attention kernels). It may
    miss launches, so the caller compares the flash launches with the
    server's counter."""
    ks = device_kernels(fn)
    fa_ks = [v for name, v in ks.items()
             if any(k in name for k in FLASH_KERNELS)]
    return (sum(ms for ms, _ in ks.values()), sum(n for _, n in ks.values()),
            sum(ms for ms, _ in fa_ks), sum(n for _, n in fa_ks))


def ms_or_not(ms, digits=4):
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def lm_prompts(rng, vocab):
    """LM_SLOTS prompts per bucket, each wave's lengths inside its bucket
    (so the waves take 64, 128 and 256 in turn)."""
    prompts, lo = [], 8
    for bucket in LM_BUCKETS:
        prompts += [rng.integers(0, vocab, int(n)).astype(np.int32)
                    for n in rng.integers(lo, bucket + 1, LM_SLOTS)]
        lo = bucket + 1
    return prompts


def serve_lm_phase(dev, card):
    """[serve-lm]: SmolLM-135M at full width served on the card, every
    prefill's attention through flash_attention. Returns (launches of the
    run, relative logit error, timings)."""
    cfg = get_config(LM_ARCH)
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    tree = lm_params_np(cfg, rng)
    params = lm_params_from_jax(tree, device=dev)

    def count(node):
        if isinstance(node, np.ndarray):
            return node.size
        items = node.values() if isinstance(node, dict) else node
        return sum(count(v) for v in items if v is not None)
    n_params = count(tree)
    print(f"[serve-lm] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{n_params:,} parameters (fp32, {cfg.compute_dtype} compute) "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    sc = ServeConfig(buckets=LM_BUCKETS, max_len=LM_MAX_LEN,
                     batch_slots=LM_SLOTS)
    warm = Server(cfg, sc, params=params, device=dev)
    for bucket in LM_BUCKETS:                 # one wave per bucket
        warm.submit(rng.integers(0, cfg.vocab_size, bucket), max_new_tokens=2)
        warm.run()
    prompts = lm_prompts(rng, cfg.vocab_size)
    server = Server(cfg, sc, params=params, device=dev)
    for p in prompts:
        server.submit(p, max_new_tokens=LM_NEW)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launches_now()
    routes = flash_routes_now()
    s = server.summary()
    want = dict.fromkeys(COUNTERS, 0) | {
        "flash_attention": s["prefills"] * cfg.num_layers}
    print(f"[serve-lm] {len(done)} requests in {s['prefills']} waves; "
          f"launches {launches}, expected {want}; flash_attention by route "
          f"{routes}; summary " + json.dumps(s), flush=True)
    check(launches == want, f"kernel launches {launches} != {want}")
    check(launches["flash_attention"] == 3 * cfg.num_layers,
          "flash_attention did not run every prefill layer")
    # every prefill layer on the tensor cores: bf16 at head dim 64
    check(fa.flash_route(torch.bfloat16, cfg.head_dim_) == "wgmma"
          and routes == {"wgmma": cfg.num_layers * s["prefills"], "simt": 0},
          f"flash_attention routes {routes}: expected {cfg.num_layers} "
          "tensor-core launches per prefill and no other")
    check(s["prefills"] == len(LM_BUCKETS)
          and s["compiled_blobs"] <= len(LM_BUCKETS) + 1
          and s["requests"] == len(prompts)
          and s["tokens_out"] == LM_NEW * len(prompts)
          and s["decode_steps"] == (LM_NEW - 1) * len(LM_BUCKETS),
          f"server counters {s}")
    check(sorted(r.uid for r in done) == list(range(len(prompts)))
          and all(r.output.shape == (LM_NEW,) and r.output.min() >= 0
                  and r.output.max() < cfg.vocab_size for r in done),
          "served outputs are not LM_NEW tokens of the vocabulary each")

    # the last wave's prefill again, with the kernel and with the plain
    # attention, on the same padded tokens
    wave = done[-LM_SLOTS:]
    toks = np.zeros((LM_SLOTS, LM_BUCKETS[-1]), np.int32)
    for i, r in enumerate(wave):
        toks[i, :len(r.prompt)] = r.prompt
    toks_d = torch.from_numpy(toks).long().to(dev)
    sp = server.params                  # the weights the server computes on
    with torch.inference_mode():
        got, state = lm.lm_prefill(sp, cfg, toks_d, max_len=LM_MAX_LEN)
        steps = {"prefill": lambda: lm.lm_prefill(
            sp, cfg, toks_d, max_len=LM_MAX_LEN),
            "decode step": lambda: lm.lm_decode_step(
                sp, cfg, got.argmax(-1), state)}
        busy = {k: device_busy(fn) for k, fn in steps.items()}
    check(bool(torch.isfinite(got).all()) and got.shape == (
        LM_SLOTS, cfg.vocab_size), "prefill logits not finite or misshaped")
    check(np.array_equal(got.argmax(-1).cpu().numpy(),
                         [r.output[0] for r in wave]),
          "the served first tokens differ from a rerun of the prefill")
    rel = plain_logit_check("serve-lm", cfg, sp, toks_d, LM_MAX_LEN)

    ttft = {}
    for bucket, sec in server.metrics["ttft_s"]:
        ttft.setdefault(bucket, []).append(sec * 1e3)
    step_ms = server.metrics["decode_s"] / s["decode_steps"] * 1e3
    timing = {"ttft_ms_by_bucket": {b: float(np.mean(v))
                                    for b, v in ttft.items()},
              "decode_ms_per_step": step_ms,
              "decode_tokens_per_s": LM_SLOTS / step_ms * 1e3,
              "tokens_per_s": s["tokens_out"] / run_s, "run_s": run_s}
    for b, ms in timing["ttft_ms_by_bucket"].items():
        print(f"[serve-lm] time to first token, bucket {b} (wave start to "
              f"its first tokens on the host, 4 slots): {ms:.2f} ms; {card}",
              flush=True)
    host_ms = {"prefill": timing["ttft_ms_by_bucket"][LM_BUCKETS[-1]],
               "decode step": step_ms}
    for what, (dev_ms, n, fa_ms, fa_n) in busy.items():
        print(f"[serve-lm] {what} at bucket {LM_BUCKETS[-1]}: {n} device "
              f"operations, {dev_ms:.3f} ms of device time (torch.profiler) "
              f"against {host_ms[what]:.3f} ms on the host clock unprofiled"
              f": device idle share {1 - dev_ms / host_ms[what]:.3f}; "
              f"flash_attention: {fa_n} launches recorded, {fa_ms:.3f} ms "
              f"({fa_ms / dev_ms:.3f} of the device time); {card}",
              flush=True)
    timing["device_busy_ms"] = {k: v[0] for k, v in busy.items()}
    print(f"[serve-lm] decode: {step_ms:.3f} ms per step of {LM_SLOTS} "
          f"slots, {timing['decode_tokens_per_s']:.1f} tokens/s; whole run "
          f"{run_s:.3f} s, {timing['tokens_per_s']:.1f} tokens/s; {card}",
          flush=True)
    return launches["flash_attention"], rel, timing


# [serve-moe], [serve-ssm], [serve-hybrid]: the three families at full
# width on the card, bf16, the port's own seeded init made on the card in
# the compute dtype (no float32 copy of a model is ever whole); Jamba keeps
# one 8-layer superblock of its 32 layers (all four would not fit in 80
# GB). Buckets, slots and new tokens as [serve-lm]. The models are held
# layer by layer (`nn/layerwise.py`): every attention layer's mixer branch
# and every layer's output over the tokens whose routes and kept
# assignments agree meet LM_LOGIT_BAR of their largest |value|; over the
# MoE layers the kernel path's routes agree with the plain path's on at
# least ROUTE_AGREE_MIN of the tokens, and at least as often as the exact
# (float32, rounded once) attention's do, less ROUTE_MARGIN: a bf16
# router flips some top-k sets under any one-step change of its input,
# whichever attention made it. The SSD layer in fp32 against the
# sequential oracle: SSD_BAR of the oracle's largest |output|.
MOE_ARCH, SSM_ARCH, HYBRID_ARCH, HYBRID_LAYERS = (
    "olmoe-1b-7b", "mamba2-2.7b", "jamba-v0.1-52b", 8)
ROUTE_AGREE_MIN, ROUTE_MARGIN = 0.99, 0.01
SSD_BAR = 1e-4
SSD_SHAPE = (2, 512)                 # (B, S): two chunks of 256


def free_card():
    """Let go of what the last phase held on the card; the peak memory
    counts from here."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def card_model(tag, cfg, dev, seed):
    """`lm_init` on the card in the compute dtype (each matrix drawn and
    rounded before the next); prints the analytic and the allocated
    parameter counts, the bytes and the seconds."""
    t0 = time.perf_counter()
    params = lm.lm_init(cfg, seed=seed, device=dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [t for t in pytree.tree_leaves(params)
              if isinstance(t, torch.Tensor)]
    n = sum(t.numel() for t in leaves)
    nb = sum(t.numel() * t.element_size() for t in leaves)
    parts = []
    if not cfg.attention_free:
        parts.append(f"heads {cfg.num_heads}/{cfg.num_kv_heads} of "
                     f"{cfg.head_dim_}")
    if cfg.moe is not None:
        parts.append(f"MoE {cfg.moe.num_experts} experts top-"
                     f"{cfg.moe.top_k} of {cfg.moe.d_ff_expert}, capacity "
                     f"factor {cfg.moe.capacity_factor}")
    if cfg.encoder is not None:
        parts.append(f"an encoder of {cfg.encoder.num_layers} layers over "
                     f"{cfg.encoder.frames} frames, cross-attention in every "
                     "decoder layer")
    if cfg.ssm is not None:
        d_in, heads, _, n_state = ssm.ssm_dims(cfg)
        parts.append(f"SSM d_in {d_in}, {heads} heads of "
                     f"{cfg.ssm.headdim}, d_state {n_state}, chunk "
                     f"{cfg.ssm.chunk}")
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers {cfg.superblock} x "
          f"{cfg.num_superblocks}, d_model {cfg.d_model}, "
          + ", ".join(parts) + f", vocab "
          f"{cfg.vocab_size}; {cfg.param_count():,} parameters "
          f"({cfg.active_param_count():,} active a token), {n:,} allocated "
          f"({nb / 1e9:.2f} GB, {cfg.compute_dtype} matrices) made on the "
          f"card in {init_s:.1f} s; card memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return params


def bucket_prompts(rng, vocab):
    """LM_SLOTS prompts of each bucket's length exactly."""
    return [rng.integers(0, vocab, b).astype(np.int32)
            for b in LM_BUCKETS for _ in range(LM_SLOTS)]


def serve_waves(tag, cfg, params, dev, prompts, rng):
    """A warm-up wave per bucket, then `prompts` (one wave per bucket),
    LM_NEW tokens each, with every launch count set to 0 just before.
    Checks the counters, the outputs' shape and flash_attention's launches
    (one per attention layer and wave, nothing else). Returns (server,
    finished requests, flash_attention launches, run seconds)."""
    sc = ServeConfig(buckets=LM_BUCKETS, max_len=LM_MAX_LEN,
                     batch_slots=LM_SLOTS)
    warm = Server(cfg, sc, params=params, device=dev)
    for bucket in LM_BUCKETS:
        warm.submit(rng.integers(0, cfg.vocab_size, bucket), max_new_tokens=2)
        warm.run()
    del warm
    server = Server(cfg, sc, params=params, device=dev)
    for p in prompts:
        server.submit(p, max_new_tokens=LM_NEW)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, routes = launches_now(), flash_routes_now()
    s = server.summary()
    n_attn = attention_layers(cfg)
    want = dict.fromkeys(COUNTERS, 0) | {
        "flash_attention": s["prefills"] * n_attn}
    print(f"[{tag}] mode {server.sc.mode}: {len(done)} requests in "
          f"{s['prefills']} waves; launches {launches}, expected {want} "
          f"({n_attn} attention layers a prefill wave); flash_attention by "
          f"route {routes}; summary " + json.dumps(s), flush=True)
    check(launches == want, f"[{tag}] kernel launches {launches} != {want}")
    check(routes["wgmma"] == want["flash_attention"],
          f"[{tag}] flash_attention routes {routes}: every prefill layer "
          "should take the tensor-core route")
    check(s["prefills"] == len(LM_BUCKETS)
          and s["compiled_blobs"] <= len(LM_BUCKETS) + 1
          and s["requests"] == len(prompts)
          and s["tokens_out"] == LM_NEW * len(prompts)
          and s["decode_steps"] == (LM_NEW - 1) * len(LM_BUCKETS),
          f"[{tag}] server counters {s}")
    check(sorted(r.uid for r in done) == list(range(len(prompts)))
          and all(r.output.shape == (LM_NEW,) and r.output.min() >= 0
                  and r.output.max() < cfg.vocab_size for r in done),
          f"[{tag}] served outputs are not LM_NEW tokens of the vocabulary")
    return server, done, launches["flash_attention"], run_s


def last_wave_tokens(done, dev):
    wave = done[-LM_SLOTS:]
    toks = np.zeros((LM_SLOTS, LM_BUCKETS[-1]), np.int32)
    for i, r in enumerate(wave):
        toks[i, :len(r.prompt)] = r.prompt
    return wave, torch.from_numpy(toks).long().to(dev)


def serve_timing(tag, cfg, server, done, dev, card, run_s):
    """Time to first token per bucket, decode ms per step and tokens/s;
    the device time of a bucket-256 prefill and of a decode step from
    torch.profiler against the host's, and their idle shares; the last
    wave's prefill logits finite and giving the served first tokens.
    Returns (timing dict, the last wave's tokens, the prefill's device
    ms)."""
    s = server.summary()
    wave, toks = last_wave_tokens(done, dev)
    sp = server.params
    with torch.inference_mode():
        got, state = lm.lm_prefill(sp, cfg, toks, max_len=LM_MAX_LEN)
        busy = {"prefill": device_busy(lambda: lm.lm_prefill(
            sp, cfg, toks, max_len=LM_MAX_LEN)),
            "decode step": device_busy(lambda: lm.lm_decode_step(
                sp, cfg, got.argmax(-1), state))}
        kernels = device_kernels(lambda: lm.lm_prefill(
            sp, cfg, toks, max_len=LM_MAX_LEN))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"[{tag}] the bucket-{LM_BUCKETS[-1]} prefill's largest device "
          f"kernels (torch.profiler): " + "; ".join(
              f"{name[:70]} {ms:.3f} ms x {n}" for name, (ms, n) in top)
          + f"; {card}", flush=True)
    check(bool(torch.isfinite(got).all())
          and got.shape == (LM_SLOTS, cfg.vocab_size),
          f"[{tag}] prefill logits not finite or misshaped")
    check(np.array_equal(got.argmax(-1).cpu().numpy(),
                         [r.output[0] for r in wave]),
          f"[{tag}] the served first tokens differ from a rerun of the "
          "prefill")
    ttft = {}
    for bucket, sec in server.metrics["ttft_s"]:
        ttft.setdefault(bucket, []).append(sec * 1e3)
    step_ms = server.metrics["decode_s"] / s["decode_steps"] * 1e3
    timing = {"ttft_ms_by_bucket": {b: float(np.mean(v))
                                    for b, v in ttft.items()},
              "decode_ms_per_step": step_ms,
              "decode_tokens_per_s": LM_SLOTS / step_ms * 1e3,
              "tokens_per_s": s["tokens_out"] / run_s, "run_s": run_s}
    for b, ms in timing["ttft_ms_by_bucket"].items():
        print(f"[{tag}] time to first token, bucket {b} (wave start to its "
              f"first tokens on the host, {LM_SLOTS} slots): {ms:.2f} ms; "
              f"{card}", flush=True)
    host_ms = {"prefill": timing["ttft_ms_by_bucket"][LM_BUCKETS[-1]],
               "decode step": step_ms}
    for what, (dev_ms, n, fa_ms, fa_n) in busy.items():
        print(f"[{tag}] {what} at bucket {LM_BUCKETS[-1]}: {n} device "
              f"operations, {dev_ms:.3f} ms of device time (torch.profiler) "
              f"against {host_ms[what]:.3f} ms on the host clock unprofiled"
              f": device idle share {1 - dev_ms / host_ms[what]:.3f}; "
              f"flash_attention: {fa_n} launches recorded, {fa_ms:.3f} ms "
              f"({fa_ms / dev_ms if dev_ms else 0.0:.3f} of the device "
              f"time); {card}", flush=True)
    print(f"[{tag}] decode: {step_ms:.3f} ms per step of {LM_SLOTS} slots, "
          f"{timing['decode_tokens_per_s']:.1f} tokens/s; whole run "
          f"{run_s:.3f} s, {timing['tokens_per_s']:.1f} tokens/s; {card}",
          flush=True)
    timing["device_ms"] = {k: v[0] for k, v in busy.items()}
    timing["idle_share"] = {k: 1 - v[0] / host_ms[k]
                            for k, v in busy.items()}
    return timing, toks, busy["prefill"][0]


def moe_dispatch_share(tag, cfg, dev, prefill_dev_ms, card):
    """The EffOp dispatch einsum (G,E,C)^T (G,d) and the combine einsum at
    the bucket-256 prefill's group, timed alone queued behind a spin, per
    MoE layer and over the model's MoE layers, against the prefill's
    device time (torch.profiler)."""
    m = cfg.moe
    t = LM_SLOTS * LM_BUCKETS[-1]
    g = min(m.group_size, t)
    ng, cap, d, e = t // g, moe.capacity(m, g), cfg.d_model, m.num_experts
    gen = torch.Generator(device=dev).manual_seed(5)
    disp = (torch.rand(ng, g, e, cap, device=dev, generator=gen) < 0.01
            ).to(cfg.dtype)
    xg = torch.randn(ng, g, d, device=dev, generator=gen).to(cfg.dtype)
    out = torch.randn(ng, e, cap, d, device=dev, generator=gen).to(cfg.dtype)
    n_moe = sum(cfg.layer_uses_moe(i % len(cfg.superblock),
                                   cfg.superblock[i % len(cfg.superblock)])
                for i in range(cfg.num_layers))
    ms = {"dispatch": queued_ms(lambda: torch.einsum("ngec,ngd->necd",
                                                     disp, xg)),
          "combine": queued_ms(lambda: torch.einsum("ngec,necd->ngd",
                                                    disp, out))}
    gflop = 2.0 * ng * g * e * cap * d / 1e9
    for k, v in ms.items():
        share = (None if v is None or not prefill_dev_ms
                 else n_moe * v / prefill_dev_ms)
        print(f"[{tag}] MoE {k} einsum at the bucket-{LM_BUCKETS[-1]} "
              f"prefill's shape ({ng} group(s) of {g} tokens, {e} experts x "
              f"{cap} slots, d {d}; {gflop:.1f} GFLOP): "
              f"{ms_or_not(v)} queued behind a spin, x {n_moe} MoE layers "
              f"= " + ("not measured" if share is None else
                       f"{n_moe * v:.3f} ms, {share:.3f} of the prefill's "
                       f"{prefill_dev_ms:.3f} device ms") + f"; {card}",
              flush=True)
    return ms


def route_check(tag, cfg, params, toks):
    """The layer-by-layer check of the kernel path against the plain
    attention (`compare_attention_paths`) on the last wave's tokens.
    Returns (the kernel's route agreement, the control's)."""
    diffs = compare_attention_paths(params, cfg, toks)
    for d in diffs:
        if d.kind.startswith("attn") or d.moe:
            print(f"[{tag}] layer {d.layer} ({d.kind}"
                  f"{', MoE' if d.moe else ''}): x + mixer max |kernel - "
                  f"plain| {d.mixer_diff:.4g} of {d.mixer_max:.4g} "
                  f"({d.mixer_diff / d.mixer_max:.3e}); routes agree on "
                  f"{d.routes_agree} of {d.tokens} tokens (exact vs plain "
                  f"{d.control_agree}), with the kept assignments "
                  f"{d.kept_agree}; output max |kernel - plain| over those "
                  f"{d.max_abs_diff:.4g} of {d.max_abs_out:.4g} "
                  f"({d.max_abs_diff / d.max_abs_out:.3e}; bar "
                  f"{LM_LOGIT_BAR})", flush=True)
        check(d.mixer_diff <= LM_LOGIT_BAR * d.mixer_max
              and d.max_abs_diff <= LM_LOGIT_BAR * d.max_abs_out,
              f"[{tag}] layer {d.layer}: kernel and plain attention paths "
              f"differ: {d}")
    moe_d = [d for d in diffs if d.moe]
    tokens = sum(d.tokens for d in moe_d)
    agree = sum(d.routes_agree for d in moe_d) / tokens
    control = sum(d.control_agree for d in moe_d) / tokens
    kept = sum(d.kept_agree for d in moe_d) / tokens
    print(f"[{tag}] over the {len(moe_d)} MoE layers: routes agree on "
          f"{agree:.5f} of tokens, kernel vs plain; control, exact vs plain "
          f"{control:.5f} (bars: {ROUTE_AGREE_MIN}, and the control less "
          f"{ROUTE_MARGIN}); routes and kept assignments {kept:.5f}",
          flush=True)
    check(agree >= max(ROUTE_AGREE_MIN, control - ROUTE_MARGIN),
          f"[{tag}] routes agree on {agree}, the control on {control}")
    return agree, control


def serve_moe_phase(dev, card, tag="serve-moe", arch=MOE_ARCH, layers=None):
    """[serve-moe] (OLMoE-1B-7B, every layer MoE, at full width and depth),
    [serve-hybrid] (Jamba, one superblock) and [serve-scout]
    (Llama-4-Scout, 12 layers): serve a dozen requests,
    time them, the dispatch's share, the route check. Returns
    (flash_attention launches, summary)."""
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        full = cfg
        cfg = dataclasses.replace(cfg, num_layers=layers)
        print(f"[{tag}] {cfg.name}: depth cut to {layers} of "
              f"{full.num_layers} layers at full width: "
              f"{cfg.param_count():,} of {full.param_count():,} parameters "
              f"({cfg.active_param_count():,} of "
              f"{full.active_param_count():,} active a token)", flush=True)
    rng = np.random.default_rng(31)
    params = card_model(tag, cfg, dev, seed=31)
    server, done, launches, run_s = serve_waves(
        tag, cfg, params, dev, lm_prompts(rng, cfg.vocab_size), rng)
    timing, toks, prefill_ms = serve_timing(tag, cfg, server, done, dev,
                                            card, run_s)
    timing["moe_einsum_ms"] = moe_dispatch_share(tag, cfg, dev, prefill_ms,
                                                 card)
    timing["route_agreement"], timing["route_control"] = route_check(
        tag, cfg, server.params, toks)
    timing["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del server, params, done, toks
    free_card()
    print(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s; peak "
          f"card memory {timing['peak_gb']:.2f} GB", flush=True)
    return launches, timing


def serve_ssm_phase(dev, card):
    """[serve-ssm]: Mamba2-2.7B in full. Serving (waves) on bucket-length
    prompts must equal greedy_generate's tokens; one full-width SSD layer
    in fp32 against the sequential oracle. Returns the timing."""
    t_phase = time.perf_counter()
    tag = "serve-ssm"
    cfg = get_config(SSM_ARCH)
    rng = np.random.default_rng(37)
    params = card_model(tag, cfg, dev, seed=37)
    server, done, launches, run_s = serve_waves(
        tag, cfg, params, dev, bucket_prompts(rng, cfg.vocab_size), rng)
    check(server.sc.mode == "wave" and launches == 0,
          f"[{tag}] mode {server.sc.mode}, flash launches {launches}")
    timing, _, _ = serve_timing(tag, cfg, server, done, dev, card, run_s)
    with torch.inference_mode():
        for w in range(len(LM_BUCKETS)):
            wave = done[w * LM_SLOTS:(w + 1) * LM_SLOTS]
            prompts = torch.from_numpy(np.stack([r.prompt for r in wave])
                                       ).long().to(dev)
            want = lm.greedy_generate(server.params, cfg, prompts,
                                      steps=LM_NEW - 1,
                                      max_len=LM_MAX_LEN).cpu().numpy()
            check(all(np.array_equal(r.output, want[i])
                      for i, r in enumerate(wave)),
                  f"[{tag}] bucket {LM_BUCKETS[w]}: served tokens differ "
                  "from greedy_generate")
    print(f"[{tag}] the served tokens of all {len(done)} requests equal "
          f"greedy_generate's on the same bucket-length prompts", flush=True)
    del server, params, done
    free_card()

    # one full-width SSD layer in fp32: chunked against sequential
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(41)
    layer = ssm.ssm_init(cfg32, gen, device=dev)
    b, sl = SSD_SHAPE
    x = torch.randn(b, sl, cfg.d_model, device=dev, generator=gen)
    with torch.inference_mode():
        y = ssm.ssm_forward(layer, cfg32, x)
        y_seq = ssm.ssm_reference(layer, cfg32, x)
        t_chunk = time_ms(lambda: ssm.ssm_forward(layer, cfg32, x), iters=5)
        t_seq = time_ms(lambda: ssm.ssm_reference(layer, cfg32, x), iters=2)
    err = (y - y_seq).abs().max().item()
    top = y_seq.abs().max().item()
    print(f"[{tag}] one full-width SSD layer in fp32 (B {b}, S {sl}, chunk "
          f"{cfg.ssm.chunk}, {ssm.ssm_dims(cfg)[1]} heads of "
          f"{cfg.ssm.headdim}, d_state {cfg.ssm.d_state}): chunked "
          f"ssm_forward against the sequential ssm_reference, max |diff| "
          f"{err:.3e}, max |out| {top:.4g}, bound {SSD_BAR} x max |out| = "
          f"{SSD_BAR * top:.3e}; chunked {t_chunk:.3f} ms, sequential "
          f"{t_seq:.3f} ms (CUDA events); {card}", flush=True)
    check(bool(torch.isfinite(y).all()) and err <= SSD_BAR * top,
          f"[{tag}] SSD differs from the sequential oracle by {err}")
    timing.update(ssd_max_abs_err=err, ssd_bound=SSD_BAR * top,
                  ssd_ms=t_chunk, sequential_ms=t_seq)
    del layer, x, y, y_seq
    free_card()
    print(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return timing


# [serve-audio] and [serve-vlm]: the encoder-decoder and vision-prefix
# families at full width and depth on the card, bf16, the port's seeded
# init made on the card. Their serving calls are the reference's with
# stub frames or patches: `lm_prefill(enc_embeds= | prefix_embeds=)` and
# greedy `lm_decode_step`s (`Server` takes neither input). Whisper-base:
# LM_SLOTS requests of each bucket's length with AUDIO_FRAMES stub frames
# each, one wave per bucket. Phi-3-vision: LM_SLOTS requests of
# VLM_PATCHES stub patches and a bucket-256 prompt (S = 1280), one wave,
# then one text-only wave through `Server`, as the reference's server
# serves it.
AUDIO_ARCH, VLM_ARCH = "whisper-base", "phi-3-vision-4.2b"


def stub_waves(tag, cfg, params, dev, waves, max_len):
    """`waves`: [(tokens (B, S) on dev, stub kwargs of lm_prefill)]. Each
    wave runs lm_prefill and LM_NEW - 1 greedy lm_decode_steps, its tokens
    read on the host after each; a warm-up pass over the waves first, then
    every launch count set to 0 just before the timed pass. Returns
    (tokens per wave (B, LM_NEW), host seconds to each wave's first
    tokens, host seconds a decode step, launches, routes)."""
    def run(toks, kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = lm.lm_prefill(params, cfg, toks, max_len=max_len,
                                      **kw)
        tok = logits.argmax(-1)
        out = [tok.cpu()]
        t1 = time.perf_counter()
        for _ in range(LM_NEW - 1):
            logits, state = lm.lm_decode_step(params, cfg, tok, state)
            tok = logits.argmax(-1)
            out.append(tok.cpu())
        t2 = time.perf_counter()
        return torch.stack(out, 1).numpy(), t1 - t0, (t2 - t1) / (LM_NEW - 1)
    with torch.inference_mode():
        for toks, kw in waves:
            run(toks, kw)
        torch.cuda.synchronize()
        reset_launches()
        runs = [run(toks, kw) for toks, kw in waves]
        torch.cuda.synchronize()
    launches, routes = launches_now(), flash_routes_now()
    outs = [r[0] for r in runs]
    check(all(o.shape == (LM_SLOTS, LM_NEW) and o.min() >= 0
              and o.max() < cfg.vocab_size for o in outs),
          f"[{tag}] served outputs are not LM_NEW tokens of the vocabulary")
    return (outs, [r[1] for r in runs], float(np.mean([r[2] for r in runs])),
            launches, routes)


def stub_len(toks, kw):
    """Positions of a prefill: the prompt's, and the patches' before it."""
    return toks.shape[1] + (kw["prefix_embeds"].shape[1]
                            if "prefix_embeds" in kw else 0)


def stub_checks(tag, cfg, params, toks, kw, max_len, first, card):
    """The wave's prefill again: finite logits giving the served first
    tokens, and the same prefill with the plain attention in place of the
    kernel within LM_LOGIT_BAR of the largest |logit|. Returns the relative
    difference."""
    with torch.inference_mode():
        got, _ = lm.lm_prefill(params, cfg, toks, max_len=max_len, **kw)
        kernel = kops.flash_attention
        kops.flash_attention = kref.flash_attention_ref
        try:
            want, _ = lm.lm_prefill(params, cfg, toks, max_len=max_len, **kw)
        finally:
            kops.flash_attention = kernel
    check(bool(torch.isfinite(got).all())
          and got.shape == (LM_SLOTS, cfg.vocab_size),
          f"[{tag}] prefill logits not finite or misshaped")
    check(np.array_equal(got.argmax(-1).cpu().numpy(), first),
          f"[{tag}] the served first tokens differ from a rerun of the "
          "prefill")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"[{tag}] S {stub_len(toks, kw)} prefill logits, kernel vs plain "
          f"attention: max |diff| / max |logit| = {rel:.3e} (bar "
          f"{LM_LOGIT_BAR}), max |logit| {want.abs().max().item():.2f}, "
          f"argmax equal in {same} of {LM_SLOTS}; the served first tokens "
          f"equal a rerun's", flush=True)
    check(rel <= LM_LOGIT_BAR, f"[{tag}] prefill logits differ by {rel}")
    return rel


def stub_timing(tag, cfg, params, toks, kw, max_len, ttft_s, step_s,
                card):
    """Device time (torch.profiler) of a prefill and of a decode step
    against the host's unprofiled time of the same, and the idle share."""
    with torch.inference_mode():
        logits, state = lm.lm_prefill(params, cfg, toks, max_len=max_len,
                                      **kw)
        busy = {"prefill": device_busy(lambda: lm.lm_prefill(
            params, cfg, toks, max_len=max_len, **kw)),
            "decode step": device_busy(lambda: lm.lm_decode_step(
                params, cfg, logits.argmax(-1), state))}
    host_ms = {"prefill": ttft_s * 1e3, "decode step": step_s * 1e3}
    for what, (dev_ms, n, fa_ms, fa_n) in busy.items():
        print(f"[{tag}] {what} at S {stub_len(toks, kw)}: {n} device "
              f"operations, "
              f"{dev_ms:.3f} ms of device time (torch.profiler) against "
              f"{host_ms[what]:.3f} ms on the host clock unprofiled: device "
              f"idle share {1 - dev_ms / host_ms[what]:.3f}; "
              f"flash_attention: {fa_n} launches recorded, {fa_ms:.3f} ms "
              f"({fa_ms / dev_ms if dev_ms else 0.0:.3f} of the device "
              f"time); {card}", flush=True)
    return ({k: v[0] for k, v in busy.items()},
            {k: 1 - v[0] / host_ms[k] for k, v in busy.items()})


def serve_audio_phase(dev, card):
    """[serve-audio]: Whisper-base at full width and depth (6 encoder and 6
    decoder layers) on stub frames: 18 flash_attention launches a prefill
    (6 encoder, 6 decoder, 6 cross), all on the tensor-core route, and
    nothing else. Returns (flash_attention launches, timing)."""
    t_phase = time.perf_counter()
    tag = "serve-audio"
    free_card()
    base = torch.cuda.memory_allocated()
    cfg = get_config(AUDIO_ARCH)
    frames = cfg.encoder.frames
    params = lm.to_compute_dtype(card_model(tag, cfg, dev, seed=43), cfg)
    rng = np.random.default_rng(43)
    max_len = LM_BUCKETS[-1] + LM_NEW
    waves = [(torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (LM_SLOTS, b))).long().to(dev),
              {"enc_embeds": multimodal.audio_frame_embeddings(
                  cfg, LM_SLOTS, frames, seed=43 + i, device=dev)})
             for i, b in enumerate(LM_BUCKETS)]
    outs, ttft_s, step_s, launches, routes = stub_waves(
        tag, cfg, params, dev, waves, max_len)
    per = 3 * cfg.num_layers       # encoder, decoder and cross layers
    want = dict.fromkeys(COUNTERS, 0) | {
        "flash_attention": per * len(waves)}
    print(f"[{tag}] {cfg.name}: {len(waves)} waves of {LM_SLOTS} requests "
          f"(buckets {LM_BUCKETS}, {frames} stub frames each, {LM_NEW} "
          f"tokens: lm_prefill(enc_embeds=) and {LM_NEW - 1} "
          f"lm_decode_steps); launches {launches}, expected {want} ({per} a "
          f"prefill: {cfg.encoder.num_layers} encoder, {cfg.num_layers} "
          f"decoder, {cfg.num_layers} cross); flash_attention by route "
          f"{routes}", flush=True)
    check(launches == want, f"[{tag}] kernel launches {launches} != {want}")
    check(routes == {"wgmma": want["flash_attention"], "simt": 0},
          f"[{tag}] flash_attention routes {routes}: every attention should "
          "take the tensor-core route")
    toks, kw = waves[-1]
    rel = stub_checks(tag, cfg, params, toks, kw, max_len, outs[-1][:, 0],
                      card)
    timing = {"ttft_ms_by_bucket": {b: t * 1e3
                                    for b, t in zip(LM_BUCKETS, ttft_s)},
              "decode_ms_per_step": step_s * 1e3, "logit_rel_diff": rel}
    for b, ms in timing["ttft_ms_by_bucket"].items():
        print(f"[{tag}] time to first token, bucket {b} ({LM_SLOTS} slots, "
              f"the encoder over {frames} frames included; prefill start to "
              f"its first tokens on the host): {ms:.2f} ms; {card}",
              flush=True)
    with torch.inference_mode():
        enc = device_busy(lambda: lm._encode(params, cfg, kw["enc_embeds"]))
        enc_ms = time_ms(lambda: lm._encode(params, cfg, kw["enc_embeds"]),
                         iters=10)
    print(f"[{tag}] the encoder and the cross K/V ({cfg.encoder.num_layers} "
          f"layers over B {LM_SLOTS} x {frames} frames): {enc[0]:.3f} ms of "
          f"device time in {enc[1]} operations (torch.profiler), "
          f"flash_attention {enc[2]:.3f} ms in {enc[3]} launches; "
          f"{enc_ms:.3f} ms a call by CUDA events; {card}", flush=True)
    timing["encoder_device_ms"], timing["encoder_ms"] = enc[0], enc_ms
    timing["device_ms"], timing["idle_share"] = stub_timing(
        tag, cfg, params, toks, kw, max_len, ttft_s[-1], step_s, card)
    print(f"[{tag}] decode: {step_ms_line(step_s)}; {card}", flush=True)
    del params, waves, kw, toks
    phase_memory(tag, t_phase, base, timing)
    return want["flash_attention"], timing


def phase_memory(tag, t_phase, base, timing):
    """Free the phase's tensors' cache, then print its seconds and the peak
    card memory, with what earlier phases still held when it began."""
    timing["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    timing["peak_gb_of_phase"] = timing["peak_gb"] - base / 1e9
    free_card()
    print(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s; peak "
          f"card memory {timing['peak_gb']:.2f} GB, "
          f"{timing['peak_gb_of_phase']:.2f} GB above the {base / 1e9:.2f} "
          f"GB that earlier phases held when it began", flush=True)


def step_ms_line(step_s):
    return (f"{step_s * 1e3:.3f} ms per step of {LM_SLOTS} slots, "
            f"{LM_SLOTS / step_s:.1f} tokens/s")


def serve_vlm_phase(dev, card):
    """[serve-vlm]: Phi-3-vision-4.2B at full width and depth (32 layers of
    32 heads of 96) with VLM_PATCHES stub patches before a bucket-256
    prompt: 32 flash_attention launches a prefill at head dim 96, all on
    the tensor-core route; then a text-only wave through `Server`. Returns
    (flash_attention launches, timing)."""
    t_phase = time.perf_counter()
    tag = "serve-vlm"
    free_card()
    base = torch.cuda.memory_allocated()
    cfg = get_config(VLM_ARCH)
    params = lm.to_compute_dtype(card_model(tag, cfg, dev, seed=47), cfg)
    rng = np.random.default_rng(47)
    bucket = LM_BUCKETS[-1]
    max_len = bucket + cfg.num_patches + LM_NEW
    waves = [(torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (LM_SLOTS, bucket))).long().to(
                                                dev),
              {"prefix_embeds": multimodal.vision_patch_embeddings(
                  cfg, LM_SLOTS, seed=47, device=dev)})]
    outs, ttft_s, step_s, launches, routes = stub_waves(
        tag, cfg, params, dev, waves, max_len)
    want = dict.fromkeys(COUNTERS, 0) | {"flash_attention": cfg.num_layers}
    print(f"[{tag}] {cfg.name}: {LM_SLOTS} requests of {cfg.num_patches} "
          f"stub patches and a {bucket}-token prompt (S {cfg.num_patches + bucket}"
          f", max_len {max_len}; lm_prefill(prefix_embeds=) and "
          f"{LM_NEW - 1} lm_decode_steps); launches {launches}, expected "
          f"{want}; flash_attention by route {routes}", flush=True)
    check(fa.flash_route(cfg.dtype, cfg.head_dim_) == "wgmma"
          and cfg.head_dim_ == 96, f"[{tag}] head dim {cfg.head_dim_}")
    check(launches == want, f"[{tag}] kernel launches {launches} != {want}")
    check(routes == {"wgmma": cfg.num_layers, "simt": 0},
          f"[{tag}] flash_attention routes {routes}: every prefill layer "
          "should take the tensor-core route")
    toks, kw = waves[0]
    rel = stub_checks(tag, cfg, params, toks, kw, max_len, outs[0][:, 0],
                      card)
    timing = {"ttft_ms": ttft_s[0] * 1e3, "decode_ms_per_step": step_s * 1e3,
              "logit_rel_diff": rel}
    print(f"[{tag}] time to first token ({LM_SLOTS} slots, S "
          f"{toks.shape[1] + cfg.num_patches}; prefill start to its first "
          f"tokens on the host): {timing['ttft_ms']:.2f} ms; {card}",
          flush=True)
    timing["device_ms"], timing["idle_share"] = stub_timing(
        tag, cfg, params, toks, kw, max_len, ttft_s[0], step_s, card)
    print(f"[{tag}] decode: {step_ms_line(step_s)}; {card}", flush=True)
    del waves, kw, toks

    # the text backbone through Server, without patches, as the
    # reference's server serves this config
    sc = ServeConfig(buckets=LM_BUCKETS, max_len=LM_MAX_LEN,
                     batch_slots=LM_SLOTS)
    prompts = [rng.integers(0, cfg.vocab_size, bucket).astype(np.int32)
               for _ in range(LM_SLOTS)]
    server = Server(cfg, sc, params=params, device=dev)
    for p in prompts:
        server.submit(p, max_new_tokens=LM_NEW)
    torch.cuda.synchronize()
    reset_launches()
    done = server.run()
    torch.cuda.synchronize()
    launches, s = launches_now(), server.summary()
    print(f"[{tag}] text-only wave through Server: launches {launches}; "
          f"summary " + json.dumps(s) + f"; time to first token "
          f"{server.metrics['ttft_s'][0][1] * 1e3:.2f} ms, decode "
          f"{server.metrics['decode_s'] / s['decode_steps'] * 1e3:.3f} ms a "
          f"step; {card}", flush=True)
    check(launches == dict.fromkeys(COUNTERS, 0) | {
        "flash_attention": cfg.num_layers}
          and s["prefills"] == 1 and s["requests"] == LM_SLOTS
          and s["tokens_out"] == LM_SLOTS * LM_NEW
          and s["decode_steps"] == LM_NEW - 1
          and all(r.output.shape == (LM_NEW,) for r in done),
          f"[{tag}] Server wave: launches {launches}, counters {s}")
    timing["server_summary"] = s
    del server, params, done
    phase_memory(tag, t_phase, base, timing)
    return want["flash_attention"] + cfg.num_layers, timing


# [serve-dense]: the three dense archs the earlier phases do not serve, at
# full width and depth, bf16 weights drawn on the card (qwen3-4b 8.0 GB,
# chatglm3-6b 12.5 GB, gemma2-27b 54.4 GB); then gemma2-27b's long wave:
# one slot, one prompt of LONG_S tokens in one bucket, LONG_NEW tokens, so
# its 23 local layers mask the keys more than 4096 positions back, in the
# kernel (prefill) and in the plain decode. The long wave's prefill is held
# against the plain attention layer by layer (`nn/layerwise.py`): the
# plain attention's float32 scores at S 4608 (about 10 GB a call) beside
# the 54.4 GB of weights and the 8.8 GB earlier phases hold leave no room
# for a whole-model plain prefill with its cache.
# [serve-scout]: Llama-4-Scout at full width, SCOUT_LAYERS of its 48
# layers (each about 2.2 B parameters, 4.4 GB in bf16; with the untied
# embedding and head about 57 GB), through [serve-moe]'s phase.
DENSE_ARCHS = ("qwen3-4b", "chatglm3-6b", "gemma2-27b")
LONG_ARCH, LONG_S, LONG_NEW = "gemma2-27b", 4608, 4
SCOUT_ARCH, SCOUT_LAYERS = "llama4-scout-17b-a16e", 12
# the port's versions of the reference's serving examples, each run once on
# the card in a subprocess with --device cuda, all four at once
EXAMPLES = ("serve_llm", "dynamic_graph_serving", "sparse_serving",
            "async_pipeline")
EXAMPLE_TIMEOUT_S = 300


def attention_layers(cfg):
    """flash_attention calls a prefill makes: one per attention layer."""
    return cfg.num_superblocks * sum(k.startswith("attn")
                                     for k in cfg.superblock)


def plain_logit_check(tag, cfg, params, toks, max_len):
    """A prefill of `toks` with the kernel against one with the plain
    attention, both in the compute dtype: the largest difference relative
    to the largest |logit|, held to LM_LOGIT_BAR. A model with a final
    softcap (gemma2: 30 tanh(x / 30), the same monotone map on both
    paths) is compared before it: the cap bounds every logit by 30, so the
    largest |logit| stops measuring the logits' scale. Beside it, printed:
    the capped logits, and the control, the float32 attention rounded once
    against the plain one."""
    raw = dataclasses.replace(cfg, final_softcap=None)
    out = {}
    kernel = kops.flash_attention
    with torch.inference_mode():
        for name, attn in (("kernel", kernel),
                           ("plain", kref.flash_attention_ref),
                           ("exact", exact_attention)):
            kops.flash_attention = attn
            try:
                out[name] = lm.lm_prefill(params, raw, toks,
                                          max_len=max_len)[0].float()
            finally:
                kops.flash_attention = kernel
    got, want = out["kernel"], out["plain"]
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          f"[{tag}] prefill logits not finite or misshaped")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    r, r_exact = rel(got, want), rel(out["exact"], want)
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    capped = ""
    if cfg.final_softcap:
        cap = cfg.final_softcap
        c_got, c_want, c_exact = (torch.tanh(t / cap) * cap
                                  for t in (got, want, out["exact"]))
        capped = (f"; after the final softcap {cap}: {rel(c_got, c_want):.3e}"
                  f" (control {rel(c_exact, c_want):.3e}), max |logit| "
                  f"{c_want.abs().max().item():.2f}")
    print(f"[{tag}] bucket-{toks.shape[1]} prefill logits"
          f"{' before the final softcap' if cfg.final_softcap else ''}, "
          f"kernel vs plain attention: max |diff| / max |logit| = {r:.3e} "
          f"(bar {LM_LOGIT_BAR}; control, float32 attention vs plain "
          f"{r_exact:.3e}), max |logit| {want.abs().max().item():.2f}, "
          f"argmax equal in {same} of {toks.shape[0]}{capped}", flush=True)
    check(r <= LM_LOGIT_BAR, f"[{tag}] prefill logits differ by {r}")
    return r


def long_wave(tag, cfg, params, dev, card):
    """gemma2-27b's long wave (see [serve-dense]): the launches, routes and
    counters of one LONG_S-token prefill and LONG_NEW - 1 decode steps, the
    served first token against a rerun of the prefill, and the prefill
    against the plain attention layer by layer. Returns (flash_attention
    launches, timing)."""
    rng = np.random.default_rng(47)
    sc = ServeConfig(buckets=(LONG_S,), max_len=LONG_S + LONG_NEW,
                     batch_slots=1)
    prompt = rng.integers(0, cfg.vocab_size, LONG_S).astype(np.int32)
    warm = Server(cfg, sc, params=params, device=dev)
    warm.submit(rng.integers(0, cfg.vocab_size, LONG_S), max_new_tokens=2)
    warm.run()
    del warm
    server = Server(cfg, sc, params=params, device=dev)
    server.submit(prompt, max_new_tokens=LONG_NEW)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, routes = launches_now(), flash_routes_now()
    s = server.summary()
    n_attn = attention_layers(cfg)
    local = cfg.num_superblocks * sum(k == "attn_local"
                                      for k in cfg.superblock)
    want = dict.fromkeys(COUNTERS, 0) | {"flash_attention": n_attn}
    print(f"[{tag}] long wave: 1 prompt of {LONG_S} tokens (bucket "
          f"{LONG_S}, max_len {sc.max_len}), {LONG_NEW} tokens; {local} "
          f"local layers with window {cfg.local_window} < {LONG_S}, so they "
          f"mask the keys more than {cfg.local_window} back; launches "
          f"{launches}, expected {want}; flash_attention by route {routes}; "
          f"summary " + json.dumps(s), flush=True)
    check(local > 0 and cfg.local_window < LONG_S,
          f"[{tag}] the long wave reaches no local window")
    check(launches == want, f"[{tag}] long wave launches {launches} != "
          f"{want}")
    check(routes == {"wgmma": n_attn, "simt": 0},
          f"[{tag}] long wave routes {routes}: every prefill layer should "
          "take the tensor-core route")
    check(s["prefills"] == 1 and s["compiled_blobs"] <= 2
          and s["tokens_out"] == LONG_NEW
          and s["decode_steps"] == LONG_NEW - 1,
          f"[{tag}] long wave counters {s}")
    out = done[0].output
    check(out.shape == (LONG_NEW,) and out.min() >= 0
          and out.max() < cfg.vocab_size,
          f"[{tag}] long wave output {out} is not {LONG_NEW} tokens")
    ttft_ms = server.metrics["ttft_s"][0][1] * 1e3
    step_ms = server.metrics["decode_s"] / s["decode_steps"] * 1e3
    sp = server.params
    del server, done
    toks = torch.from_numpy(prompt[None]).long().to(dev)
    with torch.inference_mode():
        got, _ = lm.lm_prefill(sp, cfg, toks, max_len=sc.max_len)
        check(bool(torch.isfinite(got).all())
              and int(got.argmax(-1)[0]) == int(out[0]),
              f"[{tag}] the long wave's first token differs from a rerun "
              "of its prefill")
        del got
        dev_ms, n_ops, fa_ms, fa_n = device_busy(
            lambda: lm.lm_prefill(sp, cfg, toks, max_len=sc.max_len))
    print(f"[{tag}] long wave: time to first token {ttft_ms:.2f} ms (wave "
          f"start to its first token on the host), decode {step_ms:.3f} ms "
          f"a step of 1 slot over {LONG_S}+ cached positions; the prefill "
          f"{dev_ms:.3f} ms of device time in {n_ops} operations "
          f"(torch.profiler), idle share {1 - dev_ms / ttft_ms:.3f}, "
          f"flash_attention {fa_n} launches, {fa_ms:.3f} ms "
          f"({fa_ms / dev_ms if dev_ms else 0.0:.3f} of it); run "
          f"{run_s:.3f} s; {card}",
          flush=True)
    # the prefill against the plain attention, layer by layer on the same
    # input (see [serve-dense] for why not the whole model), on the drawn
    # bf16 weights: the server's copy adds only the float32 head (4.7 GB)
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    diffs = compare_attention_paths(params, cfg, toks)
    worst = max(diffs, key=lambda d: d.mixer_diff / d.mixer_max)
    for d in diffs:
        check(d.mixer_diff <= LM_LOGIT_BAR * d.mixer_max
              and d.max_abs_diff <= LM_LOGIT_BAR * d.max_abs_out,
              f"[{tag}] long wave layer {d.layer} ({d.kind}): kernel and "
              f"plain attention paths differ: {d}")
    rel_out = max(d.max_abs_diff / d.max_abs_out for d in diffs)
    print(f"[{tag}] long wave prefill, kernel vs plain attention layer by "
          f"layer (nn/layerwise.py, {len(diffs)} layers on the same input "
          f"each): x + attention max |diff| at most {worst.mixer_diff:.4g} "
          f"of {worst.mixer_max:.4g} "
          f"({worst.mixer_diff / worst.mixer_max:.3e}, layer {worst.layer}, "
          f"{worst.kind}); layer outputs at most "
          f"{rel_out:.3e} of their max (bar {LM_LOGIT_BAR} each)",
          flush=True)
    return n_attn, {"ttft_ms": ttft_ms, "decode_ms_per_step": step_ms,
                    "prefill_device_ms": dev_ms,
                    "idle_share": 1 - dev_ms / ttft_ms,
                    "mixer_rel_max": worst.mixer_diff / worst.mixer_max,
                    "output_rel_max": rel_out}


def serve_dense_phase(dev, card):
    """[serve-dense]: qwen3-4b, chatglm3-6b and gemma2-27b at full width and
    depth, served as [serve-moe] serves OLMoE (buckets 64/128/256, 4 slots,
    12 requests after a warm-up wave per bucket): launches, routes and
    counters (`serve_waves`), times and idle shares (`serve_timing`), the
    last wave's prefill logits against the plain attention; then
    gemma2-27b's long wave. Returns (flash_attention launches, timings)."""
    launches, timings = 0, {}
    for arch in DENSE_ARCHS:
        t_phase = time.perf_counter()
        free_card()
        base = torch.cuda.memory_allocated()
        tag = f"serve-dense {arch}"
        cfg = get_config(arch)
        rng = np.random.default_rng(37)
        params = card_model(tag, cfg, dev, seed=37)
        server, done, n, run_s = serve_waves(
            tag, cfg, params, dev, lm_prompts(rng, cfg.vocab_size), rng)
        timing, toks, _ = serve_timing(tag, cfg, server, done, dev, card,
                                       run_s)
        timing["logit_rel_diff"] = plain_logit_check(tag, cfg, server.params,
                                                     toks, LM_MAX_LEN)
        launches += n
        del server, done, toks
        if arch == LONG_ARCH:
            n_long, timing["long_wave"] = long_wave(tag, cfg, params, dev,
                                                    card)
            launches += n_long
        del params
        phase_memory(tag, t_phase, base, timing)
        timings[arch] = timing
    return launches, timings


def examples_phase(card):
    """[examples]: the port's serving examples, each once on the card in a
    subprocess with --device cuda, all started together; fails if any
    exits non-zero or outlives EXAMPLE_TIMEOUT_S."""
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    try:
        for name in EXAMPLES:
            procs[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.examples.{name}",
                 "--device", "cuda"], cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for name, (t0, proc) in procs.items():
            log, _ = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            tail = "\n    ".join(log.strip().splitlines()[-4:])
            print(f"[examples] repro_torch.examples.{name} --device cuda: "
                  f"exit {proc.returncode} after "
                  f"{time.perf_counter() - t0:.1f} s; last lines:\n    "
                  f"{tail}", flush=True)
            check(proc.returncode == 0, f"[examples] {name} exited "
                  f"{proc.returncode}:\n{log[-4000:]}")
    finally:                            # no example outlives the script
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    print(f"[examples] phase took {time.perf_counter() - t_phase:.1f} s "
          f"({len(EXAMPLES)} scripts at once); {card}", flush=True)


def flash_simt(q, k, v, out, causal=True, window=None, softcap=None):
    """One call of the SIMT flash_attention library, launched directly and
    counted nowhere: the kernel that served bf16 at head dim 64 and 128
    before the tensor-core route, timed beside it."""
    b, sq, h, d = q.shape
    launch("flash_attention", _build.load("flash_attention"), q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
           k.shape[1], h, k.shape[2], d, int(q.dtype == torch.bfloat16),
           int(causal), window or 0, 0, d ** -0.5, softcap or 0.0)


def host_us(fn, calls=100, spin_ms=50.0):
    """Host microseconds per call of `fn` while a spin holds the stream, so
    that no call waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(spin_ms * 2e6))     # about spin_ms at 2 GHz
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def flash_row(dev, launches, worst, card):
    """The kernels-line row of flash_attention: times of the tensor-core
    route (bf16) at each FLASH_TIMED shape, by CUDA events and queued
    behind a spin, beside the SIMT kernel that served them before, timed
    on the same inputs, and beside scaled_dot_product_attention; the row's
    own numbers are the first (serving) shape's."""
    rng = np.random.default_rng(29)
    out = {}
    for label, shape in FLASH_TIMED.items():
        causal = shape[6]
        window, cap = (tuple(shape[7:]) + (None, None))[:2]
        opts = dict(causal=causal, window=window, softcap=cap)
        q, k, v = flash_inputs(rng, shape, torch.bfloat16, dev)
        check(fa.flash_route(q.dtype, q.shape[-1]) == "wgmma",
              f"{label} does not take the tensor-core route")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        got = fa.flash_attention(q, k, v, **opts)
        simt_out = torch.empty_like(q)
        flash_simt(q, k, v, simt_out, causal, window, cap)
        torch.testing.assert_close(simt_out.float(), got.float(),
                                   **FLASH_TOL[torch.bfloat16])
        t_k = time_ms(lambda: fa.flash_attention(q, k, v, **opts))
        t_s = time_ms(lambda: flash_simt(q, k, v, simt_out, causal, window,
                                         cap), iters=10)
        t_p = time_ms(lambda: kref.flash_attention_ref(q, k, v, **opts),
                      iters=5)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        # no one PyTorch call computes gemma2's attention
        no_library = (None if cap is None and window is None else
                      "scaled_dot_product_attention takes no tanh softcap "
                      "or sliding window")
        t_l = None if no_library else time_ms(sdpa)
        d_k = queued_ms(lambda: fa.flash_attention(q, k, v, **opts))
        d_l = None if no_library else queued_ms(sdpa)
        d_s = queued_ms(lambda: flash_simt(q, k, v, simt_out, causal,
                                           window, cap), iters=10)
        flops, nbytes_ = flash_work(q, k, causal, window)
        b_ms, b_by = bound(flops, nbytes_, BF16_FLOPS_PER_S)
        lib = (f"not timed: {no_library}" if no_library else
               f"{t_l:.4f} ms")
        print(f"[time] flash_attention {label}, tensor-core route: kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, library "
              f"(scaled_dot_product_attention) {lib}, bound "
              f"{b_ms:.4f} ms ({b_by}); {flops / t_k / 1e9:.1f} TFLOP/s; "
              f"the SIMT kernel it replaced, on the same inputs {t_s:.4f} "
              f"ms; {card}", flush=True)
        print(f"[time] flash_attention {label}, queued behind a spin so "
              f"that no launch gap counts: kernel {ms_or_not(d_k)}, library "
              f"{'not timed' if no_library else ms_or_not(d_l)}, the SIMT "
              f"kernel {ms_or_not(d_s)}; the event times above are "
              f"launch-bound where they exceed these; {card}", flush=True)
        out[label] = {"shape": label, "ms": t_k, "device_ms": d_k,
                      "plain_ms": t_p, "library_ms": t_l,
                      "library_device_ms": d_l, "no_library": no_library,
                      "bound_ms": b_ms,
                      "bound_by": b_by, "tflops": flops / t_k / 1e9,
                      "tflops_queued": (None if d_k is None
                                        else flops / d_k / 1e9),
                      "simt_ms": t_s, "simt_device_ms": d_s}
        if label == next(iter(FLASH_TIMED)):
            # the host's cost of a call: the wrapper, and each library's
            # bare launch; the tensor-core launch encodes three TMA maps
            tc_fn = _build.load("flash_attention_tc")
            d = q.shape[-1]
            host = {
                "wrapper": host_us(lambda: fa.flash_attention(q, k, v)),
                "tensor-core launch": host_us(lambda: launch(
                    "flash_attention", tc_fn, q.device, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), got.data_ptr(), q.shape[0],
                    q.shape[1], k.shape[1], q.shape[2], k.shape[2], d, 1, 0,
                    0, d ** -0.5, 0.0)),
                "SIMT launch": host_us(lambda: flash_simt(q, k, v,
                                                          simt_out))}
            enc = host["tensor-core launch"] - host["SIMT launch"]
            print(f"[time] flash_attention {label}, host us per call while "
                  f"a spin holds the stream: " + ", ".join(
                      f"{k_} {v_:.2f}" for k_, v_ in host.items())
                  + f"; the tensor-core launch's excess over the SIMT one "
                  f"(its three TMA tensor maps) {enc:.2f} us, "
                  f"{enc * LM_LAYERS_SMOLLM:.1f} us per SmolLM prefill of "
                  f"{LM_LAYERS_SMOLLM} calls", flush=True)
            out[label]["host_us"] = host
    shapes = dict(zip(FLASH_TIMED_KEYS, out.values()))
    serve = shapes["serving"]
    src, replaces = SOURCES["flash_attention"]
    return {"name": "flash_attention", "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(worst.values()), "ms": serve["ms"],
            "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
            "bound_by": serve["bound_by"], "library_ms": serve["library_ms"],
            "per": "one causal bf16 prefill call at " + next(iter(FLASH_TIMED)),
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(is_causal, enable_gqa), a yardstick only",
            "kernel_routes": {
                "wgmma": "bf16 at head dim 64, 96 (on the 128 tiles), 128: "
                         "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                "simt": "fp32, and bf16 at head dim 32: "
                        "src/repro_torch/kernels/csrc/flash_attention.cu"},
            "max_abs_err_by_route": worst,
            "device_ms": serve["device_ms"],
            "library_device_ms": serve["library_device_ms"], **shapes}


def host_ms(fn, reps=5):
    """Median host wall-clock ms of `fn` over `reps` calls after one."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def copy_ms(src, dst, reps=20):
    """Device ms of one host->device copy of `src` into `dst` (CUDA
    events around `reps` copies queued back to back)."""
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# the host pieces of a burst's intake, timed where they are called: name,
# owner, attribute (the materializer's time holds its staging and upload)
INTAKE_PIECES = (("pad_graph", BucketLadder, "pad"),
                 ("host operands", GraphServe, "_host_operands"),
                 ("materializer", gmodels.OperandMaterializer, "__call__"),
                 ("staging and upload", gmodels.CompactOperands, "to"),
                 ("GraSp counts read", GraphServe, "_derive_grasp"),
                 ("block_stats", gserver, "block_stats"))


class TimedPieces:
    """Within the block, each (name, owner, attribute) of `pieces` adds
    the seconds of its calls, from any thread, to `self.seconds`."""

    def __init__(self, pieces):
        self.seconds = Counter()
        self._lock = threading.Lock()
        self._pieces = [(name, owner, attr, getattr(owner, attr))
                        for name, owner, attr in pieces]

    def __enter__(self):
        for name, owner, attr, fn in self._pieces:
            def call(*args, _fn=fn, _name=name, **kwargs):
                t1 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    dt = time.perf_counter() - t1
                    with self._lock:
                        self.seconds[_name] += dt
            setattr(owner, attr, call)
        return self

    def __exit__(self, *exc):
        for _, owner, attr, fn in self._pieces:
            setattr(owner, attr, fn)
def gcn_burst(eng, graphs, attached):
    """The [serve] fp32 burst: each graph to `gcn` and `gcn_mm`, then one
    attached graph queried twice. Returns the host intake seconds, with
    this process's CPU seconds and the host pieces' seconds over it, and
    the burst's operand bytes, device busy seconds and p50/p99 ms."""
    m0 = {k: eng.metrics[k] for k in ("operand_bytes_h2d", "device_busy_s")}
    n0 = len(eng.finished)
    gc.collect()                    # each burst starts from a collected heap
    by_bucket = Counter()           # host ms of the one-shot submits
    with TimedPieces(INTAKE_PIECES) as timed:
        cpu0 = os.times()
        t0 = time.perf_counter()
        for model in ("gcn", "gcn_mm"):
            for g in graphs:
                t1 = time.perf_counter()
                eng.submit(g, model=model)
                by_bucket[eng.queue[-1].bucket] += time.perf_counter() - t1
        gid = eng.attach(attached, model="gcn")
        eng.query(gid)
        eng.query(gid)
        intake_s = time.perf_counter() - t0
        cpu1 = os.times()
    pieces = timed.seconds
    done = eng.run()[n0:]
    eng.detach(gid)
    lat = np.asarray([r.finished_s - r.submitted_s for r in done]) * 1e3
    check(len(done) == 2 * len(graphs) + 2 and all(
        np.isfinite(r.logits).all() for r in done),
        "a burst request did not finish with finite logits")
    return {"intake_s": intake_s,
            **{f"submits_s_{b}": v for b, v in sorted(by_bucket.items())},
            "intake_cpu_user_s": cpu1.user - cpu0.user,
            "intake_cpu_sys_s": cpu1.system - cpu0.system,
            "intake_pieces_s": dict(pieces),
            "operand_bytes_h2d": eng.metrics["operand_bytes_h2d"]
            - m0["operand_bytes_h2d"],
            "device_busy_s": eng.metrics["device_busy_s"]
            - m0["device_busy_s"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def intake_phase(dev, card, cfg, params, cora, others):
    """[intake]: each host piece of one request's intake at both buckets,
    the host link's pinned and pageable rates, and the [serve] fp32 GCN
    burst with the eager upload and with CacheG, three runs each, on the
    idle host and beside one busy process per core."""
    ladder = BucketLadder(buckets=LADDER)
    mat = build_materializer(dev)
    for cap, g in ((1024, others[2]), (3072, cora)):
        pg = ladder.pad(g)
        check(pg.capacity == cap, f"{g.num_nodes} nodes padded to "
              f"{pg.capacity}, not {cap}")
        keys = adjacency_keys(g.edge_index, cap)
        co = compact_operands(pg, cfg, keys=keys)
        co_dev = co.to(dev)
        mat(co)                               # warm this structure
        # GraphServe reads the edge list (the keys); the dense-matrix
        # versions give the same products, timed beside them
        t = {"pad_graph": host_ms(lambda: ladder.pad(g), reps=3),
             "edge keys": host_ms(lambda: adjacency_keys(g.edge_index, cap)),
             "symmetry check (keys)": host_ms(lambda: keys_symmetric(keys,
                                                                     cap)),
             "SymG pack (keys)": host_ms(lambda: symg_pack_keys(keys, cap)),
             "degree (keys)": host_ms(lambda: gcn_degree(pg.adj,
                                                         pg.num_nodes, keys)),
             "symmetry check (dense)": host_ms(lambda: is_symmetric_adjacency(
                 pg.adj)),
             "SymG pack (dense)": host_ms(lambda: symg_pack_adjacency_bits(
                 pg.adj, check=False)),
             "degree (dense)": host_ms(lambda: gcn_degree(pg.adj,
                                                          pg.num_nodes)),
             "compact upload (pageable)": host_ms(
                 lambda: (co.to(dev), torch.cuda.synchronize())),
             "materialize (device, CUDA events)": time_ms(
                 lambda: materialize_operands(co_dev)),
             "materialize (host, launch to done)": host_ms(
                 lambda: (mat(co), torch.cuda.synchronize())),
             "eager upload of A (pageable)": host_ms(
                 lambda: (torch.from_numpy(pg.norm_adj).to(dev),
                          torch.cuda.synchronize()))}
        print(f"[intake] bucket {cap} ({g.num_nodes} nodes): compact "
              f"{co.nbytes} bytes, eager A {pg.norm_adj.nbytes} bytes; ms a "
              f"request: " + json.dumps(t) + f" ({card})", flush=True)
    # the host link: a 37.7 MB copy and a 4-byte one, pinned and pageable
    rates = {}
    for label, nbytes in (("A at 3072", CAP * CAP * 4), ("4 bytes", 4),
                          ("compact at 3072", compact_bytes(CAP))):
        src = torch.zeros(nbytes, dtype=torch.uint8)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        rates[label] = {"pageable_ms": copy_ms(src, dst),
                        "pinned_ms": copy_ms(src.pin_memory(), dst)}
    big, small = rates["A at 3072"], rates["4 bytes"]
    link = {kind: CAP * CAP * 4 / ((big[kind] - small[kind]) * 1e-3)
            for kind in ("pinned_ms", "pageable_ms")}
    print(f"[intake] host->device copies (CUDA events): "
          + json.dumps(rates) + f"; rates pinned {link['pinned_ms']:.4e} "
          f"B/s, pageable {link['pageable_ms']:.4e} B/s; for "
          f"core/costs.py: HOST_LINK_BYTES_PER_S {link['pinned_ms']:.4e}, "
          f"LAUNCH_LATENCY_S {small['pinned_ms'] * 1e-3:.4e} (pinned; "
          f"in use {costs.HOST_LINK_BYTES_PER_S:.4e}, "
          f"{costs.LAUNCH_LATENCY_S:.4e}); "
          f"transfer_cost(compact at 3072) "
          f"{costs.transfer_cost(compact_bytes(CAP)) * 1e3:.4f} ms modelled "
          f"against {rates['compact at 3072']['pinned_ms']:.4f} ms measured "
          f"pinned ({card})", flush=True)

    # the [serve] fp32 burst, eager and CacheG alternating E C C E E C
    base = dict(stagr=True, grad_dynamic=True, graphsplit=True)
    engines = {}
    for mode in (False, True):
        eng = GraphServe(GraphServeConfig(ladder=ladder, batch_slots=SLOTS,
                                          return_logits=True,
                                          use_cacheg=mode), seed=0,
                         device=dev)
        eng.register_model("gcn", cfg, params, fusion="layer")
        eng.register_model("gcn_mm", cfg, params, techniques=Techniques(
            **base, use_pallas=True))
        eng.warmup()
        engines[mode] = eng
    # one request's intake past NodePad on each path: the host's ms, and
    # the ms until its operands are on the card
    for cap, g in ((1024, others[2]), (3072, cora)):
        pg = ladder.pad(g)
        row = {}
        for mode, label in ((False, "eager"), (True, "CacheG")):
            eng = engines[mode]

            def prepare():
                return eng._prepare("gcn", pg, "fp32",
                                    keys=eng._keys_for(g.edge_index, pg))
            row[label] = host_ms(prepare)
            row[f"{label} to the card"] = host_ms(
                lambda: (prepare(), torch.cuda.synchronize()))
        print(f"[intake] bucket {cap}: ms of one request's intake after "
              f"pad_graph " + json.dumps(row) + f" ({card})", flush=True)
    graphs = [cora] + list(others)
    attached = planetoid_like(num_nodes=900, num_edges=1800, num_feats=1433,
                              num_classes=7, seed=11)
    runs = {False: [], True: []}
    for mode in (False, True):      # warm each path's allocators, untimed
        gcn_burst(engines[mode], graphs, attached)
    for mode in (False, True, True, False, False, True):
        runs[mode].append(gcn_burst(engines[mode], graphs, attached))
    want_h2d = {True: 2 * sum(compact_bytes(ladder.bucket_for(g.num_nodes))
                              for g in graphs) + compact_bytes(1024),
                False: 2 * sum(4 * ladder.bucket_for(g.num_nodes) ** 2
                               for g in graphs) + 4 * 1024 ** 2}
    for mode, label in ((False, "eager"), (True, "CacheG")):
        print(f"[intake] GCN fp32 burst ({2 * len(graphs) + 2} requests), "
              f"{label}: " + json.dumps(runs[mode]) + f" ({card})",
              flush=True)
        check(all(r["operand_bytes_h2d"] == want_h2d[mode]
                  for r in runs[mode]),
              f"{label} burst moved {[r['operand_bytes_h2d'] for r in runs[mode]]}"
              f" operand bytes, expected {want_h2d[mode]}")
        engines[mode].assert_warm()
    cg = [r["intake_s"] for r in runs[True]]
    eager = [r["intake_s"] for r in runs[False]]
    print(f"[intake] intake_s median CacheG {np.median(cg):.4f} s (runs "
          f"{cg}), eager {np.median(eager):.4f} s (runs {eager}); operand "
          f"bytes {want_h2d[True]} against {want_h2d[False]} "
          f"({want_h2d[False] / want_h2d[True]:.1f}x fewer)", flush=True)
    # the same bursts beside one busy-looping process per core, as other
    # tenants load a shared host, and CacheG also with the staging copy
    # it had before `pinned_copy` (`Tensor.pin_memory`, which splits the
    # copy over the intra-op thread pool); printed, not checked
    busy = {"eager": [], "CacheG": [], "CacheG, pin_memory staging": []}
    own_copy = gmodels.pinned_copy
    hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(len(os.sched_getaffinity(0)))]
    try:
        time.sleep(1.0)
        for label in ("eager", "CacheG", "CacheG, pin_memory staging") * 3:
            gmodels.pinned_copy = (torch.Tensor.pin_memory
                                   if label.endswith("staging") else own_copy)
            busy[label].append(gcn_burst(engines[label != "eager"], graphs,
                                         attached))
    finally:
        gmodels.pinned_copy = own_copy
        for p in hogs:
            p.kill()
        for p in hogs:
            p.wait()
    print(f"[intake] beside {len(hogs)} busy processes, intake_s median "
          + "; ".join(f"{k} {np.median([r['intake_s'] for r in v]):.4f} s "
                      f"(runs {[r['intake_s'] for r in v]})"
                      for k, v in busy.items()) + f" ({card})", flush=True)
    print(f"[intake] beside {len(hogs)} busy processes, the bursts: "
          + json.dumps(busy), flush=True)
    check(min(cg) <= max(eager), f"CacheG intake {cg} is above the eager "
          f"path's {eager} beyond the spread of the runs")


def cacheg_phase(dev, card, cfgs, params, cora, others):
    """[cacheg]: the card's materialized operands against the host's for
    GCN, GAT and SAGE at both buckets; then five attached cap-3072 GCN
    graphs churned under a budget that holds two."""
    mat = build_materializer(dev)
    for cap, g in ((1024, others[2]), (3072, cora)):
        pg = pad_graph(g, capacity=cap)
        for kind, kcfg in cfgs.items():
            got = mat(compact_operands(pg, kcfg))
            host = build_operands(pg, kcfg, device=dev)
            for f in ("norm_adj", "mask_mult", "bias_add", "sample_mask",
                      "mean_mask"):
                w = getattr(host, f)
                if w is None:
                    check(getattr(got, f) is None, f"{kind}: {f} was built")
                    continue
                d = (getattr(got, f) - w).abs().max().item()
                exact = torch.equal(getattr(got, f), w)
                print(f"[cacheg] {kind} {f} at {cap}: max_abs_err {d:.3e} "
                      f"against the host's, bit-equal {exact}", flush=True)
                check(exact if f != "norm_adj" else d <= 1e-6,
                      f"{kind} {f} at {cap}: the card's materialized operand "
                      f"differs from the host's by {d}")
    entry = estimate_dense_entry_bytes(1, CAP)
    budget = 2 * entry + entry // 2
    eng = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=LADDER),
                                      batch_slots=SLOTS, return_logits=True,
                                      device_cache_budget_bytes=budget),
                     seed=0, device=dev)
    eng.register_model("gcn", cfgs["gcn"], params, fusion="layer")
    eng.warmup(buckets=(CAP,))
    cm = eng._cache

    def invariants(step):
        check(sum(cm.entry_sizes().values()) == cm.resident_bytes
              <= budget and cm.evictions == cm.spilled + cm.dropped,
              f"{step}: resident {cm.resident_bytes} of budget {budget}, "
              f"evictions {cm.evictions}, spilled {cm.spilled}, dropped "
              f"{cm.dropped}")

    first, t_first = {}, {}
    for i, n in enumerate((1800, 2100, 2400, 2700, 3000)):
        gid = eng.attach(planetoid_like(num_nodes=n, num_edges=2 * n,
                                        num_feats=1433, num_classes=7,
                                        seed=40 + i), model="gcn")
        t0 = time.perf_counter()
        eng.query(gid)
        t_first[gid] = time.perf_counter() - t0
        first[gid] = eng.run()[-1].logits
        invariants(f"attach {gid}")
    h2d0 = eng.metrics["operand_bytes_h2d"]
    spills = {k[1][0]: v for k, v in cm._spill.items()}
    check(len(spills) >= 3 and all(
        ho.compact.packed.is_pinned() and ho.compact.degree.is_pinned()
        for ho in spills.values()),
        f"{len(spills)} spilled forms, or one not in pinned memory")
    t_fault = {}
    for gid in first:
        t0 = time.perf_counter()
        eng.query(gid)
        t_fault[gid] = time.perf_counter() - t0
        got = eng.run()[-1].logits
        check(np.array_equal(got, first[gid]),
              f"graph {gid}: the answer after a spill fault differs from "
              f"its first answer")
        invariants(f"re-query {gid}")
    s = eng.summary()
    faults = s["cache_spill_hits"]
    check(faults >= 3 and s["operand_cache_misses"] == 5,
          f"{faults} spill faults and {s['operand_cache_misses']} misses")
    check(eng.metrics["operand_bytes_h2d"] - h2d0
          == faults * compact_bytes(CAP),
          "a spill fault moved more than the compact bytes")
    eng.assert_warm()
    print(f"[cacheg] churn of 5 cap-3072 GCN graphs under a budget of "
          f"{budget} bytes ({entry} an entry): every step resident <= "
          f"budget, evictions == spilled + dropped, every spill fault "
          f"answered bit for bit; host ms of query() on a miss "
          f"{ {g: round(v * 1e3, 3) for g, v in t_first.items()} }, on the "
          f"re-query (a spill fault or a hit) "
          f"{ {g: round(v * 1e3, 3) for g, v in t_fault.items()} }; summary "
          + json.dumps({k: v for k, v in s.items()
                        if k.startswith(("cache_", "operand_"))})
          + f" ({card})", flush=True)


def delta_pairs(keys, cap, lo, hi, k, rng):
    """`k` absent and `k` present undirected pairs (i < j) among the nodes
    [lo, hi) of the graph whose edge keys are `keys`."""
    row, col = np.divmod(keys, cap)
    inside = (row < col) & (row >= lo) & (col < hi)
    present = np.stack([row[inside], col[inside]], axis=1)
    rm = present[rng.choice(len(present), k, replace=False)]
    have = set(keys.tolist())
    add = set()
    while len(add) < k:
        i, j = sorted(int(v) for v in rng.integers(lo, hi, 2))
        if i != j and i * cap + j not in have:
            add.add((i, j))
    return np.asarray(sorted(add), np.int64), rm


def delta_phase(dev, card, cfg, params, gcfg, gparams, cora, community):
    """[delta]: GrAd edge deltas on three attached graphs of one bucket
    (Cora to a GCN and a GAT, the clustered `community` to an auto GCN),
    each patched entry, int8 Â and answer held bit for bit to a rebuild
    and the answers to the plain forward; then the bytes and times of one
    delta beside a rebuild's."""
    eng = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=LADDER),
                                      batch_slots=SLOTS, return_logits=True),
                     seed=0, device=dev)
    eng.register_model("gcn", cfg, params, tiers=("fp32", "int8"),
                       fusion="layer")
    eng.register_model("gcn_auto", cfg, params, agg_backend="auto",
                       fusion="layer")
    eng.register_model("gat", gcfg, gparams, tiers=("fp32", "int8"),
                       fusion="layer")
    blobs = eng.warmup()
    for model in ("gcn", "gat"):
        eng.calibrate(model, cora)
    served = {"gcn": (("fp32", "layer"), ("int8", "layer")),
              "gcn_auto": (("fp32", "layer"), ("fp32", "none")),
              "gat": (("fp32", "layer"), ("int8", "layer"))}
    base = {"gcn": cora, "gcn_auto": community, "gat": cora}
    gids = {m: eng.attach(g, model=m) for m, g in base.items()}
    cap = eng.graphs[gids["gcn"]][1].capacity
    check({eng.graphs[g][1].capacity for g in gids.values()} == {cap},
          "the delta graphs are not in one bucket")
    for m, gid in gids.items():
        for tier, fusion in served[m]:
            eng.query(gid, tier=tier, fusion=fusion)
    first = eng.run()
    check({r.backend for r in first if r.model == "gcn_auto"} == {"grasp"},
          "the clustered graph did not route to GraSp")
    log = []
    execute = eng._execute_batch

    def record(batch):
        h = batch[0]
        log.append((h.model, h.tier, h.backend, h.fusion))
        execute(batch)
    eng._execute_batch = record
    mat = build_materializer(dev)
    rng = np.random.default_rng(28)
    n_checked, by_rows, held, err = 0, 0, [], 0.0
    reset_launches()                        # the delta path starts here
    t0 = time.perf_counter()
    for step in range(DELTA_STEPS):
        for m, gid in gids.items():
            e = eng.models[m]
            n = base[m].num_nodes
            # GraSp traffic keeps its flips inside one 128-node community
            lo = (step % (n // TILE)) * TILE if m == "gcn_auto" else 0
            hi = lo + TILE if m == "gcn_auto" else n
            # the GCN graph's odd deltas flip one pair each way, so its
            # int8 Â takes the row patch too (16 flips touch more rows
            # than K_r on Cora, which re-quantizes the whole matrix)
            k = 1 if m == "gcn" and step % 2 else DELTA_FLIPS
            add, rm = delta_pairs(eng._graph_keys[gid], cap, lo, hi, k, rng)
            check(eng.update_delta(gid, add_edges=add, remove_edges=rm),
                  f"{m}: a {2 * DELTA_FLIPS}-flip delta fell back")
            key = (gid, eng._graph_version[gid])
            pg = eng.graphs[gid][1]
            ops = eng._cache.get("operand", key)
            want = mat(compact_operands(pg, e.cfg,
                                        keys=eng._graph_keys[gid]))
            for f in OPERAND_FIELDS[e.cfg.kind]:
                check(torch.equal(getattr(ops, f), getattr(want, f)),
                      f"{m} delta {step}: the patched {f} differs from the "
                      f"materializer's")
            if m == "gcn":
                by_rows += eng._requant_rows(
                    np.unique(np.concatenate([add, rm])),
                    eng._graph_keys[gid], cap) is not None
                tops = eng._cache.get("tier", key)
                full = derive_tier_operands(ops.norm_adj)
                check(torch.equal(tops.agg_aq, full.agg_aq)
                      and torch.equal(tops.agg_a_scale, full.agg_a_scale),
                      f"delta {step}: the patched int8 A differs from a "
                      f"whole re-quantization")
            fresh = eng.attach(dataclasses.replace(
                base[m], edge_index=edge_index_from_adjacency(pg.adj, n)),
                model=m)
            pairs = [(eng.query(gid, tier=tier, fusion=fusion),
                      eng.query(fresh, tier=tier, fusion=fusion))
                     for tier, fusion in served[m]]
            by_uid = {r.uid: r for r in eng.run()[-2 * len(pairs):]}
            for a, b in pairs:
                r = by_uid[a]
                check(r.backend == by_uid[b].backend and np.array_equal(
                    r.logits, by_uid[b].logits),
                    f"{m} delta {step} ({r.tier}, {r.fusion}): the answer "
                    f"differs from a fresh attach of the same structure")
                held.append((r, e))
            eng.detach(fresh)
            n_checked += 1
        eng.assert_warm()
    stream_s = time.perf_counter() - t0
    launches = launches_now()
    # against the plain forward once the launches are read: the GAT int8
    # check runs the served layer 1 again
    for r, e in held:
        if e.cfg.kind == "gat":
            d = gat_plain_check(r, e, dev, cache=False)[0]
        else:
            ref = gcn_plain(r, params, dev, e.calibrations.get(r.tier)
                            if r.tier != "fp32" else None)
            got = torch.from_numpy(r.logits)
            torch.testing.assert_close(got, ref, **TOL)
            d = (got - ref).abs().max().item()
        err = max(err, d)
    n_kind = Counter(log)
    want = dict.fromkeys(COUNTERS, 0) | {
        "fused_gcn_dense": 2 * n_kind[("gcn", "fp32", "dense", "layer")],
        "fused_gcn_int8": 2 * n_kind[("gcn", "int8", "dense", "layer")],
        "fused_gcn_grasp": 2 * n_kind[("gcn_auto", "fp32", "grasp", "layer")],
        "bitmap_spmm": 2 * n_kind[("gcn_auto", "fp32", "grasp", "none")],
        "fused_gat_full": 2 * n_kind[("gat", "fp32", "dense", "layer")],
        "fused_gat_precombined": 2 * n_kind[("gat", "int8", "dense",
                                             "layer")]}
    print(f"[delta] {n_checked} deltas ({DELTA_FLIPS} adds and "
          f"{DELTA_FLIPS} removes each, 1 and 1 in the GCN graph's odd "
          f"ones; its int8 A patched by rows in {by_rows} of {DELTA_STEPS},"
          f" re-quantized whole in the rest) in {stream_s:.2f} s, "
          f"{len(log)} batches "
          f"{sorted(n_kind.items())}; launches {launches}, expected {want}",
          flush=True)
    check(launches == want, f"kernel launches {launches} != {want}")
    check(all(launches[k] > 0 for k in DELTA_KERNELS),
          f"a kernel of the delta path never launched: {launches}")
    check(0 < by_rows < DELTA_STEPS, f"the int8 A was patched by rows in "
          f"{by_rows} of {DELTA_STEPS} deltas: one of its two ways never ran")
    s = eng.summary()
    # the bytes a patched delta shipped (its spec, and the int8 rows where
    # the row set fit K_r), against a rebuild's compact upload
    shipped = s["delta_bytes_h2d"] / s["delta_updates"]
    print(f"[delta] every patched entry equal to the materializer's output "
          f"for the patched compact form, every int8 A to a whole "
          f"re-quantization, and each of {len(held)} answers to a fresh "
          f"attach, bit for bit; against the plain forward max_abs_err "
          f"{err:.3e} (rtol={TOL['rtol']} atol={TOL['atol']}; GAT int8 "
          f"layer by layer); {s['delta_updates']} deltas shipped "
          f"{s['delta_bytes_h2d']} bytes, {shipped:.1f} a delta, against "
          f"a rebuild's compact upload of {compact_bytes(cap)} bytes "
          f"({compact_bytes(cap) / shipped:.1f}x) ({card})", flush=True)
    # the fallback: a 200-pair delta is past K_t and takes update()
    gid = gids["gcn"]
    add, _ = delta_pairs(eng._graph_keys[gid], cap, 0, cora.num_nodes,
                         DELTA_FALLBACK_PAIRS, rng)
    check(eng.update_delta(gid, add_edges=add) is False,
          "a 200-pair delta did not fall back")
    s = eng.summary()
    check((s["delta_updates"], s["delta_fallbacks"])
          == (DELTA_STEPS * len(gids), 1),
          f"delta_updates {s['delta_updates']}, delta_fallbacks "
          f"{s['delta_fallbacks']}")
    eng.query(gid)
    r = eng.run()[-1]
    torch.testing.assert_close(torch.from_numpy(r.logits),
                               gcn_plain(r, params, dev), **TOL)
    eng.assert_warm()
    print(f"[delta] the {DELTA_FALLBACK_PAIRS}-pair delta fell back to "
          f"update(): delta_fallbacks {s['delta_fallbacks']}, "
          f"delta_updates {s['delta_updates']}; compiled_blobs "
          f"{s['compiled_blobs']} (warm {blobs}); summary "
          + json.dumps({k: v for k, v in s.items()
                        if k.startswith(("delta_", "operand_", "cache_"))})
          + f" ({card})", flush=True)

    # one delta on the Cora GCN graph, piece by piece, beside a rebuild of
    # the same graph
    eng.query(gid, tier="int8")                 # the tier entry, resident
    eng.run()
    pg, keys = eng.graphs[gid][1], eng._graph_keys[gid]
    n = pg.num_nodes
    add, rm = delta_pairs(keys, cap, 0, n, DELTA_FLIPS, rng)
    delta = apply_edge_delta(pg.adj, pg.norm_adj, n, add, rm)
    keys2 = patch_adjacency_keys(keys, cap, delta)
    adj2 = delta.adj
    deg2 = gcn_degree(adj2, n, keys2)
    fields = OPERAND_FIELDS["gcn"]

    def spec():
        return eng._delta_spec(cap, fields, delta.flip_i, delta.flip_j,
                               delta.flip_v, delta.touched, deg2)

    sp = spec()
    rows = eng._requant_rows(delta.touched, keys2, cap)
    key = (gid, eng._graph_version[gid])
    ops, tops = eng._cache.get("operand", key), eng._cache.get("tier", key)
    na2 = patch_operands(ops, sp).norm_adj
    host = {"symmetry check (keys)": host_ms(
                lambda: keys_symmetric(keys, cap)),
            "apply_edge_delta (dense)": host_ms(
                lambda: apply_edge_delta(pg.adj, pg.norm_adj, n, add, rm)),
            "patch edge keys": host_ms(
                lambda: patch_adjacency_keys(keys, cap, delta)),
            "degree (keys)": host_ms(lambda: gcn_degree(adj2, n, keys2)),
            "spec upload": host_ms(lambda: (spec(),
                                            torch.cuda.synchronize())),
            "int8 rows": host_ms(lambda: (
                eng._requant_rows(delta.touched, keys2, cap),
                torch.cuda.synchronize()))}

    def there_and_back():
        eng.update_delta(gid, add_edges=add, remove_edges=rm)
        eng.update_delta(gid, add_edges=rm, remove_edges=add)
        torch.cuda.synchronize()
    host["update_delta (launch to done)"] = host_ms(there_and_back) / 2
    gat_gid = gids["gat"]
    gat_ops = eng._cache.get("operand",
                             (gat_gid, eng._graph_version[gat_gid]))
    gat_sp = dataclasses.replace(sp, fields=OPERAND_FIELDS["gat"])
    device = {"patch A (GCN)": time_ms(lambda: patch_operands(ops, sp)),
              "patch masks (GAT)": time_ms(
                  lambda: patch_operands(gat_ops, gat_sp)),
              # K_r rows (the row set of this delta, or the first K_r
              # rows where it exceeds them): the patch's cost is its width
              "int8 rows (K_r)": time_ms(lambda: patch_tier_operands(
                  tops, na2, rows if rows is not None else torch.arange(
                      min(2 * eng.sc.delta_pad_rows, cap), device=dev,
                      dtype=torch.int32))),
              "whole int8 re-quantization": time_ms(
                  lambda: derive_tier_operands(na2))}
    edges = edge_index_from_adjacency(pg.adj, n)
    feats = pg.features[:n]
    rebuild_ms = host_ms(lambda: eng.update(gid, edges, n, feats), reps=3)
    co = compact_operands(eng.graphs[gid][1], cfg,
                          keys=eng._graph_keys[gid]).to(dev)
    mat(co)
    device["materializer (the next query after update())"] = time_ms(
        lambda: mat(co))
    print(f"[delta] one delta of {len(delta.flip_i)} flips, "
          f"{len(delta.touched)} touched nodes, int8 rows "
          f"{'past K_r: re-quantized whole' if rows is None else rows.numel()}"
          f" on the "
          f"cap-{cap} Cora GCN: spec {sp.nbytes} bytes"
          f"{'' if rows is None else f' + int8 rows {rows.numel() * 4}'}"
          f" against a rebuild's compact {compact_bytes(cap)} bytes; host "
          f"ms " + json.dumps(host) + "; device ms (CUDA events) "
          + json.dumps(device) + f"; update() host ms {rebuild_ms:.3f} "
          f"({card})", flush=True)
    eng.assert_warm()


# [pipeline]: the host workers of each pipelined burst (4 twice), and the
# SLO governor that must step the default tier down (its p99 target is
# below any 3072 batch's latency; it never steps back up)
PIPELINE_WORKERS = (1, 2, 4, 4)
PIPELINE_SLO = dict(target_p99_ms=1.0, window=16, min_samples=1,
                    breach_checks=2, clear_checks=10 ** 6,
                    ladder=("fp32", "int8"))
# the pieces of a request's host stage, timed where they are called (on
# whichever thread calls them): name, owner, attribute
PIPELINE_PIECES = (("pad_graph", BucketLadder, "pad"),
                   ("edge keys", GraphServe, "_keys_for"),
                   ("host operands", GraphServe, "_host_operands"),
                   ("materializer", gmodels.OperandMaterializer, "__call__"),
                   ("feature upload", GraphServe, "_upload_features"),
                   ("hand over", GraphServe, "_hand_over"),
                   ("cache publish", GraphServe, "_publish"))


def pipeline_burst(eng, graphs, attached, workers):
    """One burst of phase 3's fp32 traffic to the fused `gcn`: each graph
    submitted as it comes, then `attached` attached and queried twice;
    through the sync path (`workers` None) or a scheduler of `workers`
    host workers, drained. Latency counts from the submit call. Returns
    the requests in submission order and the burst's numbers, with the
    host-stage pieces' seconds and this process's CPU seconds."""
    m0 = {k: eng.metrics[k] for k in ("batches", "slots_filled",
                                      "slots_total", "device_busy_s")}
    gc.collect()                    # each burst starts from a collected heap
    reset_launches()
    sent = []
    pieces = TimedPieces(PIPELINE_PIECES)
    cpu0 = os.times()
    t0 = time.perf_counter()
    with pieces:
        out, host_s, gid = _pipeline_requests(eng, graphs, attached, workers,
                                              sent)
    cpu1 = os.times()
    launched = launches_now()
    eng.detach(gid)
    eng.assert_warm()
    batches = eng.metrics["batches"] - m0["batches"]
    want = dict.fromkeys(COUNTERS, 0) | {"fused_gcn_dense": 2 * batches}
    check(launched == want, f"pipeline burst ({workers} workers): launches "
          f"{launched} != {want}")
    span = max(r.finished_s for r in out) - t0
    lat = np.asarray([r.finished_s - t for r, t in zip(out, sent)]) * 1e3
    busy = eng.metrics["device_busy_s"] - m0["device_busy_s"]
    return out, {
        "requests": len(out), "span_s": span,
        "throughput_rps": len(out) / span,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "device_busy_s": busy,
        "device_idle_fraction": max(0.0, 1.0 - busy / span),
        "host_busy_s": host_s, "batches": batches,
        "batch_occupancy": ((eng.metrics["slots_filled"]
                             - m0["slots_filled"])
                            / (eng.metrics["slots_total"]
                               - m0["slots_total"])),
        "cpu_user_s": cpu1.user - cpu0.user,
        "cpu_sys_s": cpu1.system - cpu0.system,
        "host_pieces_s": dict(pieces.seconds)}


def _pipeline_requests(eng, graphs, attached, workers, sent):
    """The requests of one `pipeline_burst`, through the sync path or a
    scheduler; returns them in submission order, the host-stage seconds
    (the sync intake, or the workers' `host_busy_s`) and the attached
    graph's id."""
    t0 = time.perf_counter()
    if workers is None:
        uids = []
        for g in graphs:
            sent.append(time.perf_counter())
            uids.append(eng.submit(g, model="gcn"))
        gid = eng.attach(attached, model="gcn")
        for _ in range(2):
            sent.append(time.perf_counter())
            uids.append(eng.query(gid))
        host_s = time.perf_counter() - t0
        done = {r.uid: r for r in eng.run()}
        return [done[u] for u in uids], host_s, gid
    with eng.scheduler(PipelineConfig(host_workers=workers,
                                      window_ms=2.0)) as sched:
        for g in graphs:
            sent.append(time.perf_counter())
            sched.submit(g, model="gcn")
        gid = eng.attach(attached, model="gcn")
        for _ in range(2):
            sent.append(time.perf_counter())
            sched.query(gid)
        out = sched.drain(timeout=120)
    p = sched.metrics
    check(p["completed"] == p["accepted"] == len(graphs) + 2
          and len(out) == len(graphs) + 2,
          f"pipeline with {workers} workers: {p}")
    return out, p["host_busy_s"], gid


def pad_probe_turns():
    """[pipeline]'s thread probe: seconds (wall, user, system) of NodePad
    over the burst's graphs (cora_like and the five Planetoid-like ones),
    three times on the calling thread and three times on a new worker
    thread, in turns."""
    ladder = BucketLadder(buckets=LADDER)
    cora, others = graphs()

    def burst(out):
        c0, t0 = os.times(), time.perf_counter()
        for g in [cora] + others:
            ladder.pad(g)
        c1 = os.times()
        out.append((time.perf_counter() - t0, c1.user - c0.user,
                    c1.system - c0.system))
    res = {"main": [], "worker": []}
    for _ in range(3):
        burst(res["main"])
        t = threading.Thread(target=burst, args=(res["worker"],))
        t.start()
        t.join()
    return res


def pad_probe():
    """`pad_probe_turns` in a fresh process and in this one, after the
    phases before it."""
    run = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.pad_probe_turns()))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return {"fresh process": json.loads(run.stdout.strip().splitlines()[-1]),
            "this process": pad_probe_turns()}


def pipeline_phase(dev, card, cfg, params, cora, others):
    """[pipeline]: phase 3's fp32 burst through the sync path and the
    pipeline scheduler (host workers on their own streams), answers bit
    for bit; then deadlines, the governor, the tolerance router and the
    measured backend pair on the card."""
    t_phase = time.perf_counter()
    eng = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=LADDER),
                                      batch_slots=SLOTS, return_logits=True),
                     seed=0, device=dev)
    eng.register_model("gcn", cfg, params, fusion="layer")
    eng.warmup()
    graphs = [cora] + others
    attached = planetoid_like(num_nodes=900, num_edges=1800, num_feats=1433,
                              num_classes=7, seed=11)
    # one untimed burst through each path first, so the measured ones find
    # the allocator's pools of the dispatch and host streams warm
    for workers in (None, max(PIPELINE_WORKERS)):
        pipeline_burst(eng, graphs, attached, workers)
    sync, row = pipeline_burst(eng, graphs, attached, None)
    err = 0.0
    for r in sync:
        check(r.logits is not None and np.isfinite(r.logits).all(),
              f"request {r.uid}: logits missing or not finite")
        ref = gcn_plain(r, params, dev)
        got = torch.from_numpy(r.logits)
        torch.testing.assert_close(got, ref, **TOL)
        err = max(err, (got - ref).abs().max().item())
    print(f"[pipeline] sync burst: logits of all {len(sync)} requests match "
          f"the plain forward (max_abs_err {err:.3e}; rtol={TOL['rtol']} "
          f"atol={TOL['atol']})", flush=True)
    print("[pipeline] sync " + json.dumps(row) + f"; {card}", flush=True)
    rows = {"sync": row}
    for i, h in enumerate(PIPELINE_WORKERS):
        out, row = pipeline_burst(eng, graphs, attached, h)
        for r, w in zip(out, sync):
            check(r.logits.shape == w.logits.shape
                  and np.array_equal(r.logits, w.logits),
                  f"{h} workers: request {r.uid} differs from the sync "
                  f"burst's answer for the same graph")
        label = f"{h} workers" + (" (again)" if h in PIPELINE_WORKERS[:i]
                                  else "")
        rows[label] = row
        print(f"[pipeline] {label}: every answer bit-equal to the sync "
              f"burst's; " + json.dumps(row) + f"; {card}", flush=True)

    # deadlines, through the scheduler: expired in the ready buffer with
    # no launch, or served
    m0 = eng.metrics["deadline_misses"]
    reset_launches()
    with eng.scheduler(PipelineConfig(host_workers=2)) as sched:
        for g in graphs[:4]:
            sched.submit(g, model="gcn", deadline_ms=0.001)
        expired = sched.drain(timeout=120)
    launched = launches_now()
    check(all(r.deadline_missed and r.preds is None for r in expired)
          and eng.metrics["deadline_misses"] - m0 == 4
          and not any(launched.values()),
          f"0.001 ms deadlines: {[(r.deadline_missed, r.preds is None) for r in expired]}, "
          f"misses {eng.metrics['deadline_misses'] - m0}, launches {launched}")
    b0 = eng.metrics["batches"]
    reset_launches()
    with eng.scheduler(PipelineConfig(host_workers=2)) as sched:
        for g in graphs[:4]:
            sched.submit(g, model="gcn", deadline_ms=60000)
        served = sched.drain(timeout=120)
    launched = launches_now()
    check(all(r.preds is not None and not r.deadline_missed for r in served)
          and eng.metrics["deadline_misses"] - m0 == 4
          and launched["fused_gcn_dense"]
          == 2 * (eng.metrics["batches"] - b0),
          f"60 s deadlines: launches {launched}")
    print(f"[pipeline] deadlines: 4 requests at 0.001 ms expired unserved "
          f"(deadline_misses +4, no launch), 4 at 60000 ms served in "
          f"{eng.metrics['batches'] - b0} batches", flush=True)

    # the governor, the tolerance router and the measured backend pair
    slo = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=LADDER),
                                      batch_slots=SLOTS, return_logits=True),
                     seed=0, slo=SLOConfig(**PIPELINE_SLO), device=dev)
    slo.register_model("gcn_q", cfg, params, tiers=("fp32", "int8"),
                       fusion="layer")
    slo.register_model("gcn_auto", cfg, params, agg_backend="auto",
                       fusion="layer")
    slo.warmup()
    slo.calibrate("gcn_q", cora)
    reset_launches()
    steps = []
    for _ in range(5):
        slo.submit(cora, model="gcn_q")
        r = slo.run()[-1]
        steps.append((r.tier, slo.governor.level))
    launched = launches_now()
    p99 = slo.governor.p99_ms()
    n_i8 = sum(t == "int8" for t, _ in steps)
    check([t for t, _ in steps] == ["fp32", "fp32", "int8", "int8", "int8"]
          and launched["fused_gcn_int8"] == 2 * n_i8
          and launched["fused_gcn_dense"] == 2 * (5 - n_i8)
          and p99 > PIPELINE_SLO["target_p99_ms"],
          f"governor: steps {steps}, launches {launched}, p99 {p99}")
    s = slo.summary()
    print(f"[pipeline] governor: target p99 {PIPELINE_SLO['target_p99_ms']} "
          f"ms against a measured {p99:.3f} ms; default-tier requests served "
          f"{[t for t, _ in steps]} (levels {[lv for _, lv in steps]}); "
          f"fused_gcn_int8 launches {launched['fused_gcn_int8']}; "
          + json.dumps({k: s[k] for k in (
              "slo_level", "slo_downgrades", "slo_upgrades",
              "deadline_misses", "shed_requests", "ewma_vs_model")}),
          flush=True)
    check(s["slo_level"] == 1 and s["slo_downgrades"] == 1,
          f"governor counters {s}")

    cap = slo.sc.ladder.bucket_for(cora.num_nodes)
    tol = abs(slo.models["gcn_q"].accuracy_delta["int8"]) + 1.0
    lat = {t: min(slo.bank.measured(k) for k in slo.bank.keys()
                  if k[:3] == ("gcn_q", cap, t)
                  and slo.bank.measured(k) is not None)
           for t in ("fp32", "int8")}
    slo.submit(cora, model="gcn_q", tolerance=tol)
    r = slo.run()[-1]
    want_tier = min(("fp32", "int8"), key=lambda t: (lat[t], t != "fp32"))
    check(r.tier == want_tier, f"tolerance {tol}: served {r.tier}, measured "
          f"{lat}")
    print(f"[pipeline] tolerance {tol:.2f} points at bucket {cap}: measured "
          f"batch latency fp32 {lat['fp32'] * 1e3:.3f} ms, int8 "
          f"{lat['int8'] * 1e3:.3f} ms -> served {r.tier}; {card}",
          flush=True)

    reset_launches()
    community = [clustered(n) for n in (1800, 2700)]
    for g in [cora] + community:
        slo.submit(g, model="gcn_auto")
    first = sorted(slo.run()[-3:], key=lambda r: r.uid)
    launched = launches_now()
    check([r.backend for r in first] == ["dense", "grasp", "grasp"]
          and launched["fused_gcn_grasp"] > 0,
          f"auto GCN: {[r.backend for r in first]}, launches {launched}")
    pair = slo._measured_agg_pair("gcn_auto", cap)
    check(None not in pair, f"measured pair {pair}")
    for g in [cora] + community:
        slo.submit(g, model="gcn_auto")
    again = sorted(slo.run()[-3:], key=lambda r: r.uid)
    for label, g, r in zip(("cora", "clustered 1800", "clustered 2700"),
                           [cora] + community, again):
        st_ = block_stats(slo.sc.ladder.pad(g).norm_adj)
        args = dict(nnz_blocks=st_["nnz_blocks"],
                    max_row_nnz=st_["max_row_nnz"], mode="auto")
        measured = select_agg_backend(cap, cfg.hidden, measured=pair,
                                      **args)[0]
        modelled = select_agg_backend(cap, cfg.hidden, **args)[0]
        check(r.backend == measured, f"{label}: served {r.backend}, the "
              f"measured pair decides {measured}")
        print(f"[pipeline] auto GCN, {label} at {cap}: measured pair dense "
              f"{pair[0] * 1e3:.3f} ms, grasp {pair[1] * 1e3:.3f} ms -> "
              f"{measured} (the cost model alone: {modelled}); {card}",
              flush=True)
    slo.assert_warm()
    for label, res in pad_probe().items():
        print(f"[pipeline] NodePad of the burst's 6 graphs, {label}, "
              f"seconds (wall, user, system) on the main thread "
              f"{res['main']}, on a worker thread {res['worker']}",
              flush=True)
    print(f"[pipeline] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows


# [shard]: the sharded configurations on ladder (1024, 3072) with shard
# counts (2, 4). Clustered graphs of 128-node communities with a tenth of
# their edges across the whole graph: the Cora GCN's 10,000 nodes
# partition as 4 x 3072 (full_rows 12288), the GAT's and SAGE's 5,000 as
# 2 x 3072; the update() crossing starts from 2,000 nodes (unsharded)
SHARD_COUNTS = (2, 4)
SHARD_GCN_NODES, SHARD_NODES, SHARD_SMALL_NODES = 10000, 5000, 2000
# the kernels of the sharded path with `use_pallas`: block_matmul (#1),
# int8_matmul (#2) and the rectangular sage_max (#5)
SHARD_KERNELS = ("block_matmul", "int8_matmul", "sage_max")
# each sharded forward's launches by (kind[/aggregator], quantgr): one per
# product of the (R*S)-batched layer (GCN: X.W and the aggregation; GAT:
# X.W and one attention product a head; SAGE: the pool combine and the
# masked max (max), or the mean product, then the self and neighbour
# combines, int8 where the tier quantizes them), both layers
SHARD_LAUNCHES = {
    ("gcn", False): {"block_matmul": 4},
    ("gcn", True): {"int8_matmul": 4},
    ("gat", False): {"block_matmul": (1 + GAT_HEADS) + (1 + 1)},
    ("gat", True): {"int8_matmul": 2, "block_matmul": GAT_HEADS + 1},
    ("sage/max", False): {"block_matmul": 6, "sage_max": 2},
    ("sage/max", True): {"int8_matmul": 6, "sage_max": 2},
    ("sage/mean", False): {"block_matmul": 6},
    ("sage/mean", True): {"block_matmul": 2, "int8_matmul": 4},
}


def shard_graph(n):
    return clustered_like(num_nodes=n, num_feats=1433, num_classes=7,
                          within_density=0.05, cross_frac=0.1, seed=n)


def shard_tiers(kind):
    """The `use_pallas` tiers of a sharded model: fp32 and int8 (SAGE with
    GrAx3, so its masked max runs the sage_max kernel)."""
    std = gserver.tier_techniques(kind)
    fp32, int8 = std["fp32"], std["int8"]
    if kind == "sage":
        fp32 = dataclasses.replace(fp32, grax3=True)
        int8 = dataclasses.replace(int8, grax3=True)
    return {"fp32": dataclasses.replace(fp32, use_pallas=True),
            "int8": dataclasses.replace(int8, use_pallas=True)}


def unslot(t, part):
    """A (1?, S, C, w) slot-ordered tensor -> (full_rows, w) in node order
    (padding rows at their padded positions), on its device."""
    flat = t.reshape(part.full_rows, -1)
    out = torch.empty_like(flat)
    out[torch.from_numpy(part.perm).to(t.device)] = flat
    return out


def shard_plain(e, tier, pg, dev, cache):
    """The plain single-device forward of a padded graph at its full_rows
    on the card: host-built operands, the tier's Techniques without
    `use_pallas` (cuBLAS and the plain PyTorch ops), kept per (model,
    tier, graph)."""
    key = (id(e), tier, pg.num_nodes, pg.capacity)
    if key not in cache:
        ops = build_operands(pg, e.cfg, device=dev)
        t = dataclasses.replace(e.tiers[tier], use_pallas=False)
        x = torch.from_numpy(pg.features).to(dev)
        cache[key] = (ops, t, x, gmodels.forward_grannite(
            e.params, e.cfg, x, ops, t,
            quant=e.calibrations.get(tier) if t.quantgr else None))
    return cache[key]


def shard_check_request(r, e, dev, cache):
    """One sharded request's logits against the plain single-device
    forward at full_rows (TOL, argmax equal outside ties). A QuantGr GAT
    or SAGE request layer by layer, as PERF.md section 2 holds them: the
    served layer 1 (`sharded_layer`) against the plain layer 1, then the
    logits against the plain layer 2 over the served layer 1. Returns the
    largest error."""
    n, part, cfg = r.pg.num_nodes, r.part, e.cfg
    ops, t, x, plain = shard_plain(e, r.tier, r.pg, dev, cache)
    got = torch.from_numpy(r.logits)
    check(r.logits.shape == (n, cfg.num_classes)
          and np.isfinite(r.logits).all(),
          f"sharded request {r.uid}: logits missing, misshapen or not finite")
    if t.quantgr and cfg.kind != "gcn":
        cal = e.calibrations[r.tier]
        act = (torch.nn.functional.elu if cfg.kind == "gat"
               else torch.relu)
        h1_k = act(gmodels.sharded_layer(
            e.params, cfg, r.shard_x[None], gmodels.GranniteOperands(
                **{f: getattr(r.ops, f)[None]
                   for f in OPERAND_FIELDS[cfg.kind]}),
            r.shard_mask[None], e.tiers[r.tier], cal, layer=1,
            compress=False))
        h1_k = unslot(h1_k, part)
        if cfg.kind == "gat":
            kw = dict(heads=cfg.heads, out_feats=cfg.hidden // cfg.heads)
            h1 = act(glayers.gat_grannite(e.params["l1"], x, ops.mask_mult,
                                          ops.bias_add, t, quant=cal["l1"],
                                          **kw))
            ref = glayers.gat_grannite(e.params["l2"], h1_k, ops.mask_mult,
                                       ops.bias_add, t, heads=1,
                                       out_feats=cfg.num_classes,
                                       quant=cal["l2"])
        else:
            kw = dict(aggregator=cfg.aggregator)
            h1 = act(glayers.sage_grannite(e.params["l1"], x,
                                           ops.sample_mask, ops.mean_mask, t,
                                           quant=cal["l1"], **kw))
            ref = glayers.sage_grannite(e.params["l2"], h1_k,
                                        ops.sample_mask, ops.mean_mask, t,
                                        quant=cal["l2"], **kw)
        d1 = (h1_k - h1)[:n].abs().max().item()
        check(d1 <= TOL["atol"], f"sharded request {r.uid} ({r.model} "
              f"{r.tier}): layer 1 differs from the plain one by {d1}")
        ref = ref[:n].cpu()
    else:
        ref = plain[:n].cpu()
    d = (got - ref).abs().max().item()
    torch.testing.assert_close(got, ref, **TOL)
    top2 = ref.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= TOL["atol"]
    check(bool((torch.from_numpy(r.preds) == ref.argmax(-1))[~tie].all()),
          f"sharded request {r.uid}: argmax differs from the plain forward")
    return d


def shard_dispatch_parts(e, tier, r, dev, iters=5):
    """CUDA-event ms of one sharded dispatch of request r (a
    single-replica plan, compression off and on), and of its two halo
    exchanges alone on the layers' real inputs: the rest is the
    products."""
    cfg, part, t = e.cfg, r.part, e.tiers[tier]
    quant = e.calibrations.get(tier) if t.quantgr else None
    x, ops, mask = r.shard_x[None], gmodels.GranniteOperands(
        **{f: getattr(r.ops, f)[None] for f in OPERAND_FIELDS[cfg.kind]}), \
        r.shard_mask[None]
    # the exchanged rows of both layers, as the layers form them
    ins = []
    h = x
    for layer in (1, 2):
        if cfg.kind == "gcn":
            w = e.params[f"l{layer}"]["w"]
            ins.append(kops.matmul(h.reshape(-1, *h.shape[2:]), w)
                       .reshape(*h.shape[:3], -1))
        else:
            ins.append(h)
        if layer == 1:
            h = torch.relu(gmodels.sharded_layer(
                e.params, cfg, x, ops, mask, t, quant, layer=1,
                compress=False))
    out = {}
    for compress in (False, True):
        plan = gmodels.build_sharded_plan(cfg, part.shard_cap, part.shards,
                                          t, compress=compress, device=dev)
        out[compress] = dict(
            dispatch=time_ms(lambda: plan(e.params, r.shard_x, r.ops, quant,
                                          node_mask=r.shard_mask),
                             iters=iters),
            exchange=time_ms(lambda: [gmodels.halo_exchange(
                v, mask, compress=compress) for v in ins], iters=iters))
    return out, ins, mask


def shard_phase(dev, card, cfg, params, gcfg, gparams, scfg, sparams, cora):
    """[shard]: multi-device GraphSplit on one card (the shard axis a
    leading tensor dimension): the partitioner, the slice build, sharded
    serving of the Cora GCN (4 x 3072), GAT and SAGE (2 x 3072) against
    the plain single-device forward, the int8 wire, replica rows,
    update() across the boundary both ways, a sharded update_delta
    against a sharded rebuild, the counters, and the times. Returns the
    sharded path's launches of SHARD_KERNELS and the rectangular
    sage_max's times."""
    t_phase = time.perf_counter()
    ladder = BucketLadder(buckets=LADDER)
    cap = LADDER[-1]
    big, mid, small = (shard_graph(n) for n in (
        SHARD_GCN_NODES, SHARD_NODES, SHARD_SMALL_NODES))
    parts = {}
    for label, g in (("GCN", big), ("GAT/SAGE", mid)):
        for method in ("multilevel", "greedy"):
            t0 = time.perf_counter()
            part = partition_for_ladder(g.edge_index, g.num_nodes, ladder,
                                        SHARD_COUNTS, method=method)
            ms = (time.perf_counter() - t0) * 1e3
            parts[(label, method)] = part
            print(f"[shard] partition, {label} graph of {g.num_nodes} nodes "
                  f"and {g.edge_index.shape[1]} edges, {method}: "
                  f"{part.shards} x {part.shard_cap} (full_rows "
                  f"{part.full_rows}), {ms:.1f} host ms, cut_edges "
                  f"{part.cut_edges}, halo nodes {part.halo_nodes}, loads "
                  f"{part.loads.tolist()}", flush=True)
    check((parts[("GCN", "multilevel")].shards,
           parts[("GAT/SAGE", "multilevel")].shards) == (4, 2),
          "the sharded graphs did not partition as 4 and 2 x 3072")

    eng = GraphServe(GraphServeConfig(
        ladder=ladder, batch_slots=SLOTS, return_logits=True,
        shard_counts=SHARD_COUNTS, halo_compress=False, replica_groups=2),
        seed=0, device=dev)
    eng.register_model("gcn", cfg, params, tiers=("fp32", "int8"))
    models = {"gcn_mm": (cfg, params), "gat_mm": (gcfg, gparams),
              "sage_max_mm": (scfg["max"], sparams["max"]),
              "sage_mean_mm": (scfg["mean"], sparams["mean"])}
    for name, (c, p) in models.items():
        eng.register_model(name, c, p, tiers=shard_tiers(c.kind))
    for name in eng.models:
        eng.calibrate(name, cora)
    t0 = time.perf_counter()
    blobs = eng.warmup()
    print(f"[shard] warmup (every plan at buckets {LADDER} and shard counts "
          f"{SHARD_COUNTS}, replica_groups 2): {blobs} signatures in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    gids = {name: eng.attach(big if name.startswith("gcn") else mid,
                             model=name)
            for name in eng.models}
    for name, gid in gids.items():
        part = eng._sharded[gid][0]
        want = parts[("GCN" if name.startswith("gcn") else "GAT/SAGE",
                      "multilevel")]
        check(np.array_equal(part.perm, want.perm),
              f"{name}: attach() partitioned otherwise")

    # the slice build of the 4-shard GCN graph, by piece: the host's
    # padding, edge keys and compact form, then the card's materializer
    # and the two permuting gathers (CUDA events)
    part = eng._sharded[gids["gcn_mm"]][0]
    t0 = time.perf_counter()
    pg_big = pad_graph(big, capacity=part.full_rows)
    pad_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    keys = adjacency_keys(big.edge_index, part.full_rows)
    ho = gmodels.prepare_host_operands(pg_big, cfg, keys=keys, device=dev)
    host_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    ops_full = materialize_operands(ho.compact.to(dev))
    ev[1].record()
    perm = torch.from_numpy(part.perm).to(dev)
    blocks = ops_full.norm_adj.index_select(0, perm).index_select(1, perm)
    ev[2].record()
    ev[2].synchronize()
    print(f"[shard] slice build, GCN 4 x 3072: host pad_graph {pad_ms:.1f} "
          f"ms (its dense Â and adjacency; GraphServe pads at attach), edge "
          f"keys and compact form {host_ms:.1f} ms ({ho.nbytes} bytes); "
          f"device materializer {ev[0].elapsed_time(ev[1]):.3f} ms, "
          f"permutation {ev[1].elapsed_time(ev[2]):.3f} ms (CUDA events); "
          f"{card}", flush=True)
    del ops_full, blocks, pg_big, ho
    gc.collect()
    torch.cuda.empty_cache()

    # the sharded burst: each model and tier once, and a second fp32
    # query of each use_pallas model, so those keys dispatch two replica
    # rows at once; the counts set to 0 just before
    m0 = {k: eng.metrics[k] for k in eng.metrics if not isinstance(
        eng.metrics[k], list)}
    reset_launches()
    t0 = time.perf_counter()
    uids = []
    for name, gid in gids.items():
        for tier in ("fp32", "int8"):
            uids.append(eng.query(gid, tier=tier))
        if name != "gcn":
            uids.append(eng.query(gid, tier="fp32"))
    done = {r.uid: r for r in eng.run()}
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    launched = launches_now()
    reqs = [done[u] for u in uids]
    keys_n = Counter((r.model, r.tier) for r in reqs)
    want = dict.fromkeys(COUNTERS, 0)
    for (name, tier), n_req in keys_n.items():
        e = eng.models[name]
        if not e.tiers[tier].use_pallas:
            continue
        kind = (e.cfg.kind if e.cfg.kind != "sage"
                else f"sage/{e.cfg.aggregator}")
        for k, v in SHARD_LAUNCHES[(kind, e.tiers[tier].quantgr)].items():
            want[k] += v * -(-n_req // 2)
    check(launched == want, f"[shard] launches {launched} != the batch "
          f"log's {want}")
    check(all(launched[k] > 0 for k in SHARD_KERNELS),
          f"[shard] a kernel of {SHARD_KERNELS} did not launch: {launched}")
    s = eng.summary()
    sharded = s["sharded_batches"] - m0["sharded_batches"]
    check(sharded == sum(-(-n // 2) for n in keys_n.values()),
          f"[shard] {sharded} sharded batches")
    print(f"[shard] burst of {len(reqs)} sharded requests in {sharded} "
          f"dispatches ({burst_s:.2f} s wall, slice builds included); "
          f"launches {dict((k, launched[k]) for k in SHARD_KERNELS)}",
          flush=True)

    # logits: every request against the plain single-device forward
    cache = {}
    err = 0.0
    for r in reqs:
        check(r.shards == eng._sharded[gids[r.model]][0].shards
              and r.bucket == cap, f"request {r.uid}: not sharded")
        err = max(err, shard_check_request(r, eng.models[r.model], dev,
                                           cache))
    print(f"[shard] logits of all {len(reqs)} sharded requests match the "
          f"plain single-device forward at full_rows (max_abs_err "
          f"{err:.3e}; rtol={TOL['rtol']} atol={TOL['atol']}; GAT and SAGE "
          f"int8 layer by layer)", flush=True)

    # replica rows: each equals its single-replica dispatch bit for bit
    rep_keys = [k for k, n in keys_n.items() if n == 2]
    for name, tier in rep_keys:
        e = eng.models[name]
        t = e.tiers[tier]
        rows = [r for r in reqs if (r.model, r.tier) == (name, tier)]
        plan1 = gmodels.build_sharded_plan(
            e.cfg, cap, rows[0].shards, t, compress=False, device=dev)
        for r in rows:
            one = gmodels.unshard_logits(plan1(
                e.params, r.shard_x, r.ops, e.calibrations.get(tier),
                node_mask=r.shard_mask), r.part)
            check(np.array_equal(one, r.logits), f"{name} {tier}: a replica "
                  f"row differs from its single-replica dispatch")
    print(f"[shard] replica rows bit-equal to single-replica dispatches: "
          f"{rep_keys}", flush=True)

    # the counters: halo bytes of every real request (exact wire here)
    want_c = want_x = 0
    for r in reqs:
        widths = gmodels.sharded_exchange_widths(eng.models[r.model].cfg)
        elems = sum(r.part.full_rows * w for w in widths)
        c_ = int(2.0 * (r.part.shards - 1) / r.part.shards * elems)
        want_c += c_
        want_x += 4 * c_
    got_c = (s["collective_bytes_compressed"]
             - m0["collective_bytes_compressed"],
             s["collective_bytes_exact"] - m0["collective_bytes_exact"],
             s["halo_bytes_exchanged"] - m0["halo_bytes_exchanged"])
    check(got_c == (want_c, want_x, want_x), f"[shard] halo counters "
          f"{got_c} != {(want_c, want_x, want_x)}")
    print(f"[shard] halo bytes: int8 wire {want_c}, exact {want_x} "
          f"(halo_bytes_exchanged, compression off) over {len(reqs)} "
          f"requests: equal to the formula", flush=True)

    # the int8 wire: each exchanged element within scale/2 of the exact
    # exchange, and the logits within the reference's 0.05
    worst, wire_err = 0.0, 0.0
    for name in ("gcn_mm", "gat_mm", "sage_max_mm", "sage_mean_mm"):
        e = eng.models[name]
        r = next(r for r in reqs if (r.model, r.tier) == (name, "fp32"))
        parts_ms, ins, mask = shard_dispatch_parts(e, "fp32", r, dev,
                                                   iters=3)
        for v in ins:
            exact = gmodels.halo_exchange(v, mask, compress=False)
            wire = gmodels.halo_exchange(v, mask, compress=True)
            scale = torch.clamp_min(exact.abs().amax(), 1e-12) \
                * INV_INT8_MAX
            ratio = ((wire - exact).abs().max() / (scale / 2)).item()
            worst = max(worst, ratio)
            # scale/2, plus the float32 rounding of q * scale (at most an
            # ulp of 127 scale, 3e-5 of a half step)
            check(ratio <= 1.0 + 1e-4, f"{name}: an exchanged element is "
                  f"{ratio} half-steps from the exact one")
        plan_w = gmodels.build_sharded_plan(e.cfg, cap, r.shards,
                                            e.tiers["fp32"], compress=True,
                                            device=dev)
        lw = gmodels.unshard_logits(plan_w(e.params, r.shard_x, r.ops, None,
                                           node_mask=r.shard_mask), r.part)
        d = float(np.abs(lw - r.logits).max())
        wire_err = max(wire_err, d)
        check(d <= 0.05, f"{name}: int8-wire logits {d} from the exact "
              f"exchange's")
        am = float((lw.argmax(-1) == r.logits.argmax(-1)).mean())
        print(f"[shard] {name} fp32 {r.shards} x {cap}: one dispatch "
              f"{parts_ms[False]['dispatch']:.3f} ms, of which the two "
              f"exchanges {parts_ms[False]['exchange']:.3f} ms and the "
              f"products and the rest "
              f"{parts_ms[False]['dispatch'] - parts_ms[False]['exchange']:.3f}"
              f" ms; int8 wire: {parts_ms[True]['dispatch']:.3f} ms, "
              f"exchanges {parts_ms[True]['exchange']:.3f} ms; wire logits "
              f"max_abs_err {d:.3e}, argmax equal on {am:.4f} of nodes "
              f"(CUDA events; {card})", flush=True)
    print(f"[shard] int8 wire: worst exchanged element {worst:.4f} of "
          f"scale/2 from the exact exchange; logits within {wire_err:.3e} "
          f"(bar 0.05)", flush=True)

    # the plain single-device forward at the same full_rows, beside the
    # sharded latency model
    e = eng.models["gcn_mm"]
    part = eng._sharded[gids["gcn_mm"]][0]
    ops, t, x, _ = shard_plain(e, "fp32", eng.graphs[gids["gcn_mm"]][1], dev,
                               cache)
    plain_ms = time_ms(lambda: gmodels.forward_grannite(e.params, e.cfg, x,
                                                        ops, t), iters=3)
    kern_ms = time_ms(lambda: gmodels.forward_grannite(
        e.params, e.cfg, x, ops, e.tiers["fp32"]), iters=3)
    widths = gmodels.sharded_exchange_widths(e.cfg)
    model_ms = {c: 1e3 * partition_model(part, e.cfg, widths, c)
                for c in (False, True)}
    print(f"[shard] GCN fp32 at full_rows {part.full_rows} on one card "
          f"unsharded: plain forward (cuBLAS) {plain_ms:.3f} ms, with "
          f"block_matmul {kern_ms:.3f} ms (CUDA events); modelled sharded "
          f"latency across {part.shards} cards {model_ms[False]:.4f} ms "
          f"exact, {model_ms[True]:.4f} ms int8 wire (core/costs.py; a "
          f"model, not a measurement); {card}", flush=True)
    cache.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # the rectangular sage_max: one 2 x 3072 SAGE-max graph's layer-1 row
    # blocks against its pooled features, against the plain version
    r = next(r for r in reqs if (r.model, r.tier) == ("sage_max_mm", "fp32"))
    e = eng.models["sage_max_mm"]
    v_full = gmodels.halo_exchange(r.shard_x[None], r.shard_mask[None],
                                   compress=False)
    pooled = torch.relu(kops.matmul(v_full, e.params["l1"]["w_pool"])
                        + e.params["l1"]["b_pool"])
    pooled = pooled.expand(r.shards, *pooled.shape[1:]).contiguous()
    rect = (r.ops.sample_mask.contiguous(), pooled)
    before = sm.LAUNCHES
    got = sm.sage_max(*rect)
    check(sm.LAUNCHES == before + 1, "rectangular sage_max: no launch")
    check(torch.equal(got, sm.sage_max_plain(*rect)),
          "rectangular sage_max differs from its plain version")
    ops_w, bytes_w = walk_work(rect[0], rect[1].shape[-1])
    b_ms, b_by = bound(ops_w, bytes_w)
    rect_row = dict(rect_shape=[list(rect[0].shape), list(rect[1].shape)],
                    rect_ms=time_ms(lambda: sm.sage_max(*rect)),
                    rect_plain_ms=time_ms(lambda: sm.sage_max_plain(*rect),
                                          iters=3),
                    rect_device_ms=queued_ms(lambda: sm.sage_max(*rect)),
                    rect_bound_ms=b_ms, rect_bound_by=b_by)
    print(f"[shard] sage_max rectangular {tuple(rect[0].shape)} @ "
          f"{tuple(rect[1].shape)}: equal to the plain version; kernel "
          f"{rect_row['rect_ms']:.4f} ms, queued "
          f"{ms_or_not(rect_row['rect_device_ms'])}, plain "
          f"{rect_row['rect_plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
          f"; {card}", flush=True)
    del rect, pooled, v_full, got
    shard_launches = {k: launched[k] for k in SHARD_KERNELS}

    # the same sharded requests through the pipeline scheduler, each
    # answer bit for bit the sync one's
    sync = {(r.model, r.tier): r.logits for r in reqs
            if r.model in ("gcn_mm", "sage_max_mm")}
    with eng.scheduler(PipelineConfig(host_workers=2,
                                      window_ms=2.0)) as sched:
        for name, tier in sync:
            sched.query(gids[name], tier=tier)
        got = sched.drain(timeout=600)       # in ticket order
    for k, r in zip(sync, got):
        check(r.shards > 0 and np.array_equal(r.logits, sync[k]),
              f"{k}: the pipeline's sharded answer differs from the sync one")
    print(f"[shard] pipeline (2 host workers): {len(got)} sharded answers "
          f"bit-equal to the sync path's", flush=True)

    # a mixed sharded/unsharded burst replays warm
    gid_cora = eng.attach(cora, model="gcn_mm")
    for tier in ("fp32", "int8"):
        eng.query(gid_cora, tier=tier)
        eng.query(gids["gcn_mm"], tier=tier)
        eng.query(gids["sage_max_mm"], tier=tier)
    eng.run()
    eng.assert_warm()
    print("[shard] mixed sharded/unsharded burst: assert_warm() holds",
          flush=True)

    # update() across the sharding boundary, both ways
    gid_x = eng.attach(small, model="gcn_mm")
    check(gid_x not in eng._sharded, "the 2,000-node graph sharded")
    rb0 = eng.metrics["rebucket_events"]
    check(eng.update(gid_x, mid.edge_index, mid.num_nodes, mid.features),
          "growing past 3072 is a rebucket")
    check(eng.summary()["shard_counts"].get(gid_x) == 2,
          "the grown graph is not sharded 2 ways")
    u1 = eng.query(gid_x)
    eng.run()
    r1 = next(r for r in eng.finished if r.uid == u1)
    shard_check_request(r1, eng.models["gcn_mm"], dev, cache)
    check(eng.update(gid_x, small.edge_index, small.num_nodes,
                     small.features), "shrinking back is a rebucket")
    check(gid_x not in eng.summary()["shard_counts"],
          "the shrunk graph is still sharded")
    u2 = eng.query(gid_x)
    eng.run()
    r2 = next(r for r in eng.finished if r.uid == u2)
    check(r2.shards == 0 and r2.bucket == cap, "the shrunk graph's query "
          "is not an unsharded top-bucket request")
    ref = gcn_plain(r2, params, dev)
    torch.testing.assert_close(torch.from_numpy(r2.logits), ref, **TOL)
    check(eng.metrics["rebucket_events"] - rb0 == 2, "rebucket_events")
    eng.assert_warm()
    print("[shard] update(): 2,000 -> 5,000 nodes into 2 x 3072 and back, "
          "two rebuckets, answers against the plain forward", flush=True)
    cache.clear()

    # a GrAd delta on the 4-shard graph: patched slices and logits equal a
    # sharded build of the patched structure under the kept partition
    gid = gids["gcn_mm"]
    part = eng._sharded[gid][0]
    pg0 = eng.graphs[gid][1]
    n = pg0.num_nodes
    a = part.assignment
    rng = np.random.default_rng(30)
    keys0 = eng._graph_keys[gid]
    row, col = np.divmod(keys0, part.full_rows)
    cross = np.flatnonzero((row < col) & (a[row % n] != a[col % n])
                           & (row < n) & (col < n))
    rm = np.stack([row, col], 1)[rng.choice(cross, 2, replace=False)]
    add = []
    while len(add) < 4:
        u, v = (int(z) for z in rng.integers(0, n, 2))
        if a[u] != a[v] and pg0.adj[u, v] == 0:
            add.append((min(u, v), max(u, v)))
    delta = apply_edge_delta(pg0.adj, pg0.norm_adj, n, add, rm)
    dirty = delta.boundary_rows(a, n)
    d0 = {k: eng.metrics[k] for k in ("delta_updates",
                                      "delta_halo_bytes_exchanged",
                                      "delta_halo_bytes_full",
                                      "delta_dirty_rows")}
    t0 = time.perf_counter()
    check(eng.update_delta(gid, add_edges=add, remove_edges=rm),
          "the sharded delta fell back")
    delta_ms = (time.perf_counter() - t0) * 1e3
    ver = eng._graph_version[gid]
    patched = eng._shard_cache[(gid, ver)]
    part2, g2 = eng._sharded[gid]
    check(np.array_equal(part2.perm, part.perm), "the delta re-partitioned")
    rebuilt = gmodels.build_sharded_operands(
        g2, part2, cfg, pg=eng.graphs[gid][1], keys=eng._graph_keys[gid],
        device=dev)
    for sa, sb in zip(patched, rebuilt):
        check(torch.equal(sa.ops.norm_adj, sb.ops.norm_adj)
              and torch.equal(sa.x, sb.x)
              and torch.equal(sa.node_mask, sb.node_mask),
              "a patched slice differs from the sharded rebuild")
    xr, opr, mr = gmodels.stack_shard_slices(rebuilt)
    for tier in ("fp32", "int8"):
        u = eng.query(gid, tier=tier)
        eng.run()
        r = next(r for r in eng.finished if r.uid == u)
        e = eng.models["gcn_mm"]
        plan = gmodels.build_sharded_plan(cfg, part.shard_cap, part.shards,
                                          e.tiers[tier], compress=False,
                                          device=dev)
        want_l = gmodels.unshard_logits(plan(
            e.params, xr, opr, e.calibrations.get(tier), node_mask=mr), part)
        check(np.array_equal(r.logits, want_l), f"delta {tier}: logits "
              f"differ from the sharded rebuild's")
    full = part.full_rows
    want_d = (1, int(2.0 * (part.shards - 1) / part.shards
                     * len(dirty) * (full + 1) * 4),
              int(2.0 * (part.shards - 1) / part.shards
                  * (full * full + full) * 4), len(dirty))
    got_d = tuple(eng.metrics[k] - d0[k] for k in d0)
    check(got_d == want_d, f"delta counters {got_d} != {want_d}")
    eng.assert_warm()
    print(f"[shard] update_delta on the 4 x 3072 graph ({len(add)} adds, "
          f"{len(rm)} removes across shards, {len(dirty)} boundary-dirty "
          f"rows): slices and fp32/int8 logits bit-equal to a sharded "
          f"rebuild under the kept partition; delta-halo bytes "
          f"{want_d[1]} against a full re-exchange's {want_d[2]}; "
          f"update_delta {delta_ms:.1f} host ms (the dense host patch "
          f"included); {card}", flush=True)
    del eng, patched, rebuilt, xr, opr, mr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[shard] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return shard_launches, rect_row


# [mesh]: the sharded GNN path on a mesh of processes, one rank per
# (replica, shard) cell, every rank on this one card through gloo (NCCL
# refuses two ranks on one device), each rank's answers held bit for bit
# against the single-process (stacked) sharded engine on the same calls
MESH_TIMEOUT_S = 300
MESH_CONFIGS = (
    ("GCN 4 x 3072", ss.BurstSpec(kinds=("gcn",), nodes=SHARD_GCN_NODES,
                                  shards=4, delta=True), "both"),
    ("GAT/SAGE 2 x 3072", ss.BurstSpec(
        kinds=("gat", "sage-max", "sage-mean"), nodes=SHARD_NODES,
        shards=2, grow=(SHARD_SMALL_NODES, SHARD_NODES)), "off"),
    ("GCN 2 x 2 x 3072", ss.BurstSpec(kinds=("gcn",), nodes=SHARD_NODES,
                                      shards=2, replicas=2), "off"),
)


def mesh_launch_want(batch_log):
    """A rank's launches of SHARD_KERNELS from its batch log: each sharded
    dispatch launches, on every rank, what one stacked dispatch does."""
    want = dict.fromkeys(SHARD_KERNELS, 0)
    for model, tier in batch_log:
        kind = {"sage-max": "sage/max", "sage-mean": "sage/mean"}.get(model,
                                                                     model)
        for k, v in SHARD_LAUNCHES[(kind, tier == "int8")].items():
            want[k] += v
    return want


def mesh_phase(dev, card):
    """[mesh]: GraphServe(mesh=) on gloo ranks sharing this card (4 x
    3072 GCN with both wires and an update_delta, GAT and SAGE at 2 x
    3072 with update() across the boundary, the GCN on a 2 x 2 replica
    mesh): every rank's answers, checks, launches and the lead's counters
    against the single-process engine; per rank the cache residency, a
    dispatch's ms (all_reduce apart) and the bytes handed to all_reduce;
    then the group collectives on an NCCL world of one rank, and NCCL's
    answer to two ranks on one card. Returns the ranks' launches of
    SHARD_KERNELS, summed."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(SHARD_KERNELS, 0)
    for label, spec, wire in MESH_CONFIGS:
        free_card()
        world = spec.shards * spec.replicas
        t0 = time.perf_counter()
        outs = [ss.last_json(o) for o in ss.spawn_local(
            world, ss.burst_args(spec, wire) + [
                "--backend", "gloo", "--device", str(dev)], MESH_TIMEOUT_S)]
        mesh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wires = {"both": (False, True), "off": (False,)}[wire]
        ref = ss.serve(spec, wires=wires, device=dev)
        ref_s = time.perf_counter() - t0
        print(f"[mesh] {label}: {world} gloo ranks on {dev} in {mesh_s:.1f} "
              f"s; the single-process engine on the same calls in "
              f"{ref_s:.1f} s", flush=True)
        for w, r in ref.items():
            want_sum = json.loads(json.dumps(r["summary"]))
            for o in outs:
                got = o["wires"][w]
                tag = f"[mesh] {label} wire {w}, rank {o['rank']} {o['coords']}"
                check(got["answers"] and all(
                    r["answers"].get(k) == v
                    for k, v in got["answers"].items()),
                      f"{tag}: an answer differs from the single-process "
                      f"engine's")
                check(all(got["checks"].values()), f"{tag}: checks "
                      f"{got['checks']}")
                check(got["batch_log"] == r["batch_log"], f"{tag}: batch log "
                      f"{got['batch_log']} != {r['batch_log']}")
                want_l = mesh_launch_want(got["batch_log"])
                check(got["launches"] == want_l, f"{tag}: launches "
                      f"{got['launches']} != the batch log's {want_l}")
                for k in SHARD_KERNELS:
                    total[k] += got["launches"][k]
                print(f"{tag}: host seconds of the engine's build "
                      f"{got['stages']['engine_s']:.1f}, the burst "
                      f"{got['stages']['burst_s']:.1f}, the timing "
                      f"{got['stages']['timing_s']:.1f} (single-process "
                      f"{r['stages']['engine_s']:.1f}, "
                      f"{r['stages']['burst_s']:.1f}, "
                      f"{r['stages']['timing_s']:.1f})", flush=True)
                if o["rank"] == 0:
                    check(set(got["answers"]) == set(r["answers"]),
                          f"{tag}: the lead answered {sorted(got['answers'])}")
                    check(got["summary"] == want_sum, f"{tag}: summary "
                          f"{got['summary']} != {want_sum}")
                for model, d in got["dispatch"].items():
                    rd = r["dispatch"][model]
                    print(f"{tag} {model}: cache_resident_bytes "
                          f"{got['cache_resident_bytes']} (single-process "
                          f"{r['cache_resident_bytes']}); one fp32 dispatch "
                          f"{ms_or_not(d['dispatch_ms'], 3)} = all_reduce "
                          f"{ms_or_not(d['allreduce_ms'], 3)} + the rest "
                          f"{ms_or_not(d['rest_ms'], 3)} (CUDA events), "
                          f"single-process [shard] dispatch "
                          f"{ms_or_not(rd['dispatch_ms'], 3)}, "
                          f"modelled {d['modelled_ms']:.4f} ms (a model); "
                          f"{d['wire_bytes']} bytes to all_reduce in "
                          f"{d['wire_calls']} calls (ring_psum_nbytes "
                          f"prices {d['ring_price_bytes']:.0f}); launches "
                          f"{got['launches']}; {card}", flush=True)
            print(f"[mesh] {label} wire {w}: {len(r['answers'])} answers of "
                  f"every rank bit-equal to the single-process engine's, "
                  f"checks {sorted(outs[0]['wires'][w]['checks'])} hold, "
                  f"the lead's counters equal (halo "
                  f"{want_sum['halo_bytes_exchanged']}, sharded_batches "
                  f"{want_sum['sharded_batches']})", flush=True)
    check(all(total[k] > 0 for k in SHARD_KERNELS),
          f"[mesh] a kernel of {SHARD_KERNELS} never launched: {total}")

    # NCCL, both worlds at once: the group forms on a world of one rank,
    # and two ranks on this one card. Of the two, NCCL's refusal of a
    # second rank on the card ("Duplicate GPU detected") is recorded;
    # any other failure fails the phase, and a run is checked as one
    def nccl(world):
        return ss.spawn_local(world, [
            "--collectives", "--backend", "nccl", "--device", str(dev),
            "--shards", str(world)], MESH_TIMEOUT_S)

    with ThreadPoolExecutor(2) as pool:
        one, two = pool.submit(nccl, 1), pool.submit(nccl, 2)
        runs = [ss.last_json(one.result()[0])]
        try:
            runs += [ss.last_json(t) for t in two.result()]
            nccl2 = "ran, the group forms equal the stacked ones"
        except RuntimeError as exc:
            dup = [ln.strip() for ln in str(exc).splitlines()
                   if "Duplicate GPU" in ln]
            if not dup:
                raise
            nccl2 = "refused: " + dup[0]
    for o in runs:
        check(o["backend"] == "nccl" and not any(o["collectives"].values()),
              f"[mesh] NCCL rank {o.get('rank')}: {o['collectives']}")
    print(f"[mesh] NCCL, a world of one rank: the group forms equal the "
          f"stacked ones bit for bit ({sorted(o['collectives'])})",
          flush=True)
    print(f"[mesh] NCCL, two ranks on one card: {nccl2}", flush=True)
    print(f"[mesh] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


# [mesh-pipeline]: the pipeline scheduler on [mesh]'s GCN meshes: each
# rank serves the burst through run() and then through
# scheduler(PipelineConfig(host_workers=2, window_ms=2.0)), then a burst
# of 0.001 ms deadlines, which the lead expires
MESH_PIPELINE_CONFIGS = (
    ("GCN 4 x 3072", ss.BurstSpec(kinds=("gcn",), nodes=SHARD_GCN_NODES,
                                  shards=4, delta=True, pipeline=2)),
    ("GCN 2 x 2 x 3072", ss.BurstSpec(kinds=("gcn",), nodes=SHARD_NODES,
                                      shards=2, replicas=2, pipeline=2)),
)


def mesh_pipeline_phase(dev, card):
    """[mesh-pipeline]: `GraphServe(mesh=).scheduler()` on gloo ranks
    sharing this card, the Cora GCN at 4 x 3072 (with an `update_delta`
    while the scheduler is open) and on the 2 x 2 x 3072 replica mesh.
    Each rank's pipelined answers must equal its sync mesh run()'s bit
    for bit, its batch log (uids included) the lead's, its launches of
    SHARD_KERNELS over the pipelined burst its batch log's, the deadline
    burst expired alike on every rank, and accepted == completed. Prints
    per rank the pipelined burst's wall seconds beside the sync burst's,
    host_busy_s, device_busy_s and the idle share. Returns the ranks'
    launches of SHARD_KERNELS over the pipelined bursts, summed."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(SHARD_KERNELS, 0)
    for label, spec in MESH_PIPELINE_CONFIGS:
        free_card()
        world = spec.shards * spec.replicas
        t0 = time.perf_counter()
        outs = [ss.last_json(o) for o in ss.spawn_local(
            world, ss.burst_args(spec, "off") + [
                "--backend", "gloo", "--device", str(dev)], MESH_TIMEOUT_S)]
        print(f"[mesh-pipeline] {label}: {world} gloo ranks on {dev} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        lead = outs[0]["wires"]["off"]["pipeline"]
        for o in outs:
            got = o["wires"]["off"]
            p = got["pipeline"]
            tag = f"[mesh-pipeline] {label}, rank {o['rank']} {o['coords']}"
            check(p["answers"] and all(got["answers"].get(k) == v
                                       for k, v in p["answers"].items()),
                  f"{tag}: a pipelined answer differs from the sync run's")
            check(set(p["answers"]) == set(got["answers"]),
                  f"{tag}: answered {sorted(p['answers'])}, the sync run "
                  f"{sorted(got['answers'])}")
            check(all(p["checks"].values()), f"{tag}: checks {p['checks']}")
            check(p["batch_log"] == lead["batch_log"], f"{tag}: batch log "
                  f"{p['batch_log']} != the lead's {lead['batch_log']}")
            want_l = mesh_launch_want([e[:2] for e in p["batch_log"]])
            check(p["launches"] == want_l, f"{tag}: launches "
                  f"{p['launches']} != the batch log's {want_l}")
            check(p["expired"] == lead["expired"]
                  and len(p["expired"]) == 2 and all(p["expired"].values()),
                  f"{tag}: the deadline burst expired {p['expired']}, the "
                  f"lead {lead['expired']}")
            c = p["counters"]
            check(c["accepted"] == c["completed"], f"{tag}: accepted "
                  f"{c['accepted']} != completed {c['completed']}")
            for k in SHARD_KERNELS:
                total[k] += p["launches"][k]
            st = got["stages"]
            print(f"{tag}: pipelined burst {p['burst_s']:.4f} s against the "
                  f"sync run()'s {st['burst_s']:.4f} s "
                  f"({p['burst_s'] / st['burst_s']:.3f}x); host_busy_s "
                  f"{c['host_busy_s']:.4f}, device_busy_s "
                  f"{p['device_busy_s']:.4f}, idle share "
                  f"{1 - p['device_busy_s'] / p['burst_s']:.4f} (sync: "
                  f"device_busy_s {st['device_busy_s']:.4f}, idle "
                  f"{1 - st['device_busy_s'] / st['burst_s']:.4f}); "
                  f"{len(p['batch_log'])} sharded batches, launches "
                  f"{p['launches']}; {card}", flush=True)
        print(f"[mesh-pipeline] {label}: {len(lead['answers'])} answers of "
              f"every rank bit-equal to its sync run()'s, batch logs "
              f"{[e[2] for e in lead['batch_log']]} alike, deadline burst "
              f"expired alike", flush=True)
    check(all(total[k] > 0 for k in ("block_matmul", "int8_matmul")),
          f"[mesh-pipeline] a GCN kernel never launched: {total}")
    print(f"[mesh-pipeline] phase took {time.perf_counter() - t_phase:.1f} "
          f"s", flush=True)
    return total


def train_forward(cfg, ops_, t, fusion="none", quant=None, tier_ops=None):
    return lambda p, x: gmodels.forward_grannite(p, cfg, x, ops_, t, quant,
                                                 tier_ops, fusion)


def gat_layerwise(params, cfg, x, ops_, t_kernel, quant):
    """A QuantGr GAT forward layer by layer (PERF.md section 2): layer 1
    through the kernels and plain, then layer 2 over the kernels' layer 1,
    through the kernels and plain. Returns ((kernel, plain) per layer)."""
    t_plain = dataclasses.replace(t_kernel, use_pallas=False)
    per_head = cfg.hidden // cfg.heads
    out, h = [], x
    for layer, kw in (("l1", dict(heads=cfg.heads, out_feats=per_head)),
                      ("l2", dict(heads=1, out_feats=cfg.num_classes))):
        pair = tuple(glayers.gat_grannite(params[layer], h, ops_.mask_mult,
                                          ops_.bias_add, t,
                                          quant=quant[layer], **kw)
                     for t in (t_kernel, t_plain))
        out.append(pair)
        h = torch.nn.functional.elu(pair[0])
    return out


def train_tiers(kind, cfg, params, x, ops_, dev):
    """The trained model's tiers through the kernels, each beside the
    plain forward of the same tier: [(tier, kernels, [(kernel logits,
    plain logits) per compared output], logits served)]."""
    t_int8 = gserver.tier_techniques(cfg.kind)["int8"]
    if kind == "gcn":
        plain = train_forward(cfg, ops_, Techniques(stagr=True))(params, x)
        ops_q = dataclasses.replace(ops_, quant=gmodels.calibrate_quant(
            params, cfg, x, ops_))
        t_q = Techniques(stagr=True, quantgr=True)
        plain_q = train_forward(cfg, ops_q, t_q)(params, x)
        cal = calibrate_tier(params, cfg, x, ops_)
        tops_ = derive_tier_operands(ops_.norm_adj)
        plain_s = train_forward(cfg, ops_, t_int8, quant=cal,
                                tier_ops=tops_)(params, x)
        runs = [("fp32", "block_matmul", train_forward(
                    cfg, ops_, Techniques(stagr=True, use_pallas=True)),
                 plain),
                ("fp32", "fused_gcn_dense", train_forward(
                    cfg, ops_, Techniques(stagr=True), "layer"), plain),
                ("offline int8", "int8_matmul", train_forward(
                    cfg, ops_q, dataclasses.replace(t_q, use_pallas=True)),
                 plain_q),
                ("offline int8", "fused_gcn_int8", train_forward(
                    cfg, ops_q, t_q, "layer"), plain_q),
                ("serving int8", "int8_matmul", train_forward(
                    cfg, ops_, dataclasses.replace(t_int8, use_pallas=True),
                    quant=cal, tier_ops=tops_), plain_s),
                ("serving int8", "fused_gcn_int8", train_forward(
                    cfg, ops_, t_int8, "layer", cal, tops_), plain_s)]
        return [(tier, k, [(fn(params, x), want)], None)
                for tier, k, fn, want in runs]
    if kind == "gat":
        t_x = Techniques(effop=True, grax1=True, grax2=True)
        plain = train_forward(cfg, ops_, t_x)(params, x)
        out = [("grax", k, [(train_forward(cfg, ops_, t, fusion)(params, x),
                             plain)], None)
               for k, t, fusion in (
                   ("gat_attention",
                    dataclasses.replace(t_x, use_pallas=True), "none"),
                   ("fused_gat_full", t_x, "layer"))]
        t_ix = dataclasses.replace(gserver.tier_techniques("gat")[
            "int8+grax"], use_pallas=True)
        pairs = gat_layerwise(params, cfg, x, ops_, t_ix,
                              calibrate_tier(params, cfg, x, ops_))
        out.append(("int8+grax", "int8_matmul, gat_attention", pairs,
                    pairs[-1][0]))
        return out
    if kind == "sage-max":
        t_x = Techniques(effop=True, grax3=True)
        plain = train_forward(cfg, ops_, t_x)(params, x)
        runs = (("sage_max", dataclasses.replace(t_x, use_pallas=True),
                 "none"), ("fused_sage", t_x, "layer"))
        return [("grax3", k, [(train_forward(cfg, ops_, t, f)(params, x),
                               plain)], None) for k, t, f in runs]
    t_m = Techniques(stagr=True)
    plain = train_forward(cfg, ops_, t_m)(params, x)
    runs = (("block_matmul", dataclasses.replace(t_m, use_pallas=True),
             "none"), ("fused_sage", t_m, "layer"))
    return [("fp32", k, [(train_forward(cfg, ops_, t, f)(params, x),
                          plain)], None) for k, t, f in runs]


def grad_step(forward, params, x, y, mask):
    """The gradients of the masked loss over every parameter, the work of
    one training epoch but AdamW's elementwise update."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in flat]
    loss = gmodels.masked_cross_entropy(
        forward(pytree.tree_unflatten(leaves, spec), x), y, mask)
    return torch.autograd.grad(loss, leaves)


def train_phase(dev, card):
    """[train]: the paper's four Cora models trained on the card (100
    epochs, lr 0.01, weight decay 5e-4, AdamW, `accuracy_table`'s training
    forwards: the dense GCN and exact-mask GAT, SAGE on the edge-list
    baseline), then evaluated through the kernels tier by tier, each tier
    held against its plain forward; the edge-list GCN against the dense
    one; and the baseline against GraNNite's forwards on Cora and
    CiteSeer, timed. Returns the launches of TRAIN_KERNELS, counted from
    0 over the training and the evaluations, before the timings."""
    t_phase = time.perf_counter()
    g = cora_like(seed=0)
    pg = pad_graph(g)
    n = g.num_nodes
    x = torch.from_numpy(pg.features).to(dev)
    y = torch.from_numpy(pg.labels).long().to(dev)
    test = torch.from_numpy(pg.test_mask).to(dev)
    tm = torch.from_numpy(pg.train_mask).to(dev)
    ei = torch.from_numpy(g.edge_index).to(dev)
    ei_loops = torch.from_numpy(add_self_loops(g.edge_index, n)).to(dev)
    check(pg.capacity == 2816, f"Cora padded to {pg.capacity}, not 2816")
    reset_launches()                        # the [train] path starts here
    table, trained = {}, {}

    def acc(logits):
        return float(gmodels.accuracy(logits, y, test))
    for kind in TRAIN_MODELS:
        cfg = GNN_MODELS[kind]("cora")
        ops_ = build_operands(pg, cfg, device=dev)
        t_plain = {"gcn": Techniques(stagr=True),
                   "gat": Techniques(effop=True),
                   "sage-max": Techniques(effop=True),
                   "sage-mean": Techniques(stagr=True)}[kind]
        fwd = train_forward(cfg, ops_, t_plain)
        if kind.startswith("sage"):
            def fwd_train(p, xx, _c=cfg):
                return gmodels.forward_baseline(p, _c, xx, ei, pg.capacity)
        else:
            fwd_train = fwd
        history = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        params = gmodels.train_node_classifier(
            torch.Generator().manual_seed(0), cfg, pg, fwd_train,
            lr=TRAIN_LR, weight_decay=TRAIN_WD, epochs=TRAIN_EPOCHS,
            device=dev, history=history)
        end.record()
        enqueue_s = time.perf_counter() - t0    # the host's part, no wait
        end.synchronize()
        train_ms, host_s = start.elapsed_time(end), time.perf_counter() - t0
        losses = [float(v) for v in history]
        check(len(losses) == TRAIN_EPOCHS and all(map(math.isfinite, losses))
              and losses[-1] < losses[0],
              f"[train] {kind}: the loss did not fall: {losses[0]} -> "
              f"{losses[-1]}")
        with torch.no_grad():
            acc_fp32 = acc(fwd(params, x))
            row = {"train_ms": train_ms, "ms_per_epoch":
                   train_ms / TRAIN_EPOCHS, "host_s": host_s,
                   "loss_first": losses[0], "loss_final": losses[-1],
                   "fp32": acc_fp32, "tiers": {}}
            if kind.startswith("sage"):
                row["train_forward_baseline"] = acc(fwd_train(params, x))
            print(f"[train] {kind}: {TRAIN_EPOCHS} epochs in {train_ms:.1f} "
                  f"ms ({train_ms / TRAIN_EPOCHS:.3f} ms an epoch, CUDA "
                  f"events; {host_s:.2f} s host), every parameter given a "
                  f"gradient at every epoch; loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}; fp32 test accuracy {acc_fp32:.4f}"
                  + (f" (edge-list training forward "
                     f"{row['train_forward_baseline']:.4f})"
                     if kind.startswith("sage") else "") + f"; {card}",
                  flush=True)
        # the device's own time for an epoch's forward and backward
        # (torch.profiler's kernels, 3 calls) beside the events' span and
        # the host's queueing: whether the card or the host sets the pace
        ks = device_kernels(lambda: grad_step(fwd_train, params, x, y, tm),
                            iters=3)
        step_ms = sum(ms for ms, _ in ks.values()) / 3
        per_epoch = train_ms / TRAIN_EPOCHS
        idle = 1.0 - step_ms / per_epoch
        bound = ("host" if enqueue_s * 1e3 >= 0.9 * train_ms and idle > 0.5
                 else "device" if idle < 0.1 else "mixed")
        row.update({"enqueue_s": enqueue_s, "grad_step_device_ms": step_ms,
                    "grad_step_kernels": sum(n for _, n in ks.values()) / 3,
                    "idle_share": idle, "bound": bound})
        print(f"[train] {kind}: the host queued the {TRAIN_EPOCHS} epochs "
              f"in {enqueue_s * 1e3:.1f} ms of the events' {train_ms:.1f}; "
              f"an epoch's forward and backward keep the device busy "
              f"{step_ms:.4f} ms ({row['grad_step_kernels']:.0f} kernels, "
              f"torch.profiler) of the {per_epoch:.3f} ms an epoch takes, "
              f"idle share {idle:.2f}: {bound}-bound; {card}", flush=True)
        with torch.no_grad():
            for tier, kernels, pairs, served in train_tiers(
                    kind, cfg, params, x, ops_, dev):
                errs = []
                for got, want in pairs:
                    errs.append((got[:n] - want[:n]).abs().max().item())
                    torch.testing.assert_close(
                        got[:n], want[:n], **TOL,
                        msg=lambda m: f"[train] {kind} {tier} through "
                                      f"{kernels} against plain: {m}")
                    if "int8" in tier and kind == "gcn":
                        check(torch.equal(got[:n].argmax(-1),
                                          want[:n].argmax(-1)),
                              f"[train] {kind} {tier} ({kernels}): argmax "
                              "differs from the plain int8 forward")
                a = acc(served if served is not None else pairs[0][0])
                row["tiers"][f"{tier} ({kernels})"] = {
                    "accuracy": a, "delta_points": (a - acc_fp32) * 100.0,
                    "max_abs_err": max(errs)}
                print(f"[train] {kind} tier {tier} through {kernels}: test "
                      f"accuracy {a:.4f}, delta {(a - acc_fp32) * 100:+.2f} "
                      f"points vs fp32; max |kernel - plain| "
                      f"{max(errs):.3e}" + (" (layer by layer)"
                                           if len(pairs) > 1 else ""),
                      flush=True)
        table[kind] = row
        trained[kind] = (cfg, params, ops_)
        del ops_
        torch.cuda.empty_cache()

    # the edge-list GCN against GraNNite's dense one, the reference's bar
    cfg, params, ops_ = trained["gcn"]
    with torch.no_grad():
        base = gmodels.forward_baseline(params, cfg, x, ei_loops, pg.capacity)
        dense = train_forward(cfg, ops_, Techniques(stagr=True))(params, x)
    berr = (base[:n] - dense[:n]).abs().max().item()
    torch.testing.assert_close(base[:n], dense[:n], **BASELINE_BAR,
                               msg=lambda m: f"[train] the edge-list GCN "
                                             f"against forward_grannite: {m}")
    print(f"[train] trained GCN: forward_baseline (edge list with self-loops)"
          f" against forward_grannite (StaGr): max |diff| {berr:.3e}, held "
          f"at rtol 1e-4, atol 1e-5", flush=True)

    # CiteSeer's GCN (random weights): 3328 nodes and K = 3703, which the
    # kernel entries pad to 3712 and strip, through the kernels at the bar
    cs = citeseer_like(seed=0)
    pgc = pad_graph(cs)
    check(pgc.capacity == 3328, f"CiteSeer padded to {pgc.capacity}")
    cfgc = gcn("citeseer")
    pc = gmodels.init_params(torch.Generator().manual_seed(0), cfgc,
                             device=dev)
    xc = torch.from_numpy(pgc.features).to(dev)
    opsc = build_operands(pgc, cfgc, device=dev)
    opsc_q = dataclasses.replace(opsc, quant=gmodels.calibrate_quant(
        pc, cfgc, xc, opsc))
    t_q = Techniques(stagr=True, quantgr=True)
    with torch.no_grad():
        for label, got, want in (
                ("fp32 fused_gcn_dense",
                 train_forward(cfgc, opsc, Techniques(stagr=True),
                               "layer")(pc, xc),
                 train_forward(cfgc, opsc, Techniques(stagr=True))(pc, xc)),
                ("offline int8 fused_gcn_int8",
                 train_forward(cfgc, opsc_q, t_q, "layer")(pc, xc),
                 train_forward(cfgc, opsc_q, t_q)(pc, xc))):
            m = cs.num_nodes
            torch.testing.assert_close(
                got[:m], want[:m], **TOL,
                msg=lambda e: f"[train] CiteSeer {label}: {e}")
            print(f"[train] CiteSeer GCN {label} against plain: max |diff| "
                  f"{(got[:m] - want[:m]).abs().max().item():.3e}",
                  flush=True)
    launched = launches_now()
    train_launches = {k: launched[k] for k in TRAIN_KERNELS}
    print(f"[train] launches over training and evaluation: {train_launches}",
          flush=True)
    check(all(v > 0 for v in train_launches.values()),
          f"[train] a kernel of the path never launched: {train_launches}")

    # the paper's speedup over the default mapping, on this card: the
    # edge-list baseline against GraNNite's forwards (CUDA events), and
    # queued behind a spin, which leaves out the host's launch gaps
    eic = torch.from_numpy(add_self_loops(cs.edge_index,
                                          cs.num_nodes)).to(dev)
    cora_q = dataclasses.replace(ops_, quant=gmodels.calibrate_quant(
        params, cfg, x, ops_))
    times, queued = {}, {}
    with torch.no_grad():
        for graph, (c, p, xx, o, oq, e, cap) in (
                ("cora", (cfg, params, x, ops_, cora_q, ei_loops,
                          pg.capacity)),
                ("citeseer", (cfgc, pc, xc, opsc, opsc_q, eic,
                              pgc.capacity))):
            runs = {"baseline": lambda: gmodels.forward_baseline(
                        p, c, xx, e, cap),
                    "plain fp32": lambda: train_forward(
                        c, o, Techniques(stagr=True))(p, xx),
                    "fused fp32": lambda: train_forward(
                        c, o, Techniques(stagr=True), "layer")(p, xx),
                    "offline int8": lambda: train_forward(
                        c, oq, t_q, "layer")(p, xx)}
            times[graph] = {k: time_ms(fn) for k, fn in runs.items()}
            queued[graph] = {k: queued_ms(fn) for k, fn in runs.items()}
            for label, t in (("by CUDA events", times[graph]),
                             ("queued", queued[graph])):
                tb = t["baseline"]
                print(f"[train] {graph} GCN ({cap} nodes, {xx.shape[1]} "
                      f"features), ms a forward {label}: " + ", ".join(
                          f"{k} {ms_or_not(v)}" + (
                              f" ({tb / v:.2f}x)" if tb and v else "")
                          for k, v in t.items()) + f"; {card}", flush=True)
    print("[train] table " + json.dumps({"models": table, "times": times,
                                         "queued": queued, "card": card}),
          flush=True)
    print(f"[train] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return train_launches


def partition_model(part, cfg, widths, compress):
    """core.partition.modelled_sharded_latency of the part, in seconds."""
    return modelled_sharded_latency(part, in_feats=cfg.in_feats,
                                    hidden=cfg.hidden,
                                    classes=cfg.num_classes,
                                    exchange_widths=widths,
                                    compress=compress)


# [train-lm]: flash_attention_bwd against its plain version on the card,
# each (dq, dk, dv) within BWD_ERR_FACTOR times the plain version's error
# against a float64 autograd oracle, in the same dtype (the bar the GAT
# kernels took against float64). (B, Sq, Skv, H, KV, D), causal, window,
# softcap, q_offset, dtype, and the route the case must take: SmolLM's
# training shape, Whisper's encoder and cross-attention, Phi-3-vision's
# head dim 96, the reduced gemma2 with its window and softcap, fp32 cases
# at head dim 32 and 64, rows that no key may reach at head dim 64 and
# 128, and the tensor-core route's softcap at D 64 (with a window) and
# D 128 (Sq != Skv, q_offset)
BWD_ERR_FACTOR = 2.0
BWD_CASES = {
    "smollm train (B 4, S 1024, 9/3 heads of 64)": (
        (4, 1024, 1024, 9, 3, 64), True, None, None, 0, torch.bfloat16,
        "wgmma"),
    "whisper encoder (B 4, S 1500, 8/8 heads of 64, non-causal)": (
        (4, 1500, 1500, 8, 8, 64), False, None, None, 0, torch.bfloat16,
        "wgmma"),
    "whisper cross (B 4, 256 x 1500, 8/8 heads of 64, non-causal)": (
        (4, 256, 1500, 8, 8, 64), False, None, None, 0, torch.bfloat16,
        "wgmma"),
    "phi3v (B 2, S 1280, 32/32 heads of 96)": (
        (2, 1280, 1280, 32, 32, 96), True, None, None, 0, torch.bfloat16,
        "wgmma"),
    "reduced gemma2 (B 2, S 256, 4/2 heads of 32, window 64, softcap 50)": (
        (2, 256, 256, 4, 2, 32), True, 64, 50.0, 0, torch.bfloat16, "simt"),
    "fp32 (B 2, S 256, 4/2 heads of 32)": (
        (2, 256, 256, 4, 2, 32), True, None, None, 0, torch.float32, "simt"),
    "fp32 smollm heads (B 1, S 200, 9/3 heads of 64)": (
        (1, 200, 200, 9, 3, 64), True, None, None, 0, torch.float32, "simt"),
    "window past the keys (B 1, 64 x 256, q_offset 250, window 48)": (
        (1, 64, 256, 4, 2, 64), True, 48, None, 250, torch.bfloat16,
        "wgmma"),
    "D128 non-causal, window past the keys (65 x 129, q_offset 120)": (
        (1, 65, 129, 8, 4, 128), False, 30, None, 120, torch.float32,
        "simt"),
    "qwen3 heads (B 2, S 129, 32/8 heads of 128)": (
        (2, 129, 129, 32, 8, 128), True, None, None, 0, torch.bfloat16,
        "wgmma"),
    "D64 window 64, softcap 50 (B 2, S 256, 8/4 heads)": (
        (2, 256, 256, 8, 4, 64), True, 64, 50.0, 0, torch.bfloat16, "wgmma"),
    "D128 softcap 30, 200 x 330, q_offset 130 (B 2, 8/2 heads)": (
        (2, 200, 330, 8, 2, 128), True, None, 30.0, 130, torch.bfloat16,
        "wgmma"),
}
# (B, Sq, Skv, H, KV, D, causal) of the backward's timed shapes: SmolLM's
# training microbatch and Phi-3-vision's prefill
BWD_TIMED = {"smollm_train": (4, 1024, 1024, 9, 3, 64, True),
             "phi3v": (4, 1280, 1280, 32, 32, 96, True)}


def attention_f64_grads(q, k, v, dout, *, causal=True, window=None,
                        softcap=None, q_offset=0):
    """(dq, dk, dv) of the exact attention in float64 (the -1e9 mask, no
    rounding anywhere): the oracle both the kernel and the plain
    backward are held against."""
    leaves = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    qq, kk, vv = leaves
    b, sq, h, d = q.shape
    skv, group = k.shape[1], h // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", qq,
                     kk.repeat_interleave(group, 2)) * d ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~mask, -1e9), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv.repeat_interleave(group, 2))
    return torch.autograd.grad(out, leaves, dout.double())


def bwd_check_phase(dev):
    """[train-lm] step 1: flash_attention_bwd against flash_attention_bwd_ref
    and both against float64 at every BWD_CASES case, each on its route
    (the route's counter) and a second call bit-equal to the first.
    Returns the kernel's largest abs difference from the plain version,
    its largest abs error against float64 and its largest ratio to the
    plain version's."""
    rng = np.random.default_rng(37)
    worst, worst_ratio, worst_plain = 0.0, 0.0, 0.0
    for label, (shape, causal, window, cap, off, dtype,
                route) in BWD_CASES.items():
        opts = dict(causal=causal, window=window, softcap=cap, q_offset=off)
        q, k, v = flash_inputs(rng, shape, dtype, dev)
        dout = torch.from_numpy(rng.standard_normal(q.shape).astype(
            np.float32)).to(dev, dtype)
        before = (fa.BWD_LAUNCHES, fa.BWD_TC_LAUNCHES, fa.BWD_SIMT_LAUNCHES)
        got = fa.flash_attention_bwd(q, k, v, dout, **opts)
        torch.cuda.synchronize()
        tc = route == "wgmma"
        check((fa.BWD_LAUNCHES, fa.BWD_TC_LAUNCHES, fa.BWD_SIMT_LAUNCHES)
              == (before[0] + 1, before[1] + tc, before[2] + (not tc)),
              f"[train-lm] {label}: flash_attention_bwd did not launch once "
              f"on the {route} route")
        again = fa.flash_attention_bwd(q, k, v, dout, **opts)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"[train-lm] {label}: two calls of flash_attention_bwd differ")
        plain = kref.flash_attention_bwd_ref(q, k, v, dout, **opts)
        exact = attention_f64_grads(q, k, v, dout, **opts)
        parts = []
        for name, g, p_, x in zip(("dq", "dk", "dv"), got, plain, exact):
            check(g.dtype == dtype and g.shape == x.shape,
                  f"[train-lm] {label}: {name} is {g.dtype} {tuple(g.shape)}")
            e_k = (g.double() - x).abs().max().item()
            e_p = (p_.double() - x).abs().max().item()
            worst_plain = max(worst_plain,
                              (g.double() - p_.double()).abs().max().item())
            ratio = e_k / e_p if e_p > 0 else (0.0 if e_k == 0 else math.inf)
            worst, worst_ratio = max(worst, e_k), max(worst_ratio, ratio)
            parts.append(f"{name} {e_k:.3e} (plain {e_p:.3e}, {ratio:.2f}x)")
            check(e_k <= BWD_ERR_FACTOR * e_p,
                  f"[train-lm] {label}: flash_attention_bwd's {name} is "
                  f"{e_k:.3e} from float64, more than {BWD_ERR_FACTOR} x the "
                  f"plain version's {e_p:.3e}")
        print(f"[train-lm] flash_attention_bwd {label}, {str(dtype)[6:]}, "
              f"route {route}, two calls bit-equal: max abs error against "
              "float64 " + ", ".join(parts), flush=True)
        del q, k, v, dout, got, again, plain, exact
    free_card()
    return worst_plain, worst, worst_ratio


def bwd_work(q, k, causal=True, window=None, q_offset=0):
    """(operations, bytes) of one flash_attention_bwd call: the five
    products (q k^T, dout v^T, dS k, dS^T q, P^T dout) at 2 D operations
    each per reachable (row, key) pair; q, k, v, dout read and dq, dk, dv
    written once."""
    fwd_ops, _ = flash_work(q, k, causal, window, q_offset)
    return fwd_ops * 10.0 / 4.0, 3 * nbytes(q) + 4 * nbytes(k)


def bwd_simt(q, k, v, dout, grads, causal=True):
    """One call of the SIMT flash_attention_bwd library, launched directly
    and counted nowhere: the kernels that took bf16 at head dim 64, 96 and
    128 before the tensor-core route, timed beside it."""
    b, sq, h, d = q.shape
    stats = torch.empty((3, b, h, sq), dtype=torch.float32, device=q.device)
    launch("flash_attention_bwd", _build.load("flash_attention_bwd"),
           q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           dout.data_ptr(), *(g.data_ptr() for g in grads),
           stats.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d,
           int(q.dtype == torch.bfloat16), int(causal), 0, 0, d ** -0.5, 0.0)


def bwd_row(dev, launches, errors, card):
    """The kernels-line row of flash_attention_bwd: its time at each
    BWD_TIMED shape in bf16 on the tensor-core route by CUDA events and
    queued behind a spin, beside the plain backward, the backward of
    scaled_dot_product_attention (a yardstick only) and the bounds on the
    bf16 tensor cores and in fp32 FMA, and the SIMT route's time at
    SmolLM's shape on the same inputs; the row's own numbers are SmolLM's
    training shape's."""
    rng = np.random.default_rng(41)
    shapes = {}
    for key, shape in BWD_TIMED.items():
        causal = shape[6]
        q, k, v = flash_inputs(rng, shape, torch.bfloat16, dev)
        dout = torch.from_numpy(rng.standard_normal(q.shape).astype(
            np.float32)).to(dev, torch.bfloat16)
        check(fa.flash_route(q.dtype, q.shape[3]) == "wgmma",
              f"[time] flash_attention_bwd {key} is not on the wgmma route")

        def kernel():
            return fa.flash_attention_bwd(q, k, v, dout, causal=causal)
        t_k = time_ms(kernel, iters=10)
        d_k = queued_ms(kernel, iters=10)
        simt = {}
        if key == "smollm_train":
            grads = [torch.empty_like(t) for t in (q, k, v)]
            t_s = time_ms(lambda: bwd_simt(q, k, v, dout, grads, causal),
                          iters=3)
            d_s = queued_ms(lambda: bwd_simt(q, k, v, dout, grads, causal),
                            iters=3)
            simt = {"simt_ms": t_s, "simt_device_ms": d_s}
            del grads
        t_p = time_ms(lambda: kref.flash_attention_bwd_ref(
            q, k, v, dout, causal=causal), iters=3)
        leaves = [t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=True)
        dout_t = dout.transpose(1, 2).contiguous()

        def library():
            return torch.autograd.grad(out, leaves, dout_t,
                                       retain_graph=True)
        t_l = time_ms(library, iters=10)
        d_l = queued_ms(library, iters=10)
        ops, nb = bwd_work(q, k, causal)
        b_tc, by_tc = bound(ops, nb, BF16_FLOPS_PER_S)
        b_fma, by_fma = bound(ops, nb, FP32_FLOPS_PER_S)
        print(f"[time] flash_attention_bwd {key} {tuple(shape[:6])}, bf16: "
              f"kernel (wgmma route) {t_k:.4f} ms (queued behind a spin "
              f"{ms_or_not(d_k)}), plain {t_p:.4f} ms, library (autograd "
              f"through scaled_dot_product_attention, enable_gqa) "
              f"{t_l:.4f} ms (queued {ms_or_not(d_l)}); bound on the bf16 "
              f"tensor cores {b_tc:.4f} ms ({by_tc}), in fp32 FMA "
              f"{b_fma:.4f} ms ({by_fma}); {ops / t_k / 1e9:.1f} TFLOP/s of "
              f"the five products; " + (
                  f"the SIMT route (csrc/flash_attention_bwd.cu, launched "
                  f"directly) {t_s:.4f} ms (queued {ms_or_not(d_s)}); "
                  if simt else "") + card, flush=True)
        shapes[key] = {"shape": tuple(shape[:6]), "ms": t_k,
                       "device_ms": d_k, "plain_ms": t_p, "library_ms": t_l,
                       "library_device_ms": d_l, "bound_ms": b_tc,
                       "bound_by": by_tc, "bound_fp32_fma_ms": b_fma,
                       "bound_fp32_fma_by": by_fma,
                       "tflops": ops / t_k / 1e9, **simt}
        del q, k, v, dout, leaves, out, dout_t
        free_card()
    row = shapes["smollm_train"]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "flash_attention_bwd_tc.cu",
            "simt_source": "src/repro_torch/kernels/csrc/"
                           "flash_attention_bwd.cu",
            "replaces": "no TPU kernel; the reference's autodiff of "
                        "chunked_attention (src/repro/nn/attention.py:63)",
            "launches": launches, "max_abs_err": errors[0],
            "max_abs_err_vs_float64": errors[1],
            "error_ratio_to_plain_vs_float64": errors[2], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "per": "one causal bf16 backward call at SmolLM's training "
                   "microbatch (B 4, S 1024, 9/3 heads of 64)",
            "library": "torch.autograd.grad through torch.nn.functional."
                       "scaled_dot_product_attention (is_causal, enable_gqa),"
                       " a yardstick only",
            "device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"],
            "simt_ms": row["simt_ms"], **shapes}


# [train-lm]: SmolLM-135M at full width and depth trained on the card: the
# step's gradients against the same step with the plain attention (the LM
# phases' bf16 bar per leaf), then Trainer.run() with a failure injected
# and restored from the checkpoint before it
TRAIN_LM_ARCH = "smollm-135m"
TRAIN_LM = dict(steps=20, seq_len=1024, global_batch=8, microbatches=2,
                lr=1e-3, warmup_steps=5, ckpt_every=5)
TRAIN_LM_FAIL_AT, TRAIN_LM_RESTORED = 12, 10
TRAIN_GRAD_BAR = LM_LOGIT_BAR
# the __global__ names of flash_attention_bwd_tc.cu (the route every
# backward of the step takes), as torch.profiler reports them
BWD_KERNELS = ("flash_bwd_tc::dq_kernel", "flash_bwd_tc::dkv_kernel")


class RefOnCard:
    """Wraps the plain attention versions in `kernels.flash_attention` and
    `kernels.ref` for a block, counting their calls on CUDA tensors."""

    NAMES = ("flash_attention_ref", "flash_attention_bwd_ref")

    def __enter__(self):
        self.calls = Counter()
        self.saved = [(m, n, getattr(m, n)) for m in (fa, kref)
                      for n in self.NAMES]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._counting(name, fn))
        return self

    def _counting(self, name, fn):
        def counted(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                self.calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def train_lm_phase(dev, card):
    """[train-lm] steps 2 and 3: one full-width step through the kernels
    against the plain attention route, then Trainer.run() with a restart.
    Returns (flash_attention launches, flash_attention_bwd launches,
    timing)."""
    t_phase = time.perf_counter()
    tag = "train-lm"
    free_card()
    base = torch.cuda.memory_allocated()
    cfg = get_config(TRAIN_LM_ARCH)
    tc = trainer.TrainConfig(**TRAIN_LM)
    n_micro = tc.microbatches
    t0 = time.perf_counter()
    params = lm.lm_init(cfg, seed=tc.seed, device=dev)
    torch.cuda.synchronize()
    keys = [k for k, _ in tree_items(params)]
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.head_dim_}, vocab {cfg.vocab_size}; {cfg.param_count():,} "
          f"parameters in {len(keys)} float32 leaves (lm_init on the host "
          f"generator, {time.perf_counter() - t0:.1f} s), compute "
          f"{cfg.compute_dtype}, remat {cfg.remat}, loss_chunk "
          f"{cfg.loss_chunk}; batch {tc.global_batch} x {tc.seq_len} in "
          f"{n_micro} microbatches", flush=True)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
                         global_batch=tc.global_batch, seed=tc.seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(0).items()}

    # the step through the kernels, then through the plain attention
    torch.cuda.synchronize()
    reset_launches()
    fa.BWD_LAUNCHES = fa.BWD_TC_LAUNCHES = fa.BWD_SIMT_LAUNCHES = 0
    with RefOnCard() as ref_calls:
        loss_k, grads_k = trainer.loss_and_grads(cfg, params, batch, n_micro)
        torch.cuda.synchronize()
    launches, bwd_launches = launches_now(), fa.BWD_LAUNCHES
    bwd_routes = {"wgmma": fa.BWD_TC_LAUNCHES, "simt": fa.BWD_SIMT_LAUNCHES}
    fwd_passes = 2 if cfg.remat else 1      # remat recomputes each forward
    want = dict.fromkeys(COUNTERS, 0) | {
        "flash_attention": fwd_passes * cfg.num_layers * n_micro}
    print(f"[{tag}] one step through the kernels: loss {loss_k.item():.6f}; "
          f"launches {launches}, flash_attention_bwd {bwd_launches} "
          f"(expected {want}, {cfg.num_layers * n_micro}: the forward "
          f"{fwd_passes} times a layer, the backward once), by route "
          f"{bwd_routes}; plain "
          f"attention on CUDA tensors {dict(ref_calls.calls)}", flush=True)
    check(launches == want, f"[{tag}] launches {launches} != {want}")
    check(bwd_launches == cfg.num_layers * n_micro,
          f"[{tag}] flash_attention_bwd launched {bwd_launches} times")
    check(bwd_routes == {"wgmma": bwd_launches, "simt": 0},
          f"[{tag}] flash_attention_bwd's launches by route {bwd_routes}: "
          "every one must take the tensor-core route")
    check(not ref_calls.calls, f"[{tag}] the plain attention ran on the "
          f"card in the kernel route: {dict(ref_calls.calls)}")
    saved_fa = kops.flash_attention
    kops.flash_attention = kref.flash_attention_ref
    try:
        loss_p, grads_p = trainer.loss_and_grads(cfg, params, batch, n_micro)
        torch.cuda.synchronize()
    finally:
        kops.flash_attention = saved_fa
    worst, dead = 0.0, []
    for key, gk, gp in zip(keys, grads_k, grads_p):
        scale = gp.abs().max().item()
        rel = (gk - gp).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, rel)
        if gk.abs().max().item() == 0:
            dead.append(key)
        check(rel <= TRAIN_GRAD_BAR, f"[{tag}] gradient of {key}: max "
              f"|kernel - plain| is {rel:.3e} of max |plain|, above "
              f"{TRAIN_GRAD_BAR}")
    dloss = abs(loss_k.item() - loss_p.item())
    print(f"[{tag}] the same step through the plain attention: loss "
          f"{loss_p.item():.6f} (|difference| {dloss:.3e}); the largest "
          f"gradient difference, relative to the leaf's largest |entry|, "
          f"{worst:.3e} (bar {TRAIN_GRAD_BAR}) over {len(keys)} leaves; "
          f"leaves with no gradient: {dead}", flush=True)
    check(not dead, f"[{tag}] no gradient reached {dead}")
    check(dloss <= TRAIN_GRAD_BAR * abs(loss_p.item()),
          f"[{tag}] loss {loss_k.item()} against plain {loss_p.item()}")
    del grads_k, grads_p, batch
    free_card()

    # Trainer.run(): 20 steps, a failure at step 12, restored from 10
    failed = []

    def injector(step):
        if step == TRAIN_LM_FAIL_AT and not failed:
            failed.append(step)
            raise RuntimeError(f"injected failure at step {step}")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
        # the same init as the Trainer's own (lm_init from tc.seed)
        tr = trainer.Trainer(cfg, dataclasses.replace(tc, ckpt_dir=ckpt_dir),
                             params=params, failure_injector=injector,
                             device=dev)
        del params
        reset_launches()
        fa.BWD_LAUNCHES = fa.BWD_TC_LAUNCHES = fa.BWD_SIMT_LAUNCHES = 0
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_launches, run_bwd = launches_now(), fa.BWD_LAUNCHES
        run_routes = {"wgmma": fa.BWD_TC_LAUNCHES,
                      "simt": fa.BWD_SIMT_LAUNCHES}
        steps_run = len(tr.history)
        s = tr.summary()
        saved = tr.ckpt.saved_steps
    hist = [(r.step, round(r.loss, 4)) for r in tr.history]
    print(f"[{tag}] Trainer.run(): {s}; steps run {steps_run} (losses by "
          f"step {hist}); checkpoints at {saved}; {run_s:.1f} s in all; "
          f"launches {run_launches}, flash_attention_bwd {run_bwd} (by "
          f"route {run_routes})", flush=True)
    check(failed == [TRAIN_LM_FAIL_AT] and s["restarts"] == 1
          and s["steps"] == tc.steps, f"[{tag}] restart drill: {s}")
    check([r.step for r in tr.history] == list(range(TRAIN_LM_FAIL_AT))
          + list(range(TRAIN_LM_RESTORED, tc.steps)),
          f"[{tag}] the restart did not resume at step {TRAIN_LM_RESTORED}:"
          f" {[r.step for r in tr.history]}")
    check(all(math.isfinite(r.loss) for r in tr.history)
          and s["last_loss"] < s["first_loss"],
          f"[{tag}] the loss did not fall: {s}")
    per_pass = cfg.num_layers * n_micro
    check(run_launches == dict.fromkeys(COUNTERS, 0) | {
        "flash_attention": fwd_passes * per_pass * steps_run}
          and run_bwd == per_pass * steps_run
          and run_routes == {"wgmma": run_bwd, "simt": 0},
          f"[{tag}] Trainer launches {run_launches}, bwd {run_bwd} by route "
          f"{run_routes}")

    # one step's time by CUDA events, its device kernels by torch.profiler
    batch = tr.batch_at(0)

    def step():
        return tr.train_step(tr.params, tr.opt, batch, torch.tensor(0))
    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 3
    start.record()
    for _ in range(reps):
        step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / reps
    host_ops = {}
    ks = device_kernels(step, host=host_ops)
    busy_ms = sum(ms for ms, _ in ks.values())
    n_kernels = sum(n for _, n in ks.values())
    n_aten = sum(n for name, (_, n) in host_ops.items()
                 if name.startswith("aten::"))
    top_host = sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:8]
    bwd_ms = sum(ms for name, (ms, _) in ks.items()
                 if any(k in name for k in BWD_KERNELS))
    fwd_ms = sum(ms for name, (ms, _) in ks.items()
                 if any(k in name for k in FLASH_KERNELS))
    top = sorted(ks.items(), key=lambda kv: -kv[1][0])[:8]
    tokens = tc.global_batch * tc.seq_len
    seen = busy_ms > 0                 # else the profiler saw no kernel
    timing = {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
              "device_busy_ms": busy_ms if seen else None,
              "idle_share": max(0.0, 1.0 - busy_ms / step_ms) if seen
              else None,
              "bwd_kernel_ms": bwd_ms if seen else None,
              "bwd_share": bwd_ms / busy_ms if seen else None,
              "fwd_kernel_ms": fwd_ms if seen else None,
              "fwd_share": fwd_ms / busy_ms if seen else None,
              "device_kernels": n_kernels, "host_aten_calls": n_aten,
              "first_loss": s["first_loss"], "last_loss": s["last_loss"],
              "restarts": s["restarts"], "run_s": run_s,
              "mean_step_s": s["mean_step_s"]}
    print(f"[{tag}] one training step ({tc.global_batch} x {tc.seq_len} "
          f"tokens, {n_micro} microbatches, AdamW; CUDA events over "
          f"{reps}): {step_ms:.2f} ms, {timing['tokens_per_s']:.0f} "
          f"tokens/s; " + (f"device busy {busy_ms:.2f} ms in {n_kernels} "
          f"kernels (torch.profiler), "
          f"idle share {timing['idle_share']:.3f}; flash_attention_bwd "
          f"{bwd_ms:.2f} ms ({timing['bwd_share']:.3f} of the device "
          f"time), flash_attention {fwd_ms:.2f} ms "
          f"({timing['fwd_share']:.3f})" if seen else "device time not "
          "measured (the profiler saw no kernel)") + "; largest kernels "
          + ", ".join(
              f"{name[:60]} {ms:.2f} ms x{n}" for name, (ms, n) in top)
          + f"; {card}", flush=True)
    print(f"[{tag}] the same step's host side (torch.profiler, which slows "
          f"it): {n_aten} aten calls; largest own CPU times " + ", ".join(
              f"{name[:50]} {ms:.1f} ms x{n}" for name, (ms, n) in top_host)
          + f"; {card}", flush=True)
    del tr, batch
    phase_memory(tag, t_phase, base, timing)
    return (launches["flash_attention"] + run_launches["flash_attention"],
            bwd_launches + run_bwd, timing)


MESH_LM_ARCH = "smollm-135m"
MESH_LM = dict(steps=3, seq_len=1024, global_batch=8, microbatches=2,
               lr=1e-3)
MESH_LM_SHAPES = ((1, 2), (2, 1), (2, 2))
MESH_LM_SERVE = dict(requests=4, length=256, max_new=8)
MESH_LM_TIMEOUT_S = 420
MESH_LM_BAR = LM_LOGIT_BAR          # of the loss, of a leaf's largest
#                                     first moment and update
# the largest share of a leaf's entries whose update may differ from the
# single process's by more than MESH_LM_BAR of the leaf's largest update
MESH_LM_SHARE = 0.05
MESH_LM_ARGS = ()                   # more launcher arguments (a rehearsal's)
DRYRUN_TIMEOUT_S = 600


def mesh_name(shape):
    return "x".join(map(str, shape))


def mesh_lm_train(shape, dev, steps, ckpt_dir, every):
    """`launch/train.py --mesh` on gloo ranks sharing this card: each
    rank's JSON record."""
    tc = MESH_LM
    args = ["--arch", MESH_LM_ARCH, "--mesh", mesh_name(shape), "--steps",
            str(steps), "--batch", str(tc["global_batch"]), "--seq",
            str(tc["seq_len"]), "--microbatches", str(tc["microbatches"]),
            "--lr", str(tc["lr"]), "--ckpt-dir", ckpt_dir, "--ckpt-every",
            str(every), "--backend", "gloo", "--device", str(dev),
            *MESH_LM_ARGS]
    return [ss.last_json(o) for o in ss.spawn_local(
        math.prod(shape), args, MESH_LM_TIMEOUT_S,
        program=("-m", "repro_torch.launch.train"))]


def mesh_state_readings(ref, init, got):
    """A mesh run's state against the single process's, leaf by leaf.
    `ref` and `got` map "params/<leaf>" and "opt/m/<leaf>" to CPU
    tensors, `init` maps "<leaf>" to the parameters before step 1. The
    readings, each its worst (value, leaf):
      m:     max |difference| of AdamW's first moment over the leaf's
             max |m|. m is a fixed positive sum of the steps' clipped
             gradients, so §2's bar on a gradient holds it; AdamW's
             division by each entry's own RMS comes after it;
      share: the share of entries whose parameter differs by more than
             MESH_LM_BAR of the leaf's largest update;
      moved: max |difference| of the parameters."""
    worst = {"m": (0.0, None), "share": (0.0, None), "moved": (0.0, None)}

    def keep(name, value, key):
        if value > worst[name][0]:
            worst[name] = (value, key)
    for key, p0 in init.items():
        want, have = ref[f"params/{key}"], got[f"params/{key}"]
        top = (want - p0).abs().max().clamp_min(1e-30)
        diff = (have - want).abs()
        keep("moved", diff.max().item(), key)
        keep("share", (diff > MESH_LM_BAR * top).float().mean().item(), key)
        m_want = ref[f"opt/m/{key}"]
        keep("m", ((got[f"opt/m/{key}"] - m_want).abs().max()
                   / m_want.abs().max().clamp_min(1e-30)).item(), key)
    return worst


def mesh_state_faults(worst, adam_bound):
    """The readings of `mesh_state_readings` beyond their limits."""
    limits = {"m": MESH_LM_BAR, "share": MESH_LM_SHARE, "moved": adam_bound}
    return [f"{name}: {worst[name][0]:.3e} at {worst[name][1]} beyond "
            f"{limit:.3e}" for name, limit in limits.items()
            if worst[name][0] > limit]


def fmt_state(worst):
    v = {k: f"{x:.3e} ({leaf})" for k, (x, leaf) in worst.items()}
    return (f"first moments within {v['m']} of a leaf's largest, "
            f"{v['share']} of a leaf's entries beyond {MESH_LM_BAR} of its "
            f"largest update, parameters within {v['moved']}")


def mesh_lm_phase(dev, card):
    """[mesh-lm]: SmolLM-135M trained and served on meshes of gloo ranks
    sharing this card, against the single-process steps on the card.
    Returns the ranks' (flash_attention, flash_attention_bwd) launches."""
    t_phase = time.perf_counter()
    tag = "mesh-lm"
    free_card()
    base = torch.cuda.memory_allocated()
    cfg = get_config(MESH_LM_ARCH)
    tc = trainer.TrainConfig(**MESH_LM)
    n_micro = tc.microbatches
    # the single-process step on the card: the launcher's settings
    params = lm.lm_init(cfg, seed=tc.seed, device=dev)
    opt = trainer.init_opt_state(params)
    step_fn = trainer.make_train_step(cfg, tc)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
                         global_batch=tc.global_batch, seed=tc.seed)
    ref_loss, ref_norm, ref_ms = [], [], []
    for step in range(tc.steps):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in stream.batch_at(step).items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, metrics = step_fn(params, opt, batch,
                                       torch.tensor(step))
        end.record()
        end.synchronize()
        ref_ms.append(start.elapsed_time(end))
        ref_loss.append(float(metrics["loss"]))
        ref_norm.append(float(metrics["grad_norm"]))
    ref_state = {f"params/{k}": t.detach().cpu()
                 for k, t in tree_items(params)}
    ref_state.update({f"opt/m/{k}": t.cpu()
                      for k, t in tree_items(opt["m"])})
    init_params = {k: t.cpu() for k, t in tree_items(
        lm.lm_init(cfg, seed=tc.seed, device="cpu"))}
    adam_bound = 2 * sum(float(trainer.linear_warmup_cosine(
        s_, base_lr=tc.lr, warmup_steps=max(1, tc.steps // 4)
        if tc.warmup_steps >= tc.steps else tc.warmup_steps,
        total_steps=tc.steps)) for s_ in range(tc.steps))
    full_bytes = sum(t.numel() * t.element_size()
                     for t in init_params.values())
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, batch
    free_card()
    print(f"[{tag}] single process: losses {ref_loss}, gradient norms "
          f"{ref_norm}, ms a step "
          f"{[round(m, 1) for m in ref_ms]} (CUDA events), parameters "
          f"{full_bytes / 1e9:.3f} GB float32, peak card memory "
          f"{ref_peak:.2f} GB; {card}", flush=True)

    per_step = 2 * cfg.num_layers * n_micro if cfg.remat else (
        cfg.num_layers * n_micro)
    fwd_total = bwd_total = 0

    def rank_checks(label, o, steps):
        nonlocal fwd_total, bwd_total
        l = o["launches"]
        want_fwd, want_bwd = per_step * steps, cfg.num_layers * n_micro * steps
        check(l["LAUNCHES"] == l["TC_LAUNCHES"] == want_fwd
              and l["SIMT_LAUNCHES"] == 0,
              f"[{tag}] {label} rank {o['rank']}: flash_attention launches "
              f"{l} != {want_fwd} on the tensor-core route")
        check(l["BWD_LAUNCHES"] == l["BWD_TC_LAUNCHES"] == want_bwd
              and l["BWD_SIMT_LAUNCHES"] == 0,
              f"[{tag}] {label} rank {o['rank']}: flash_attention_bwd "
              f"launches {l} != {want_bwd} on the tensor-core route")
        fwd_total += l["LAUNCHES"]
        bwd_total += l["BWD_LAUNCHES"]

    def state_of(ckpt_dir, step):
        """The parameters and first moments a mesh run saved at `step`."""
        template = _cpu_like(lm.lm_init(cfg, device="meta"))
        got = restore_checkpoint(ckpt_dir, {"params": template,
                                            "opt": {"m": template}},
                                 step=step)[1]
        return dict(tree_items(got))

    # the check refuses, by the reading named, states a faulty mesh step
    # would leave
    planted = {
        "the parameters left at their init": ("share", lambda k, t: (
            init_params[k[7:]] if k.startswith("params/") else t)),
        "the update reversed": ("share", lambda k, t: (
            2 * init_params[k[7:]] - t if k.startswith("params/") else t)),
        "the first moment halved (one of two data ranks' gradient)":
            ("m", lambda k, t: t / 2 if k.startswith("opt/m/") else t)}
    for what, (by, plant) in planted.items():
        worst = mesh_state_readings(
            ref_state, init_params,
            {k: plant(k, t) for k, t in ref_state.items()})
        refused = [f.split(":")[0] for f in mesh_state_faults(worst,
                                                             adam_bound)]
        print(f"[{tag}] planted, {what}: {fmt_state(worst)}; refused by "
              f"{refused}", flush=True)
        check(by in refused, f"[{tag}] the state check's {by} reading "
              f"accepts {what}")

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for shape in MESH_LM_SHAPES:
            label = mesh_name(shape)
            t0 = time.perf_counter()
            outs = mesh_lm_train(shape, dev, tc.steps, f"{tmp}/{label}", 2)
            run_s = time.perf_counter() - t0
            losses = [[l for _, l in o["losses"]] for o in outs]
            check(all(l == losses[0] for l in losses), f"[{tag}] {label}: "
                  f"the ranks' losses differ: {losses}")
            check([s for s, _ in outs[0]["losses"]] == list(range(tc.steps)),
                  f"[{tag}] {label}: steps {outs[0]['losses']}")
            for got, want in zip(losses[0], ref_loss):
                check(abs(got - want) <= MESH_LM_BAR * abs(want),
                      f"[{tag}] {label}: loss {got} against the single "
                      f"process's {want}")
            if shape[0] == 1:
                check(losses[0][0] == ref_loss[0], f"[{tag}] {label}: the "
                      f"first loss {losses[0][0]} is not the single "
                      f"process's {ref_loss[0]} bit for bit")
            for o in outs:
                rank_checks(label, o, tc.steps)
            norms = [n for _, n in outs[0]["grad_norms"]]
            for got, want in zip(norms, ref_norm):
                check(abs(got - want) <= MESH_LM_BAR * abs(want),
                      f"[{tag}] {label}: gradient norm {got} against the "
                      f"single process's {want}")
            worst = mesh_state_readings(
                ref_state, init_params, state_of(f"{tmp}/{label}", tc.steps))
            print(f"[{tag}] {label}: {len(outs)} gloo ranks on {dev} in "
                  f"{run_s:.1f} s; losses {losses[0]} (single process "
                  f"{ref_loss}); gradient norms {norms}; after {tc.steps} "
                  f"steps {fmt_state(worst)}", flush=True)
            faults = mesh_state_faults(worst, adam_bound)
            check(not faults, f"[{tag}] {label}: {faults}")
            for o in outs:
                ms = o["step_ms"][1:]
                mean_ms = sum(ms) / len(ms)
                ar = o["allreduce_ms"]
                mean_ar = None if ar is None else sum(ar[1:]) / len(ar[1:])
                peak = o["peak_bytes"]
                print(f"[{tag}] {label} rank {o['rank']} {o['coords']}: "
                      f"{mean_ms:.1f} ms a step (CUDA events, steps 2-"
                      f"{tc.steps}; step 1 {o['step_ms'][0]:.1f} ms), of it "
                      + ("all_reduce not measured" if mean_ar is None else
                         f"all_reduce {mean_ar:.1f} ms (share "
                         f"{mean_ar / mean_ms:.3f})")
                      + f"; {o['allreduce_bytes'] / 1e9:.3f} GB handed to "
                      f"all_reduce in {o['allreduce_calls']} calls over "
                      f"{tc.steps} steps; parameter blocks "
                      f"{o['param_block_bytes'] / 1e9:.3f} GB (of "
                      f"{full_bytes / 1e9:.3f}); peak card memory "
                      + ("not measured" if peak is None else
                         f"{peak / 1e9:.2f} GB")
                      + f"; launches {o['launches']}; {card}", flush=True)

        # (2, 1)'s checkpoint of step 2 continues on (1, 2)
        ckpt_dir = f"{tmp}/resume"
        os.makedirs(ckpt_dir)
        shutil.copytree(f"{tmp}/2x1/step_{2:010d}",
                        f"{ckpt_dir}/step_{2:010d}")
        outs = mesh_lm_train((1, 2), dev, tc.steps, ckpt_dir, 100)
        for o in outs:
            check(o["start"] == 2 and [s for s, _ in o["losses"]] == [2],
                  f"[{tag}] resume: rank {o['rank']} started at "
                  f"{o['start']}, steps {o['losses']}")
            got = o["losses"][0][1]
            check(abs(got - ref_loss[2]) <= MESH_LM_BAR * abs(ref_loss[2]),
                  f"[{tag}] resume: step 3's loss {got} against the single "
                  f"process's {ref_loss[2]}")
            rank_checks("resume 1x2", o, 1)
        print(f"[{tag}] resume: 2 steps on (2, 1) saved at step 2, step 3 "
              f"restored on (1, 2): loss {outs[0]['losses'][0][1]} "
              f"(single process {ref_loss[2]})", flush=True)

    # a greedy batch on (1, 2) against the single process's tokens
    sv = MESH_LM_SERVE
    args = ["--arch", MESH_LM_ARCH, "--mesh", "1x2", "--requests",
            str(sv["requests"]), "--buckets", str(sv["length"]),
            "--max-new", str(sv["max_new"]), "--backend", "gloo",
            "--device", str(dev), *MESH_LM_ARGS]
    outs = [ss.last_json(o) for o in ss.spawn_local(
        2, args, MESH_LM_TIMEOUT_S, program=("-m", "repro_torch.launch.serve"))]
    sparams = lm.lm_init(cfg, seed=0, device=dev, dtype=cfg.dtype)
    toks = torch.from_numpy(serve_launch.prompts(
        cfg, sv["requests"], sv["length"], 0)).to(dev)
    with torch.no_grad():
        want = lm.greedy_generate(sparams, cfg, toks, steps=sv["max_new"],
                                  max_len=sv["length"] + sv["max_new"])
    del sparams
    for o in outs:
        check(o["tokens"] == want.tolist(), f"[{tag}] serve 1x2 rank "
              f"{o['rank']}: tokens {o['tokens']} != the single process's "
              f"{want.tolist()}")
        l = o["launches"]
        check(l["LAUNCHES"] == l["TC_LAUNCHES"] == cfg.num_layers,
              f"[{tag}] serve 1x2 rank {o['rank']}: prefill launches {l}")
        fwd_total += l["LAUNCHES"]
        dec = o["decode_step_ms"][1:]
        print(f"[{tag}] serve 1x2 rank {o['rank']}: greedy tokens equal the "
              f"single process's; prefill {o['prefill_ms']:.1f} ms, a decode "
              f"step {sum(dec) / len(dec):.1f} ms (CUDA events), "
              f"{o['allreduce_bytes'] / 1e9:.3f} GB handed to all_reduce; "
              f"{card}", flush=True)
    timing = {}
    phase_memory(tag, t_phase, base, timing)
    return fwd_total, bwd_total


def _cpu_like(tree):
    """Empty CPU tensors of `tree`'s shapes and dtypes (a restore's
    template)."""
    return tree_replace(tree, {k: torch.empty(t.shape, dtype=t.dtype)
                               for k, t in tree_items(tree)})


def dryrun_phase(card):
    """[dryrun]: every arch x shape x production mesh on meta tensors, in
    a subprocess over the host's cores; exits 0, no FAILED row."""
    t0 = time.perf_counter()
    jobs = os.cpu_count() or 8
    out = ROOT / "build" / "dryrun.jsonl"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
           "--mesh", "both", "--jobs", str(jobs), "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=DRYRUN_TIMEOUT_S, cwd=ROOT)
    took = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    table = lines[lines.index("") + 1:] if "" in lines else lines[-90:]
    for line in table:
        print(f"[dryrun] {line}")
    check(proc.returncode == 0, f"[dryrun] exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    failed = [r for r in rows if r["status"] == "FAILED"]
    check(not failed and len(rows) == 80, f"[dryrun] {len(rows)} rows, "
          f"FAILED: {[(r['arch'], r['shape'], r['mesh']) for r in failed]}")
    print(f"[dryrun] {len(rows)} cells ({sum(r['status'] == 'ok' for r in rows)}"
          f" ok) in {took:.1f} s on {jobs} host processes (meta tensors: no "
          f"card); priced at core/costs.py's H100 rates; {card}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    card = card_line()

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    variants = start_variants()
    try:
        logs = _build.build()
    finally:                            # no nvcc outlives the script
        variant_logs = {key: proc.communicate()[0]
                        for key, (proc, _) in variants.items()}
    variant_fns = bind_variants(variants, variant_logs)
    print(f"[build] {len(logs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"[build] {lib}: {line.strip()}")
    for (lib, label), log in variant_logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and "Used" in line:
                print(f"[build] {lib} variant ({label}): {line.strip()}")
    # the redesigned kernels run on the tensor cores: their SASS says so
    for lib, patterns in SASS.items():
        counts = _build.sass_counts(lib, patterns)
        print(f"[sass] {lib}: {counts} (cuobjdump -sass)", flush=True)
        check(all(counts.values()), f"{lib}: an instruction of {list(patterns)}"
              f" is missing from its SASS: {counts}")

    # ------------------------------------------------- 2. kernel checks
    rng = np.random.default_rng(0)
    cora, others = graphs()
    batch_graphs = [cora, others[3], others[4], cora]        # 3072 bucket
    pgs = [pad_graph(g, capacity=CAP) for g in batch_graphs]
    adj = torch.from_numpy(np.stack([p.norm_adj for p in pgs])).to(dev)
    x1 = torch.from_numpy(np.stack([pad_to(p.features, (CAP, FIN_PAD))
                                    for p in pgs])).to(dev)
    w1_np, w2_np = glorot(rng, 1433, 64), glorot(rng, 64, 7)
    b1_np = (0.1 * rng.standard_normal(64)).astype(np.float32)
    b2_np = (0.1 * rng.standard_normal(7)).astype(np.float32)
    w1 = torch.from_numpy(pad_to(w1_np, (FIN_PAD, TILE))).to(dev)
    w2 = torch.from_numpy(pad_to(w2_np, (TILE, TILE))).to(dev)
    b1 = torch.from_numpy(pad_to(b1_np, (TILE,))).to(dev)
    b2 = torch.from_numpy(pad_to(b2_np, (TILE,))).to(dev)
    h1 = bm.block_matmul_plain(x1, w1)
    x2 = fl.fused_gcn_dense_plain(adj, x1, w1, b1, "relu")   # layer-2 input
    h2 = bm.block_matmul_plain(x2, w2)
    products = {"L1 X@W": (x1, w1), "L1 A@H": (adj, h1),
                "L2 X@W": (x2, w2), "L2 A@H": (adj, h2)}
    layers = {"L1 relu": (adj, x1, w1, b1, "relu"),
              "L2 none": (adj, x2, w2, b2, "none")}
    err = {"block_matmul": 0.0, "fused_gcn_dense": 0.0}

    def compare(kernel, label, run, want):
        # the kernels match their plain versions to the last few bits (the
        # fp32 SIMT tiles sum in cuBLAS's order and may equal it bit for
        # bit), so equal outputs alone would not show that the kernel ran:
        # its counter must move too
        mod, attr = COUNTERS[kernel]
        before = getattr(mod, attr)
        got = run()
        check(getattr(mod, attr) == before + 1,
              f"{kernel} {label}: no launch")
        torch.cuda.synchronize()
        diff = (got - want).abs()
        rel = (diff / want.abs().clamp_min(1e-6)).max().item()
        print(f"[check] {kernel} {label} {tuple(got.shape)}: max_abs_err "
              f"{diff.max().item():.3e} max_rel_err {rel:.3e} "
              f"(tol rtol={TOL['rtol']} atol={TOL['atol']})", flush=True)
        torch.testing.assert_close(got, want, **TOL)
        err[kernel] = max(err[kernel], diff.max().item())
        return got

    for label, (a, b) in products.items():
        compare("block_matmul", label, lambda: bm.block_matmul(a, b),
                bm.block_matmul_plain(a, b))
    # 3xTF32 keeps fp32 accuracy: against a float64 product of the same
    # inputs, the largest error relative to the largest |C| is at most
    # twice that of torch.matmul in fp32 (TF32 off)
    f64_err = {}
    for label, (a, b) in products.items():
        want64 = torch.matmul(a.double(), b.double())
        top = want64.abs().max()
        e_k, e_t = (((got.double() - want64).abs().max() / top).item()
                    for got in (bm.block_matmul(a, b), torch.matmul(a, b)))
        f64_err[label] = (e_k, e_t)
        print(f"[check] block_matmul {label} against float64: relative "
              f"error {e_k:.3e}, torch.matmul's {e_t:.3e} (bar: twice "
              f"torch.matmul's)", flush=True)
        check(e_k <= 2 * e_t, f"block_matmul {label}: error {e_k} against "
              f"float64 exceeds twice torch.matmul's {e_t}")
        del want64
    # the layer at every activation; each also against the same layer in
    # float64, at most twice the plain version's (cuBLAS's fp32) error
    dense_checks = {"L1 none": (adj, x1, w1, b1, "none"), **layers,
                    "L1 elu": (adj, x1, w1, b1, "elu")}
    dense_f64_err = {}
    for label, args in dense_checks.items():
        got = compare("fused_gcn_dense", label,
                      lambda: fl.fused_gcn_dense(*args),
                      fl.fused_gcn_dense_plain(*args))
        want64 = fl.fused_gcn_dense_plain(*(t.double() for t in args[:4]),
                                          args[4])
        top = want64.abs().max()
        e_k, e_t = (((t.double() - want64).abs().max() / top).item()
                    for t in (got, fl.fused_gcn_dense_plain(*args)))
        dense_f64_err[label] = (e_k, e_t)
        print(f"[check] fused_gcn_dense {label} against float64: relative "
              f"error {e_k:.3e}, the plain version's (cuBLAS) {e_t:.3e} "
              f"(bar: twice the plain version's)", flush=True)
        check(e_k <= 2 * e_t, f"fused_gcn_dense {label}: error {e_k} against"
              f" float64 exceeds twice the plain version's {e_t}")
        del want64

    # the int8 tier at the same shapes, with a real calibration on Cora
    cfg = gcn("cora")
    params = params_from_jax({"l1": {"w": w1_np, "b": b1_np},
                              "l2": {"w": w2_np, "b": b2_np}}, device=dev)
    cal = calibrate_tier(params, cfg,
                         torch.from_numpy(pgs[0].features).to(dev),
                         build_operands(pgs[0], cfg, device=dev))
    tops = derive_tier_operands(adj)
    aq, a_scale = tops.agg_aq, tops.agg_a_scale
    ones = torch.ones(TILE, device=dev)

    def pad_q(ql, rows):
        wq = torch.zeros(rows, TILE, dtype=torch.int8, device=dev)
        wq[:ql.wq.shape[0], :ql.wq.shape[1]] = ql.wq
        ws = torch.zeros(TILE, device=dev)
        ws[:ql.w_scale.numel()] = ql.w_scale
        return wq, ws, ql.x_scale.reshape(1)

    wq1, ws1, xs1 = pad_q(cal["l1"], FIN_PAD)
    wq2, ws2, xs2 = pad_q(cal["l2"], TILE)
    hs1, hs2 = cal["agg1_h"].reshape(1), cal["agg2_h"].reshape(1)
    xq1 = im.quantize_s8(x1, xs1)
    hq1 = im.quantize_s8(im.int8_matmul_plain(xq1, wq1, xs1, ws1), hs1)
    q1 = (x1, wq1, (xs1 * ws1).reshape(1, -1), xs1, hs1, aq, a_scale, b1)
    x2q = fl.fused_gcn_int8_plain(*q1, "relu")           # layer-2 input
    xq2 = im.quantize_s8(x2q, xs2)
    hq2 = im.quantize_s8(im.int8_matmul_plain(xq2, wq2, xs2, ws2), hs2)
    q2 = (x2q, wq2, (xs2 * ws2).reshape(1, -1), xs2, hs2, aq, a_scale, b2)
    i8_products = {"L1 Xq@Wq": (xq1, wq1, xs1, ws1),
                   "L1 Aq@Hq": (aq, hq1, 1.0, ones),
                   "L2 Xq@Wq": (xq2, wq2, xs2, ws2),
                   "L2 Aq@Hq": (aq, hq2, 1.0, ones)}
    i8_layers = {"L1 relu": (*q1, "relu"), "L2 none": (*q2, "none")}
    err.update({"int8_matmul": 0.0, "fused_gcn_int8": 0.0})

    def compare_exact(kernel, label, run, want):
        mod, attr = COUNTERS[kernel]
        before = getattr(mod, attr)
        got = run()
        check(getattr(mod, attr) == before + 1, f"{kernel} {label}: no launch")
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        print(f"[check] {kernel} {label} {tuple(got.shape)}: max_abs_err "
              f"{diff:.3e} (must be bit-equal)", flush=True)
        check(torch.equal(got, want), f"{kernel} {label}: differs from its "
              f"plain version by up to {diff}")
        err[kernel] = max(err[kernel], diff)

    for label, args in i8_products.items():
        compare_exact("int8_matmul", label, lambda: im.int8_matmul(*args),
                      im.int8_matmul_plain(*args))
    for label, args in i8_layers.items():
        compare_exact("fused_gcn_int8", label,
                      lambda: fl.fused_gcn_int8(*args),
                      fl.fused_gcn_int8_plain(*args))

    # the GraSp kernels at both buckets' serving shapes and real budgets:
    # the 4-graph batches of the serve-grasp phase below (junk slots repeat
    # a graph), layer 1 (hidden 64 -> 128) and layer 2 (classes 7 -> 128)
    err.update({"bitmap_spmm": 0.0, "fused_gcn_grasp": 0.0})
    grasp_batches_in = {1024: (300, 700, 1000, 700),
                        3072: (1800, 2700, 1800, 2700)}
    grasp_cases = {}
    for gcap, sizes in grasp_batches_in.items():
        adj_g, xg1, st = grasp_batch([clustered(n) for n in sizes], gcap, dev)
        nan_blocks = nan_tail(*st)
        hg1 = bm.block_matmul_plain(xg1, w1)
        xg2 = fl.fused_gcn_grasp_plain(*st, xg1, w1, b1, "relu")
        hg2 = bm.block_matmul_plain(xg2, w2)
        print(f"[check] grasp batch at {gcap}: graphs {sizes}, budget "
              f"{st[1].shape[-1]}, real blocks {int(st[2].sum())} of "
              f"{st[1].numel()} list entries", flush=True)
        grasp_cases[gcap] = dict(adj=adj_g, st=st, h1=hg1, h2=hg2, x1=xg1,
                                 x2=xg2)
        for label, h in (("L1 A@H", hg1), ("L2 A@H", hg2)):
            want_g = bs.bitmap_spmm_plain(*st, h)
            compare("bitmap_spmm", f"{gcap} {label}",
                    lambda: bs.bitmap_spmm(*st, h), want_g)
            compare("bitmap_spmm", f"{gcap} {label} NaN tail",
                    lambda: bs.bitmap_spmm(nan_blocks, *st[1:], h), want_g)
        for label, xs, ws, bsv, act in (
                ("L1 none", xg1, w1, b1, "none"),
                ("L1 relu", xg1, w1, b1, "relu"),
                ("L1 elu", xg1, w1, b1, "elu"),
                ("L2 none", xg2, w2, b2, "none")):
            want_g = fl.fused_gcn_grasp_plain(*st, xs, ws, bsv, act)
            compare("fused_gcn_grasp", f"{gcap} {label}",
                    lambda: fl.fused_gcn_grasp(*st, xs, ws, bsv, act), want_g)
            if act != "elu":
                compare("fused_gcn_grasp", f"{gcap} {label} NaN tail",
                        lambda: fl.fused_gcn_grasp(nan_blocks, *st[1:], xs,
                                                   ws, bsv, act), want_g)

    # -------------------------------------------------------- 3. serving
    base = dict(stagr=True, grad_dynamic=True, graphsplit=True)
    eng = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=LADDER),
                                      batch_slots=SLOTS, return_logits=True),
                     seed=0, device=dev)
    eng.register_model("gcn", cfg, params, fusion="layer")
    eng.register_model("gcn_mm", cfg, params, techniques=Techniques(
        **base, use_pallas=True))
    eng.register_model("gcn_q", cfg, params, tiers=("fp32", "int8"),
                       default_tier="int8", fusion="layer")
    eng.register_model("gcn_qmm", cfg, params, tiers={
        "fp32": Techniques(**base, use_pallas=True),
        "int8": Techniques(**base, quantgr=True, use_pallas=True)},
        default_tier="int8")
    t0 = time.perf_counter()
    blobs = eng.warmup()
    print(f"[serve] warmup: {blobs} plan signatures in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for model in ("gcn_q", "gcn_qmm"):
        deltas = eng.calibrate(model, cora)
        print(f"[serve] calibrated {model} on Cora: accuracy_delta_vs_fp32 "
              f"{deltas}", flush=True)

    reset_launches()                        # the fp32 path starts here
    t_serve = time.perf_counter()
    for model in ("gcn", "gcn_mm"):
        for g in [cora] + others:
            eng.submit(g, model=model)
    gid = eng.attach(planetoid_like(num_nodes=900, num_edges=1800,
                                    num_feats=1433, num_classes=7, seed=11),
                     model="gcn")
    eng.query(gid)
    eng.query(gid)
    intake_s = time.perf_counter() - t_serve   # host prep + operand upload
    per_key = Counter((r.model, r.bucket, r.fusion) for r in eng.queue)
    done = eng.run()
    serve_s = time.perf_counter() - t_serve
    launches = launches_now()

    batches = {k: -(-n // SLOTS) for k, n in per_key.items()}
    want = {"block_matmul": 4 * sum(v for k, v in batches.items()
                                    if k[0] == "gcn_mm" and k[2] == "none"),
            "fused_gcn_dense": 2 * sum(v for k, v in batches.items()
                                       if k[2] == "layer"),
            "int8_matmul": 0, "fused_gcn_int8": 0, "bitmap_spmm": 0,
            "fused_gcn_grasp": 0} | dict.fromkeys(GAT_KERNELS + SAGE_KERNELS + LM_KERNELS,
                                                   0)
    print(f"[serve] {len(done)} requests in {sum(batches.values())} batches "
          f"{sorted(batches.items())}; launches {launches}, expected {want}",
          flush=True)
    check(eng.metrics["batches"] == sum(batches.values()),
          f"{eng.metrics['batches']} batches dispatched, expected "
          f"{sum(batches.values())}")
    check(launches == want, f"kernel launches {launches} != {want}")
    check(launches["block_matmul"] > 0 and launches["fused_gcn_dense"] > 0,
          f"a kernel of the path never launched: {launches}")
    check(len(done) == 2 * (1 + len(PLANETOID_SIZES)) + 2,
          f"{len(done)} requests finished")
    eng.assert_warm()
    # CacheG: each one-shot request and the attached graph's first query
    # ship their compact form; the second query is a hit and ships nothing
    burst_h2d = 2 * sum(compact_bytes(eng.sc.ladder.bucket_for(g.num_nodes))
                        for g in [cora] + others) + compact_bytes(1024)
    s = eng.summary()
    print(f"[serve] operand_bytes_h2d {s['operand_bytes_h2d']} (compact "
          f"forms: {burst_h2d}; a cap-3072 request {compact_bytes(3072)}, "
          f"a cap-1024 one {compact_bytes(1024)}); cache hits "
          f"{s['operand_cache_hits']}, misses {s['operand_cache_misses']}, "
          f"cacheg_fallbacks {s['cacheg_fallbacks']}", flush=True)
    check(s["operand_bytes_h2d"] == burst_h2d,
          f"operand_bytes_h2d {s['operand_bytes_h2d']} != {burst_h2d}")
    check((s["operand_cache_misses"], s["operand_cache_hits"],
           s["cacheg_fallbacks"]) == (1, 1, 0),
          "the attached graph's second query was not a hit, or a request "
          "fell back to the eager path")

    fp32_done = list(done)
    agree = []
    for r in fp32_done:
        n = r.pg.num_nodes
        check(r.logits is not None and r.logits.shape == (n, 7)
              and np.isfinite(r.logits).all(),
              f"request {r.uid}: logits missing, misshapen or not finite")
        ref = gcn_plain(r, params, dev)
        torch.testing.assert_close(torch.from_numpy(r.logits), ref, **TOL)
        agree.append(float((r.preds == ref.argmax(-1).numpy()).mean()))
    s = eng.summary()
    print(f"[serve] logits of all {len(done)} requests match the plain "
          f"forward (rtol={TOL['rtol']} atol={TOL['atol']}); argmax "
          f"agreement min {min(agree):.4f}", flush=True)
    summary_keys = ("requests", "batches", "batch_occupancy",
                    "p50_latency_ms", "p99_latency_ms", "throughput_rps",
                    "device_busy_s", "device_idle_fraction",
                    "operand_bytes_h2d", "operand_cache_hits",
                    "operand_cache_misses", "cacheg_fallbacks",
                    "compiled_blobs", "tier_fallbacks")
    print("[serve] summary " + json.dumps(
        {k: s[k] for k in summary_keys}
        | {"wall_s": serve_s, "intake_s": intake_s,
           "run_s": serve_s - intake_s}), flush=True)

    # the int8 path: same traffic to the two int8-tier models
    metrics0 = {k: eng.metrics[k] for k in ("batches", "device_busy_s",
                                            "operand_bytes_h2d")}
    n_done0 = len(eng.finished)
    reset_launches()                        # the int8 path starts here
    t_serve = time.perf_counter()
    for model in ("gcn_q", "gcn_qmm"):
        for g in [cora] + others:
            eng.submit(g, model=model)
    gid = eng.attach(planetoid_like(num_nodes=900, num_edges=1800,
                                    num_feats=1433, num_classes=7, seed=12),
                     model="gcn_q")
    eng.query(gid, tier="int8")
    eng.query(gid, tier="int8")
    intake_s = time.perf_counter() - t_serve
    per_key = Counter((r.model, r.bucket, r.tier, r.fusion)
                      for r in eng.queue)
    eng.run()
    serve_s = time.perf_counter() - t_serve
    launches_i8 = launches_now()
    done = eng.finished[n_done0:]
    batches = {k: -(-n // SLOTS) for k, n in per_key.items()}
    want = {"block_matmul": 0, "fused_gcn_dense": 0, "bitmap_spmm": 0,
            "fused_gcn_grasp": 0,
            **dict.fromkeys(GAT_KERNELS + SAGE_KERNELS + LM_KERNELS, 0),
            "int8_matmul": 4 * sum(v for k, v in batches.items()
                                   if k[0] == "gcn_qmm" and k[2] == "int8"),
            "fused_gcn_int8": 2 * sum(v for k, v in batches.items()
                                      if k[0] == "gcn_q" and k[2] == "int8")}
    print(f"[serve-int8] {len(done)} requests in {sum(batches.values())} "
          f"batches {sorted(batches.items())}; launches {launches_i8}, "
          f"expected {want}", flush=True)
    check({r.tier for r in done} == {"int8"},
          f"int8 path served tiers {sorted({r.tier for r in done})}")
    check(eng.metrics["batches"] - metrics0["batches"]
          == sum(batches.values()), "int8 batch count mismatch")
    check(launches_i8 == want, f"kernel launches {launches_i8} != {want}")
    check(launches_i8["int8_matmul"] > 0 and launches_i8["fused_gcn_int8"] > 0,
          f"an int8 kernel of the path never launched: {launches_i8}")
    check(len(done) == 2 * (1 + len(PLANETOID_SIZES)) + 2,
          f"{len(done)} int8 requests finished")
    check(eng.summary()["tier_fallbacks"] == 0, "an int8 request fell back")
    check(len(eng._tier_operands) == 1,
          "the attached graph's int8 A was not derived exactly once")
    check(eng.metrics["operand_bytes_h2d"] - metrics0["operand_bytes_h2d"]
          == burst_h2d, "the int8 burst did not ship exactly its compact "
          "forms")
    eng.assert_warm()

    i8_err = 0.0
    for r in done:
        n = r.pg.num_nodes
        check(r.logits is not None and r.logits.shape == (n, 7)
              and np.isfinite(r.logits).all(),
              f"request {r.uid}: logits missing, misshapen or not finite")
        ref = gcn_plain(r, params, dev,
                        eng.models[r.model].calibrations["int8"])
        got = torch.from_numpy(r.logits)
        torch.testing.assert_close(got, ref, **TOL)
        check(np.array_equal(r.preds, ref.argmax(-1).numpy()),
              f"request {r.uid}: argmax differs from the plain forward")
        i8_err = max(i8_err, (got - ref).abs().max().item())
    s = eng.summary()
    print(f"[serve-int8] logits of all {len(done)} requests match the plain "
          f"int8 forward (max_abs_err {i8_err:.3e}; rtol={TOL['rtol']} "
          f"atol={TOL['atol']}); argmax equal", flush=True)
    busy = s["device_busy_s"] - metrics0["device_busy_s"]
    span = (max(r.finished_s for r in done)
            - min(r.submitted_s for r in done))
    print("[serve-int8] summary " + json.dumps(
        {"requests": len(done),
         "batches": s["batches"] - metrics0["batches"],
         "device_busy_s": busy,
         "device_idle_fraction": max(0.0, 1.0 - busy / span),
         "operand_bytes_h2d": (s["operand_bytes_h2d"]
                               - metrics0["operand_bytes_h2d"]),
         "compiled_blobs": s["compiled_blobs"],
         "tier_fallbacks": s["tier_fallbacks"],
         "wall_s": serve_s, "intake_s": intake_s,
         "run_s": serve_s - intake_s}), flush=True)
    print("[serve-int8] accuracy_delta_vs_fp32 "
          + json.dumps(s["accuracy_delta_vs_fp32"]), flush=True)
    print("[serve-int8] tier_summary " + json.dumps(eng.tier_summary()),
          flush=True)
    launches.update({k: launches_i8[k]
                     for k in ("int8_matmul", "fused_gcn_int8")})

    # --------------------------------------------------- 4. serve-grasp
    eng_sp = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=LADDER),
                                         batch_slots=SLOTS,
                                         return_logits=True), seed=0,
                        device=dev)
    eng_sp.register_model("gcn_sp", cfg, params, agg_backend="grasp",
                          fusion="layer")
    eng_sp.register_model("gcn_sp_auto", cfg, params, agg_backend="auto")
    eng_sp.register_model("gcn_dense", cfg, params, fusion="layer")
    t0 = time.perf_counter()
    blobs = eng_sp.warmup()
    print(f"[serve-grasp] warmup: {blobs} signatures (plans and block "
          f"compactor) in {time.perf_counter() - t0:.2f} s", flush=True)
    grasp_graphs = {n: clustered(n) for n in CLUSTERED_SIZES}
    for label, g in list(grasp_graphs.items()) + [("cora", cora)]:
        pg = eng_sp.sc.ladder.pad(g)
        st_ = block_stats(pg.norm_adj)
        dec = {m: select_agg_backend(
            pg.capacity, cfg.hidden, nnz_blocks=st_["nnz_blocks"],
            max_row_nnz=st_["max_row_nnz"], mode=m) for m in ("auto",
                                                              "grasp")}
        old = rule_with(SIMT_RULE_COSTS, pg.capacity, cfg.hidden,
                        nnz_blocks=st_["nnz_blocks"],
                        max_row_nnz=st_["max_row_nnz"])
        print(f"[serve-grasp] graph {label}: bucket {pg.capacity}, "
              f"nnz_blocks {st_['nnz_blocks']}, max_row_nnz "
              f"{st_['max_row_nnz']}, budget {grasp_max_nnz(pg.capacity)}; "
              f"auto -> {dec['auto'][0]}, forced -> {dec['grasp'][0]}; "
              f"modelled dense {dec['auto'][1] * 1e6:.2f} us, grasp "
              f"{dec['auto'][2] * 1e6:.2f} us; under the SIMT-tile "
              f"constants auto -> {old[0]}, modelled dense "
              f"{old[1] * 1e6:.2f} us, grasp {old[2] * 1e6:.2f} us",
              flush=True)
    batch_log = []
    execute = eng_sp._execute_batch

    def record(batch):
        h = batch[0]
        batch_log.append((h.model, h.bucket, h.backend, h.fusion))
        execute(batch)
    eng_sp._execute_batch = record
    derived = []
    derive = eng_sp._derive_grasp

    def counted_derive(*args):
        derived.append(args[1])
        return derive(*args)
    eng_sp._derive_grasp = counted_derive

    reset_launches()                        # the grasp path starts here
    t_serve = time.perf_counter()
    uid_graph = {}
    for model in ("gcn_sp", "gcn_sp_auto", "gcn_dense"):
        for label, g in list(grasp_graphs.items()) + [("cora", cora)]:
            if model == "gcn_dense" and label == "cora":
                continue
            uid_graph[eng_sp.submit(g, model=model)] = label
    gid = eng_sp.attach(clustered(1800), model="gcn_sp")
    for _ in range(2):
        uid_graph[eng_sp.query(gid)] = 1800
    intake_s = time.perf_counter() - t_serve
    done = eng_sp.run()
    serve_s = time.perf_counter() - t_serve
    launches_sp = launches_now()
    n_kind = Counter((b[2], b[3]) for b in batch_log)
    want = {"block_matmul": 0, "int8_matmul": 0, "fused_gcn_int8": 0,
            **dict.fromkeys(GAT_KERNELS + SAGE_KERNELS + LM_KERNELS, 0),
            "fused_gcn_dense": 2 * n_kind[("dense", "layer")],
            "bitmap_spmm": 2 * n_kind[("grasp", "none")],
            "fused_gcn_grasp": 2 * n_kind[("grasp", "layer")]}
    s = eng_sp.summary()
    forced_dense = sum(r.model == "gcn_sp" and r.backend == "dense"
                       for r in done)
    print(f"[serve-grasp] {len(done)} requests in {len(batch_log)} batches "
          f"{sorted(Counter(batch_log).items())}; launches {launches_sp}, "
          f"expected {want}", flush=True)
    check(launches_sp == want, f"kernel launches {launches_sp} != {want}")
    check(want["bitmap_spmm"] > 0 and want["fused_gcn_grasp"] > 0,
          f"a GraSp kernel never launched: {launches_sp}")
    check(s["grasp_batches"] == n_kind[("grasp", "none")]
          + n_kind[("grasp", "layer")],
          f"grasp_batches {s['grasp_batches']} disagrees with the batch log")
    check(s["backend_fallbacks"] == forced_dense == 1,
          f"backend_fallbacks {s['backend_fallbacks']}, ineligible forced "
          f"requests {forced_dense}; expected Cora's one")
    # on CacheG every grasp-capable one-shot request decides from its
    # materialized A on the card too; the attached graph decides once
    n_one_shot = 2 * (len(CLUSTERED_SIZES) + 1)
    check(len(derived) == n_one_shot + 1 and len(eng_sp._grasp) == 1,
          f"{len(derived)} device-side GraSp derivations, expected "
          f"{n_one_shot} one-shot and 1 for the attached graph")
    # three models take each clustered graph, two take Cora, and the
    # attached graph's first query ships once
    sp_h2d = sum(compact_bytes(eng_sp.sc.ladder.bucket_for(g.num_nodes))
                 * (2 if label == "cora" else 3)
                 for label, g in list(grasp_graphs.items()) + [("cora", cora)]
                 ) + compact_bytes(3072)
    check(s["cacheg_fallbacks"] == 0 and s["operand_bytes_h2d"] == sp_h2d,
          f"operand_bytes_h2d {s['operand_bytes_h2d']} != the compact "
          f"forms' {sp_h2d}, or a request fell back")
    check(len(done) == 2 * (len(CLUSTERED_SIZES) + 1)
          + len(CLUSTERED_SIZES) + 2, f"{len(done)} requests finished")
    eng_sp.assert_warm()

    sp_err, ties = 0.0, 0
    by_graph = {}
    for r in done:
        n = r.pg.num_nodes
        check(r.logits is not None and r.logits.shape == (n, 7)
              and np.isfinite(r.logits).all(),
              f"request {r.uid}: logits missing, misshapen or not finite")
        ref = gcn_plain(r, params, dev)
        got = torch.from_numpy(r.logits)
        torch.testing.assert_close(got, ref, **TOL)
        sp_err = max(sp_err, (got - ref).abs().max().item())
        # argmax equal, except at a tie the tolerance cannot resolve
        top2 = ref.topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= TOL["atol"]
        ties += int(tie.sum())
        check(bool((torch.from_numpy(r.preds) == ref.argmax(-1))[~tie]
                   .all()), f"request {r.uid}: argmax differs")
        by_graph.setdefault(uid_graph[r.uid], {})[r.model] = got
    for label, logits in by_graph.items():
        if "gcn_dense" in logits:
            for model, got in logits.items():
                torch.testing.assert_close(got, logits["gcn_dense"], **TOL)
    print(f"[serve-grasp] logits of all {len(done)} requests match the "
          f"plain forward (max_abs_err {sp_err:.3e}; rtol={TOL['rtol']} "
          f"atol={TOL['atol']}); argmax equal ({ties} ties within atol); "
          f"the grasp logits of each clustered graph match gcn_dense's",
          flush=True)
    print("[serve-grasp] summary " + json.dumps(
        {"requests": len(done), "batches": s["batches"],
         "grasp_batches": s["grasp_batches"],
         "backend_fallbacks": s["backend_fallbacks"],
         "agg_backends": s["agg_backends"],
         "device_busy_s": s["device_busy_s"],
         "device_idle_fraction": s["device_idle_fraction"],
         "operand_bytes_h2d": s["operand_bytes_h2d"],
         "compiled_blobs": s["compiled_blobs"],
         "p50_latency_ms": s["p50_latency_ms"],
         "p99_latency_ms": s["p99_latency_ms"],
         "wall_s": serve_s, "intake_s": intake_s,
         "run_s": serve_s - intake_s}), flush=True)
    launches.update({k: launches_sp[k]
                     for k in ("bitmap_spmm", "fused_gcn_grasp")})

    # ------------------------------------------------------ 5. serve-gat
    # the GAT kernels at both buckets' serving shapes: 4-graph batches
    # (junk slots repeat a graph), layer 1 (8 heads of 8 over the 1433
    # features) and layer 2 (1 head of 7 over layer 1's 64); NodePad's rows
    # are all -1e9, and the "far" masks make rows 64..95's first 64
    # columns all -1e9 (the online softmax's first steps)
    gcfg = gat("cora")
    gat_np = {"l1": gat_layer_np(rng, 1433, GAT_HEADS, GAT_F),
              "l2": gat_layer_np(rng, GAT_HEADS * GAT_F, 1, GAT_CLASSES)}
    gparams = params_from_jax(gat_np, device=dev)
    g1, g2 = gparams["l1"], gparams["l2"]
    pg_cora = pad_graph(cora, capacity=CAP)
    gcal = calibrate_tier(gparams, gcfg,
                          torch.from_numpy(pg_cora.features).to(dev),
                          build_operands(pg_cora, gcfg, device=dev))
    err.update(dict.fromkeys(GAT_KERNELS, 0.0))
    gat_cases = {}
    for gcap, gs in ((1024, [others[0], others[1], others[2], others[1]]),
                     (CAP, batch_graphs)):
        pgs_g = [pad_graph(g, capacity=gcap) for g in gs]
        bias = stack_operands([build_operands(p, gcfg, device=dev)
                               for p in pgs_g]).bias_add
        far = bias.clone()
        far[:, 64:96, :64] = kops.NEG_INF
        xg1 = torch.from_numpy(np.stack([p.features for p in pgs_g])).to(dev)
        xg2 = gat_layer_plain(g1, xg1, bias, GAT_HEADS, GAT_F, "elu")
        att = {"L1": (*gat_combine(g1, xg1, GAT_HEADS, GAT_F), bias),
               "L1 far": (*gat_combine(g1, xg1, GAT_HEADS, GAT_F), far),
               "L2": (*gat_combine(g2, xg2, 1, GAT_CLASSES), bias)}
        b1g = g1["b"].reshape(GAT_HEADS, GAT_F)
        b2g = g2["b"].reshape(1, GAT_CLASSES)
        w1g = g1["w"].reshape(-1, GAT_HEADS, GAT_F)
        w2g = g2["w"].reshape(-1, 1, GAT_CLASSES)
        full = {"L1 elu": (xg1, w1g, g1["a_src"], g1["a_dst"], bias, b1g,
                           "elu"),
                "L1 far relu": (xg1, w1g, g1["a_src"], g1["a_dst"], far, b1g,
                                "relu"),
                "L2 none": (xg2, w2g, g2["a_src"], g2["a_dst"], bias, b2g,
                            "none")}
        q1 = gat_combine(g1, xg1, GAT_HEADS, GAT_F, gcal["l1"])
        xq2 = fl.fused_gat_precombined_plain(*q1, bias, b1g, "elu").reshape(
            xg1.shape[0], gcap, -1)
        q2 = gat_combine(g2, xq2, 1, GAT_CLASSES, gcal["l2"])
        pre = {"L1 elu": (*q1, bias, b1g, "elu"),
               "L1 far none": (*q1, far, b1g, "none"),
               "L2 none": (*q2, bias, b2g, "none")}
        pad_rows = sum(gcap - p.num_nodes for p in pgs_g)
        print(f"[check] gat batch at {gcap}: graphs "
              f"{[p.num_nodes for p in pgs_g]}, {pad_rows} all -1e9 padded "
              f"rows", flush=True)
        for label, args in att.items():
            compare("gat_attention", f"{gcap} {label}",
                    lambda: ga.gat_attention(*args),
                    ga.gat_attention_plain(*args))
        for label, args in full.items():
            compare("fused_gat_full", f"{gcap} {label}",
                    lambda: fl.fused_gat_full(*args),
                    fl.fused_gat_full_plain(*args))
        for label, args in pre.items():
            compare("fused_gat_precombined", f"{gcap} {label}",
                    lambda: fl.fused_gat_precombined(*args),
                    fl.fused_gat_precombined_plain(*args))
        gat_cases[gcap] = dict(att=att, full=full, pre=pre)
    # a ragged graph through `kernels.ops`: 1000 nodes, no padding, so the
    # kernels' 32-row and 64-column tiles end inside the graph and the
    # fused entry pads to 1024 with -1e9 rows and columns itself
    pg_r = pad_graph(others[2], capacity=others[2].num_nodes)
    bias_r = stack_operands([build_operands(pg_r, gcfg, device=dev)] * SLOTS
                            ).bias_add
    xr = torch.from_numpy(np.stack([pg_r.features] * SLOTS)).to(dev)
    qr = gat_combine(g1, xr, GAT_HEADS, GAT_F, gcal["l1"])
    hr = gat_combine(g1, xr, GAT_HEADS, GAT_F)
    compare("gat_attention", "ragged 1000 via ops",
            lambda: kops.gat_attention(*hr, bias_r),
            ga.gat_attention_plain(*hr, bias_r))
    compare("fused_gat_full", "ragged 1000 via ops",
            lambda: kops.fused_gat_layer(
                xr, g1["w"].reshape(-1, GAT_HEADS, GAT_F), g1["a_src"],
                g1["a_dst"], bias_r, b1g, activation="elu"),
            fl.fused_gat_full_plain(xr, g1["w"].reshape(-1, GAT_HEADS, GAT_F),
                                    g1["a_src"], g1["a_dst"], bias_r, b1g,
                                    "elu"))
    compare("fused_gat_precombined", "ragged 1000 via ops",
            lambda: kops.fused_gat_layer(
                None, None, g1["a_src"], g1["a_dst"], bias_r, b1g,
                activation="elu", precombined=qr),
            fl.fused_gat_precombined_plain(*qr, bias_r, b1g, "elu"))
    check(max(err[k] for k in GAT_KERNELS) <= TOL["atol"],
          f"a GAT kernel's max_abs_err exceeds {TOL['atol']}: "
          f"{ {k: err[k] for k in GAT_KERNELS} }")

    eng_g = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=LADDER),
                                        batch_slots=SLOTS, return_logits=True),
                       seed=0, device=dev)
    gbase = dict(stagr=True, graphsplit=True, effop=True)
    eng_g.register_model("gat", gcfg, gparams, tiers=("fp32", "int8"),
                         fusion="layer")
    eng_g.register_model("gat_mm", gcfg, gparams, tiers={
        "fp32": Techniques(**gbase, use_pallas=True),
        "int8": Techniques(**gbase, quantgr=True, use_pallas=True)})
    t0 = time.perf_counter()
    blobs = eng_g.warmup()
    print(f"[serve-gat] warmup: {blobs} plan signatures in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for model in ("gat", "gat_mm"):
        deltas = eng_g.calibrate(model, cora)
        print(f"[serve-gat] calibrated {model} on Cora: "
              f"accuracy_delta_vs_fp32 {deltas}", flush=True)
    gat_log = []
    execute_g = eng_g._execute_batch

    def record_gat(batch):
        h = batch[0]
        gat_log.append((h.model, h.tier, h.fusion))
        execute_g(batch)
    eng_g._execute_batch = record_gat

    reset_launches()                        # the GAT path starts here
    t_serve = time.perf_counter()
    g900 = planetoid_like(num_nodes=900, num_edges=1800, num_feats=1433,
                          num_classes=7, seed=13)
    for model in ("gat", "gat_mm"):
        gid = eng_g.attach(g900, model=model)
        for tier in ("fp32", "int8"):
            for g in [cora] + others:
                eng_g.submit(g, model=model, tier=tier)
            eng_g.query(gid, tier=tier)
            eng_g.query(gid, tier=tier)
    intake_s = time.perf_counter() - t_serve
    done = eng_g.run()
    serve_s = time.perf_counter() - t_serve
    launches_g = launches_now()
    n_kind = Counter(gat_log)
    want = dict.fromkeys(COUNTERS, 0) | {
        "fused_gat_full": 2 * n_kind[("gat", "fp32", "layer")],
        "fused_gat_precombined": 2 * n_kind[("gat", "int8", "layer")],
        "gat_attention": 2 * (n_kind[("gat_mm", "fp32", "none")]
                              + n_kind[("gat_mm", "int8", "none")]),
        "int8_matmul": 2 * n_kind[("gat_mm", "int8", "none")]}
    s = eng_g.summary()
    print(f"[serve-gat] {len(done)} requests in {len(gat_log)} batches "
          f"{sorted(n_kind.items())}; launches {launches_g}, expected "
          f"{want}", flush=True)
    check(launches_g == want, f"kernel launches {launches_g} != {want}")
    check(all(want[k] > 0 for k in GAT_KERNELS),
          f"a GAT kernel never launched: {launches_g}")
    check(len(done) == 2 * 2 * (1 + len(PLANETOID_SIZES) + 2),
          f"{len(done)} GAT requests finished")
    check({(r.model, r.tier) for r in done}
          == {(m, t) for m in ("gat", "gat_mm") for t in ("fp32", "int8")},
          "a GAT model or tier was not served")
    check(s["tier_fallbacks"] == 0, "a GAT int8 request fell back")
    # CacheG: 4 one-shot requests of each graph (2 models x 2 tiers) and
    # each model's attached graph's first query ship their compact forms
    g_h2d = 4 * sum(compact_bytes(eng_g.sc.ladder.bucket_for(g.num_nodes))
                    for g in [cora] + others) + 2 * compact_bytes(1024)
    check((s["operand_bytes_h2d"], s["operand_cache_misses"],
           s["operand_cache_hits"], s["cacheg_fallbacks"])
          == (g_h2d, 2, 6, 0),
          f"GAT intake: operand_bytes_h2d {s['operand_bytes_h2d']} (compact "
          f"forms {g_h2d}), misses {s['operand_cache_misses']}, hits "
          f"{s['operand_cache_hits']}, fallbacks {s['cacheg_fallbacks']}")
    eng_g.assert_warm()

    g_err, flips, q_inputs, ties = 0.0, 0, 0, 0
    for r in done:
        held = gat_plain_check(r, eng_g.models[r.model], dev)
        g_err = max(g_err, held[0])
        flips, q_inputs, ties = (a + b for a, b in zip(
            (flips, q_inputs, ties), held[1:]))
    print(f"[serve-gat] logits of all {len(done)} requests match the plain "
          f"forward (max_abs_err {g_err:.3e}; rtol={TOL['rtol']} "
          f"atol={TOL['atol']}; int8 requests layer by layer, {flips} of "
          f"{q_inputs} layer-2 int8 inputs one step off the all-plain "
          f"chain); argmax equal ({ties} ties within atol)", flush=True)
    print("[serve-gat] summary " + json.dumps(
        {k: s[k] for k in summary_keys}
        | {"wall_s": serve_s, "intake_s": intake_s,
           "run_s": serve_s - intake_s}), flush=True)
    print("[serve-gat] accuracy_delta_vs_fp32 "
          + json.dumps(s["accuracy_delta_vs_fp32"]), flush=True)
    print("[serve-gat] tier_summary " + json.dumps(eng_g.tier_summary()),
          flush=True)
    launches.update({k: launches_g[k] for k in GAT_KERNELS})

    # ----------------------------------------------------- 6. serve-sage
    # the SAGE kernels at both buckets' 4-graph serving shapes (junk slots
    # repeat a graph): the real sampled masks of the serving path (NodePad
    # rows empty), layer 1 over the 1433 features (max: over the pooled
    # features, 1433 wide), layer 2 over hidden 64; "dense" sets every
    # column of row 7 of each graph, "NaN" fills the pooled rows that no
    # mask row selects (NodePad's)
    scfg = {agg: sage("cora", agg) for agg in ("mean", "max")}
    sparams = {agg: params_from_jax(
        {"l1": sage_layer_np(rng, 1433, SAGE_HIDDEN, agg),
         "l2": sage_layer_np(rng, SAGE_HIDDEN, SAGE_CLASSES, agg)},
        device=dev) for agg in ("mean", "max")}
    err.update(dict.fromkeys(SAGE_KERNELS, 0.0))
    sage_cases = {}
    for gcap, gs in ((1024, [others[0], others[1], others[2], others[1]]),
                     (CAP, batch_graphs)):
        pgs_s = [pad_graph(g, capacity=gcap) for g in gs]
        ops_s = stack_operands([build_operands(p, scfg["max"], device=dev)
                                for p in pgs_s])
        sample, mean = ops_s.sample_mask, ops_s.mean_mask
        dense, dense_mean = sample.clone(), mean.clone()
        dense[:, 7] = 1.0
        dense_mean[:, 7] = 1.0 / gcap
        xs1 = torch.from_numpy(np.stack([p.features for p in pgs_s])).to(dev)
        pmx, pmn = sparams["max"], sparams["mean"]
        pooled1 = sage_pooled(pmx["l1"], xs1)
        nan_pooled = pooled1.clone()
        for i, p in enumerate(pgs_s):
            nan_pooled[i, p.num_nodes:] = float("nan")
        xs2_max = sage_layer_plain(pmx["l1"], xs1, sample, mean, "max",
                                   "relu")
        xs2_mean = sage_layer_plain(pmn["l1"], xs1, sample, mean, "mean",
                                    "relu")
        pooled2 = sage_pooled(pmx["l2"], xs2_max)
        nnz_row = sample.sum(dim=-1)
        print(f"[check] sage batch at {gcap}: graphs "
              f"{[p.num_nodes for p in pgs_s]}, sampled entries per real "
              f"row <= {int(nnz_row.max())}, "
              f"{int((nnz_row == 0).sum())} empty (NodePad) rows", flush=True)

        def w(p, layer):
            q = p[layer]
            return q["w_self"], q["w_neigh"], q["b"]
        smax = {"L1": (sample, pooled1), "L1 dense row": (dense, pooled1),
                "L2": (sample, pooled2)}
        fsage = {
            "mean L1 relu": (mean, xs1, xs1, *w(pmn, "l1"), "mean", "relu"),
            "mean L1 none": (mean, xs1, xs1, *w(pmn, "l1"), "mean", "none"),
            "mean L1 dense row relu": (dense_mean, xs1, xs1, *w(pmn, "l1"),
                                       "mean", "relu"),
            "mean L2 none": (mean, xs2_mean, xs2_mean, *w(pmn, "l2"), "mean",
                             "none"),
            "max L1 relu": (sample, pooled1, xs1, *w(pmx, "l1"), "max",
                            "relu"),
            "max L1 dense row none": (dense, pooled1, xs1, *w(pmx, "l1"),
                                      "max", "none"),
            "max L2 none": (sample, pooled2, xs2_max, *w(pmx, "l2"), "max",
                            "none")}
        for label, args in smax.items():
            compare_exact("sage_max", f"{gcap} {label}",
                          lambda: sm.sage_max(*args), sm.sage_max_plain(*args))
        compare_exact("sage_max", f"{gcap} L1 NaN in unselected rows",
                      lambda: sm.sage_max(sample, nan_pooled),
                      sm.sage_max_plain(sample, pooled1))
        check(bool(torch.isnan(sm.sage_max_plain(sample, nan_pooled)).any()),
              "the plain sage_max did not turn the NaN rows NaN")
        for label, args in fsage.items():
            compare("fused_sage", f"{gcap} {label}",
                    lambda: fl.fused_sage(*args), fl.fused_sage_plain(*args))
        nan_args = (sample, nan_pooled, *fsage["max L1 relu"][2:])
        compare("fused_sage", f"{gcap} max L1 relu NaN in unselected rows",
                lambda: fl.fused_sage(*nan_args),
                fl.fused_sage_plain(*fsage["max L1 relu"]))
        sage_cases[gcap] = dict(smax=smax, fsage=fsage, mean=mean, x1=xs1,
                                x2=xs2_mean)
    check(err["sage_max"] == 0.0 and err["fused_sage"] <= TOL["atol"],
          f"a SAGE kernel's max_abs_err is off: "
          f"{ {k: err[k] for k in SAGE_KERNELS} }")

    eng_s = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=LADDER),
                                        batch_slots=SLOTS, return_logits=True),
                       seed=0, device=dev)
    sbase = dict(stagr=True, graphsplit=True, effop=True)
    eng_s.register_model("sage_max", scfg["max"], sparams["max"],
                         tiers=("fp32", "int8+grax"), fusion="layer")
    eng_s.register_model("sage_max_mm", scfg["max"], sparams["max"], tiers={
        "fp32": Techniques(**sbase, grax3=True, use_pallas=True),
        "int8+grax": Techniques(**sbase, quantgr=True, grax3=True,
                                use_pallas=True)})
    eng_s.register_model("sage_mean", scfg["mean"], sparams["mean"],
                         tiers=("fp32", "int8"), fusion="layer")
    eng_s.register_model("sage_mean_mm", scfg["mean"], sparams["mean"],
                         tiers={"fp32": Techniques(**sbase, use_pallas=True),
                                "int8": Techniques(**sbase, quantgr=True,
                                                   use_pallas=True)})
    sage_models = {"sage_max": ("fp32", "int8+grax"),
                   "sage_max_mm": ("fp32", "int8+grax"),
                   "sage_mean": ("fp32", "int8"),
                   "sage_mean_mm": ("fp32", "int8")}
    t0 = time.perf_counter()
    blobs = eng_s.warmup()
    print(f"[serve-sage] warmup: {blobs} plan signatures in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for model in sage_models:
        deltas = eng_s.calibrate(model, cora)
        print(f"[serve-sage] calibrated {model} on Cora: "
              f"accuracy_delta_vs_fp32 {deltas}", flush=True)
    sage_log = []
    execute_s = eng_s._execute_batch

    def record_sage(batch):
        h = batch[0]
        sage_log.append((h.model, h.tier, h.fusion))
        execute_s(batch)
    eng_s._execute_batch = record_sage

    reset_launches()                        # the SAGE path starts here
    t_serve = time.perf_counter()
    g900s = planetoid_like(num_nodes=900, num_edges=1800, num_feats=1433,
                           num_classes=7, seed=14)
    for model, tiers in sage_models.items():
        gid = eng_s.attach(g900s, model=model)
        for tier in tiers:
            for g in [cora] + others:
                eng_s.submit(g, model=model, tier=tier)
            eng_s.query(gid, tier=tier)
            eng_s.query(gid, tier=tier)
    intake_s = time.perf_counter() - t_serve
    done = eng_s.run()
    serve_s = time.perf_counter() - t_serve
    launches_s = launches_now()
    n_kind = Counter(sage_log)
    want = dict.fromkeys(COUNTERS, 0) | {
        "fused_sage": 2 * (n_kind[("sage_max", "fp32", "layer")]
                           + n_kind[("sage_mean", "fp32", "layer")]),
        "sage_max": 2 * (n_kind[("sage_max_mm", "fp32", "none")]
                         + n_kind[("sage_max_mm", "int8+grax", "none")]),
        "block_matmul": 2 * (n_kind[("sage_mean_mm", "fp32", "none")]
                             + n_kind[("sage_mean_mm", "int8", "none")]),
        # int8 combines: self, neigh and pool per layer (max), self and
        # neigh (mean)
        "int8_matmul": 6 * n_kind[("sage_max_mm", "int8+grax", "none")]
        + 4 * n_kind[("sage_mean_mm", "int8", "none")]}
    s = eng_s.summary()
    print(f"[serve-sage] {len(done)} requests in {len(sage_log)} batches "
          f"{sorted(n_kind.items())}; launches {launches_s}, expected "
          f"{want}", flush=True)
    check(launches_s == want, f"kernel launches {launches_s} != {want}")
    check(all(want[k] > 0 for k in SAGE_KERNELS),
          f"a SAGE kernel never launched: {launches_s}")
    check(len(done) == sum(len(t) for t in sage_models.values())
          * (1 + len(PLANETOID_SIZES) + 2),
          f"{len(done)} SAGE requests finished")
    check({(r.model, r.tier) for r in done}
          == {(m, t) for m, ts in sage_models.items() for t in ts},
          "a SAGE model or tier was not served")
    check(s["tier_fallbacks"] == 0, "a SAGE int8 request fell back")
    # CacheG: the full-matrix SAGE sample crosses packed; 8 one-shot
    # requests of each graph (4 models x 2 tiers) and each model's attached
    # graph's first query
    s_h2d = 8 * sum(compact_bytes(eng_s.sc.ladder.bucket_for(g.num_nodes),
                                  sage=True) for g in [cora] + others) \
        + 4 * compact_bytes(1024, sage=True)
    check((s["operand_bytes_h2d"], s["operand_cache_misses"],
           s["operand_cache_hits"], s["cacheg_fallbacks"])
          == (s_h2d, 4, 12, 0),
          f"SAGE intake: operand_bytes_h2d {s['operand_bytes_h2d']} (compact "
          f"forms {s_h2d}), misses {s['operand_cache_misses']}, hits "
          f"{s['operand_cache_hits']}, fallbacks {s['cacheg_fallbacks']}")
    eng_s.assert_warm()

    s_err, flips, q_inputs, ties = 0.0, 0, 0, 0
    for r in done:
        n = r.pg.num_nodes
        check(r.logits is not None
              and r.logits.shape == (n, SAGE_CLASSES)
              and np.isfinite(r.logits).all(),
              f"request {r.uid}: logits missing, misshapen or not finite")
        e = eng_s.models[r.model]
        t = e.tiers[r.tier]
        agg = e.cfg.aggregator
        cal = e.calibrations[r.tier] if t.quantgr else {}
        x = torch.from_numpy(r.pg.features).to(dev)[None]
        ops1 = stack_operands([host_operands(r, e.cfg, dev)])
        sm_, mn_ = ops1.sample_mask, ops1.mean_mask
        h1 = sage_layer_plain(e.params["l1"], x, sm_, mn_, agg, "relu",
                              cal.get("l1"))
        if t.quantgr:
            # layer 2 rounds layer 1's fp32 output to int8, as GAT's does:
            # held layer by layer, layer 1 through the served layer
            # function against the plain layer 1, then the logits against
            # the plain layer 2 over the served layer 1
            kw = dict(aggregator=agg, quant=cal["l1"])
            if r.fusion == "layer":
                h1_k = glayers.sage_grannite_fused(
                    e.params["l1"], x, sm_, mn_, t, activation="relu", **kw)
            else:
                h1_k = torch.relu(glayers.sage_grannite(
                    e.params["l1"], x, sm_, mn_, t, **kw))
            d1 = (h1_k - h1)[0, :n].abs().max().item()
            check(d1 <= TOL["atol"], f"request {r.uid}: layer 1 differs "
                  f"from the plain version by {d1}")
            xs = cal["l2"]["self"].x_scale
            flips += int((torch.round(h1_k[0, :n] / xs)
                          != torch.round(h1[0, :n] / xs)).sum())
            q_inputs += h1[0, :n].numel()
            h1 = h1_k
        ref = sage_layer_plain(e.params["l2"], h1, sm_, mn_, agg, "none",
                               cal.get("l2"))[0, :n].cpu()
        got = torch.from_numpy(r.logits)
        d = (got - ref).abs().max().item()
        check(d <= TOL["atol"], f"request {r.uid}: max_abs_err {d}")
        torch.testing.assert_close(got, ref, **TOL)
        s_err = max(s_err, d)
        top2 = ref.topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= TOL["atol"]
        ties += int(tie.sum())
        check(bool((torch.from_numpy(r.preds) == ref.argmax(-1))[~tie]
                   .all()), f"request {r.uid}: argmax differs")
    print(f"[serve-sage] logits of all {len(done)} requests match the plain "
          f"forward (max_abs_err {s_err:.3e}; rtol={TOL['rtol']} "
          f"atol={TOL['atol']}; int8 requests layer by layer, {flips} of "
          f"{q_inputs} layer-2 int8 inputs one step off the all-plain "
          f"chain); argmax equal ({ties} ties within atol)", flush=True)
    print("[serve-sage] summary " + json.dumps(
        {k: s[k] for k in summary_keys}
        | {"wall_s": serve_s, "intake_s": intake_s,
           "run_s": serve_s - intake_s}), flush=True)
    print("[serve-sage] accuracy_delta_vs_fp32 "
          + json.dumps(s["accuracy_delta_vs_fp32"]), flush=True)
    print("[serve-sage] tier_summary " + json.dumps(eng_s.tier_summary()),
          flush=True)
    launches.update({k: launches_s[k] for k in SAGE_KERNELS})

    # ---------------------------------------------- 7-8. intake, cacheg
    intake_phase(dev, card, cfg, params, cora, others)
    cacheg_phase(dev, card, {"gcn": cfg, "gat": gcfg, "sage": scfg["max"]},
                 params, cora, others)

    # ---------------------------------------------------------- 9. delta
    delta_phase(dev, card, cfg, params, gcfg, gparams, cora, clustered(2700))

    # -------------------------------------------------------- 10. pipeline
    pipeline_phase(dev, card, cfg, params, cora, others)

    # ----------------------------------------------------------- 11. shard
    shard_launches, rect_row = shard_phase(dev, card, cfg, params, gcfg,
                                           gparams, scfg, sparams, cora)

    # ------------------------------------------------------------ 11b. mesh
    mesh_launches = mesh_phase(dev, card)

    # -------------------------------------------------- 11c. mesh-pipeline
    mesh_pipe_launches = mesh_pipeline_phase(dev, card)

    # ----------------------------------------------------------- 12. train
    train_launches = train_phase(dev, card)

    # ---------------------------------------------- 13-14. flash, serve-lm
    flash_err = flash_phase(dev)
    flash_launches, _, _ = serve_lm_phase(dev, card)

    # --------------------------- 15-17. serve-moe, serve-ssm, serve-hybrid
    free_card()
    moe_launches, _ = serve_moe_phase(dev, card)
    serve_ssm_phase(dev, card)
    hybrid_launches, _ = serve_moe_phase(dev, card, tag="serve-hybrid",
                                         arch=HYBRID_ARCH,
                                         layers=HYBRID_LAYERS)

    # ------------------------------------- 18-19. serve-audio, serve-vlm
    audio_launches, _ = serve_audio_phase(dev, card)
    vlm_launches, _ = serve_vlm_phase(dev, card)

    # ----------------------- 20-22. serve-dense, serve-scout, examples
    dense_launches, _ = serve_dense_phase(dev, card)
    scout_launches, _ = serve_moe_phase(dev, card, tag="serve-scout",
                                        arch=SCOUT_ARCH, layers=SCOUT_LAYERS)
    examples_phase(card)

    # ------------------------------------------------------ 23. train-lm
    bwd_errors = bwd_check_phase(dev)
    train_lm_launches, bwd_launches, _ = train_lm_phase(dev, card)

    # ------------------------------------------------ 23b-c. mesh-lm, dryrun
    mesh_lm_fwd, mesh_lm_bwd = mesh_lm_phase(dev, card)
    dryrun_phase(card)

    # --------------------------------------------------------- 24. times
    def int_mm(a, b):
        """torch._int_mm over the same product: per graph when both
        operands are batched, else with the batch folded into the rows."""
        if b.dim() == 3:
            return [torch._int_mm(a[i], b[i]) for i in range(a.shape[0])]
        return torch._int_mm(a.reshape(-1, a.shape[-1]), b)

    # the GraSp rows: the 3072 serving batch of clustered graphs. Library
    # yardstick: torch.sparse.mm of each graph's Â as a 128-block BSR
    # tensor (a batch of BSR tensors needs equal block counts, which these
    # graphs do not have, so one call per graph); beside it torch.matmul of
    # the densified Â, the dense backend's work.
    g3 = grasp_cases[CAP]
    sp_cases = {"L1 A@H": (*g3["st"], g3["h1"]),
                "L2 A@H": (*g3["st"], g3["h2"])}
    spf_cases = {"L1 relu": (*g3["st"], g3["x1"], w1, b1, "relu"),
                 "L2 none": (*g3["st"], g3["x2"], w2, b2, "none")}
    try:
        bsr = [a.to_sparse_bsr((TILE, TILE)) for a in g3["adj"]]
        torch.testing.assert_close(
            torch.stack([torch.sparse.mm(m, h) for m, h in
                         zip(bsr, g3["h1"])]),
            bs.bitmap_spmm_plain(*sp_cases["L1 A@H"]), **TOL)
        bsr_refused = None
    except (RuntimeError, NotImplementedError, TypeError) as e:
        bsr, bsr_refused = None, f"{type(e).__name__}: {e}"
        print(f"[time] torch.sparse.mm on a BSR tensor refused: "
              f"{bsr_refused}", flush=True)

    s3 = sage_cases[CAP]
    sage_max_cases = {k: s3["smax"][k] for k in ("L1", "L2")}
    sage_fused_cases = {k: s3["fsage"][k] for k in (
        "mean L1 relu", "mean L2 none", "max L1 relu", "max L2 none")}
    g3g = gat_cases[CAP]
    gat_att_cases = {k: g3g["att"][k] for k in ("L1", "L2")}
    gat_full_cases = {k: g3g["full"][k] for k in ("L1 elu", "L2 none")}
    gat_pre_cases = {k: g3g["pre"][k] for k in ("L1 elu", "L2 none")}
    rows = []
    for kernel, cases in (("block_matmul", products),
                          ("fused_gcn_dense", layers),
                          ("int8_matmul", i8_products),
                          ("fused_gcn_int8", i8_layers),
                          ("bitmap_spmm", sp_cases),
                          ("fused_gcn_grasp", spf_cases),
                          ("gat_attention", gat_att_cases),
                          ("fused_gat_full", gat_full_cases),
                          ("fused_gat_precombined", gat_pre_cases),
                          ("sage_max", sage_max_cases),
                          ("fused_sage", sage_fused_cases)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "flops": 0.0, "bytes": 0.0, "dense_ms": 0.0, "exps": 0.0,
               "mean": 0.0, "max": 0.0, "device_ms": 0.0,
               "library_device_ms": 0.0, "walk_ops": 0.0,
               "zero_count_ms": 0.0, "dense_device_ms": 0.0,
               "combine_flops": 0.0, "mean_device_ms": 0.0,
               "max_device_ms": 0.0}
        peak = (INT8_OPS_PER_S if kernel in ("int8_matmul", "fused_gcn_int8")
                else FP32_FLOPS_PER_S)
        for label, args in cases.items():
            if kernel == "block_matmul":
                a, b = args
                t_k = time_ms(lambda: bm.block_matmul(a, b))
                t_p = time_ms(lambda: bm.block_matmul_plain(a, b))
                t_l = time_ms(lambda: torch.matmul(a, b))
                d_k = queued_ms(lambda: bm.block_matmul(a, b))
                d_l = queued_ms(lambda: torch.matmul(a, b))
                flops, nbytes_ = matmul_work(a, b)
                # 3xTF32: three TF32 products per fp32 product
                tf_ms, tf_by = bound(3 * flops, nbytes_, TF32_FLOPS_PER_S)
                f32_ms, _ = bound(flops, nbytes_, FP32_FLOPS_PER_S)
                for key, ms in (("device_ms", d_k),
                                ("library_device_ms", d_l)):
                    tot[key] = None if ms is None or tot[key] is None \
                        else tot[key] + ms
                print(f"[time] block_matmul {label}: queued behind a spin, "
                      f"kernel {ms_or_not(d_k)}, torch.matmul "
                      f"{ms_or_not(d_l)}; bound on the TF32 tensor cores "
                      f"{tf_ms:.4f} ms ({tf_by}), on fp32 FMA {f32_ms:.4f} "
                      f"ms; {card}", flush=True)
            elif kernel == "fused_gcn_dense":
                t_k = time_ms(lambda: fl.fused_gcn_dense(*args))
                d_k = queued_ms(lambda: fl.fused_gcn_dense(*args))
                t_p = time_ms(lambda: fl.fused_gcn_dense_plain(*args))
                t_l = None
                flops, nbytes_ = fused_work(*args[:3], args[3])
            elif kernel == "int8_matmul":
                a, b, xs, ws = args
                t_k = time_ms(lambda: im.int8_matmul(*args))
                d_k = queued_ms(lambda: im.int8_matmul(*args))
                t_p = time_ms(lambda: im.int8_matmul_plain(*args))
                t_l = time_ms(lambda: int_mm(a, b))
                d_l = queued_ms(lambda: int_mm(a, b))
                flops, nbytes_ = matmul_work(a, b)
                nbytes_ += nbytes(ws)
            elif kernel == "bitmap_spmm":
                h = args[3]
                # the walk's fixed cost a call: the same launch with every
                # count 0 (no block read, the output still written)
                idle = (args[0], args[1], torch.zeros_like(args[2]), h)

                def sparse_mm():
                    return [torch.sparse.mm(m, hi) for m, hi in zip(bsr, h)]

                def dense_mm():
                    return torch.matmul(g3["adj"], h)
                t_k = time_ms(lambda: bs.bitmap_spmm(*args))
                d_k = queued_ms(lambda: bs.bitmap_spmm(*args))
                d_z = queued_ms(lambda: bs.bitmap_spmm(*idle))
                t_p = time_ms(lambda: bs.bitmap_spmm_plain(*args))
                t_l = None if bsr is None else time_ms(sparse_mm)
                d_l = None if bsr is None else queued_ms(sparse_mm)
                t_d = time_ms(dense_mm)
                d_d = queued_ms(dense_mm)
                tot["dense_ms"] += t_d
                for key, ms in (("device_ms", d_k), ("zero_count_ms", d_z),
                                ("library_device_ms", d_l),
                                ("dense_device_ms", d_d)):
                    tot[key] = None if ms is None or tot[key] is None \
                        else tot[key] + ms
                print(f"[time] bitmap_spmm {label}: queued behind a spin, "
                      f"kernel {ms_or_not(d_k)}, every count 0 "
                      f"{ms_or_not(d_z)}, torch.sparse.mm per graph "
                      f"{ms_or_not(d_l)}, torch.matmul of the densified A "
                      f"{ms_or_not(d_d)} ({t_d:.4f} ms by events); {card}",
                      flush=True)
                flops, nbytes_ = grasp_work(args[1], args[2], h.shape[-1])
            elif kernel == "fused_gcn_grasp":
                cols_, counts_, x, w = args[1], args[2], args[3], args[4]
                t_k = time_ms(lambda: fl.fused_gcn_grasp(*args))
                d_k = queued_ms(lambda: fl.fused_gcn_grasp(*args))
                t_p = time_ms(lambda: fl.fused_gcn_grasp_plain(*args))
                t_l = None
                flops, nbytes_ = grasp_work(cols_, counts_, w.shape[1],
                                            fin=x.shape[-1])
                nbytes_ += nbytes(w, args[5])
            elif kernel == "fused_gcn_int8":
                x, wq, sw, xs, hs, aq_, as_, bias = args[:8]
                t_k = time_ms(lambda: fl.fused_gcn_int8(*args))
                d_k = queued_ms(lambda: fl.fused_gcn_int8(*args))
                t_p = time_ms(lambda: fl.fused_gcn_int8_plain(*args))
                t_l, d_l = None, None
                flops, nbytes_ = fused_work(aq_, x, wq, sw, xs, hs, as_,
                                            bias)
            elif kernel == "sage_max":
                t_k = time_ms(lambda: sm.sage_max(*args))
                t_p = time_ms(lambda: sm.sage_max_plain(*args))
                t_l = None
                flops, nbytes_ = walk_work(args[0], args[1].shape[-1])
            elif kernel == "fused_sage":
                t_k = time_ms(lambda: fl.fused_sage(*args))
                d_k = queued_ms(lambda: fl.fused_sage(*args))
                t_p = time_ms(lambda: fl.fused_sage_plain(*args))
                t_l = None
                walk_ops, combine_flops, nbytes_ = fused_sage_work(*args)
                flops = walk_ops + combine_flops
                tot["walk_ops"] += walk_ops
                tot["combine_flops"] += combine_flops
                tot[args[6]] += t_k
                for key in ("device_ms", f"{args[6]}_device_ms"):
                    tot[key] = (None if d_k is None or tot[key] is None
                                else tot[key] + d_k)
                tf_ms, tf_by = sage_bound(walk_ops, combine_flops, nbytes_)
                f32_ms, f32_by = sage_bound(walk_ops, combine_flops,
                                            nbytes_, tf32=False)
                print(f"[time] fused_sage {label}: queued behind a spin "
                      f"{ms_or_not(d_k)}; bound with 3xTF32 products "
                      f"{tf_ms:.4f} ms ({tf_by}), with fp32 FMA products "
                      f"{f32_ms:.4f} ms ({f32_by}); {card}", flush=True)
                if args[6] == "mean":
                    # the dense yardstick of the mean walk: M @ X
                    t_d = time_ms(lambda: torch.matmul(args[0], args[1]))
                    tot["dense_ms"] += t_d
                    print(f"[time] fused_sage {label}: torch.matmul of the "
                          f"mean mask and X {t_d:.4f} ms", flush=True)
            else:
                # the GAT kernels: no one PyTorch call computes
                # leaky-ReLU-scored, additively masked attention, so
                # library_ms is null; the bound counts expf on the SFUs
                run, plain = {"gat_attention": (ga.gat_attention,
                                                ga.gat_attention_plain),
                              "fused_gat_full": (fl.fused_gat_full,
                                                 fl.fused_gat_full_plain),
                              "fused_gat_precombined": (
                                  fl.fused_gat_precombined,
                                  fl.fused_gat_precombined_plain)}[kernel]
                # queued right after the event time, before the plain
                # version's long run
                t_k = time_ms(lambda: run(*args))
                d_k = queued_ms(lambda: run(*args))
                t_p = time_ms(lambda: plain(*args))
                t_l = None
                tot["device_ms"] = (None if d_k is None
                                    or tot["device_ms"] is None
                                    else tot["device_ms"] + d_k)
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                if kernel == "fused_gat_full":
                    x, w3 = args[0], args[1]
                    h_shape = (*x.shape[:2], *w3.shape[1:])
                    fin = x.shape[-1]
                else:
                    h_shape, fin = tuple(args[0].shape), 0
                flops, exps, nbytes_ = gat_work(h_shape, nbytes(*tensors),
                                                fin)
                tot["exps"] += exps
                f32_ms, f32_by = gat_bound(flops, exps, nbytes_, tf32=False)
                tf_ms, tf_by = gat_bound(flops, exps, nbytes_)
                print(f"[time] {kernel} {label}: queued behind a spin "
                      f"{ms_or_not(d_k)}; bound with 3xTF32 products "
                      f"{tf_ms:.4f} ms ({tf_by}), with fp32 FMA products "
                      f"{f32_ms:.4f} ms ({f32_by}); {card}", flush=True)
            if kernel in INT8_KERNELS:
                for key, ms in (("device_ms", d_k),
                                ("library_device_ms", d_l)):
                    tot[key] = None if ms is None or tot[key] is None \
                        else tot[key] + ms
                i8_ms, i8_by = bound(flops, nbytes_, peak)
                print(f"[time] {kernel} {label}: queued behind a spin, "
                      f"kernel {ms_or_not(d_k)}"
                      + (f", torch._int_mm {ms_or_not(d_l)}"
                         if kernel == "int8_matmul" else "")
                      + f"; bound {i8_ms:.4f} ms ({i8_by}); {card}",
                      flush=True)
            if kernel in GCN_KERNELS:
                # every product priced as 3xTF32 and as fp32 FMA
                tot["device_ms"] = (None if d_k is None
                                    or tot["device_ms"] is None
                                    else tot["device_ms"] + d_k)
                tf_ms, tf_by = bound(3 * flops, nbytes_, TF32_FLOPS_PER_S)
                f32_ms, f32_by = bound(flops, nbytes_)
                print(f"[time] {kernel} {label}: queued behind a spin "
                      f"{ms_or_not(d_k)}; bound with 3xTF32 products "
                      f"{tf_ms:.4f} ms ({tf_by}), with fp32 FMA products "
                      f"{f32_ms:.4f} ms ({f32_by}); {card}", flush=True)
            if kernel in GAT_KERNELS:
                b_ms, b_by = gat_bound(flops, exps, nbytes_)
            elif kernel in ("block_matmul", "fused_sage", *GCN_KERNELS):
                b_ms, b_by = tf_ms, tf_by
            else:
                b_ms, b_by = bound(flops, nbytes_, peak)
            print(f"[time] {kernel} {label}: kernel {t_k:.4f} ms, plain "
                  f"{t_p:.4f} ms, library "
                  f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}, bound "
                  f"{b_ms:.4f} ms ({b_by}); {flops / t_k / 1e9:.1f} "
                  f"T{'OP' if peak == INT8_OPS_PER_S else 'FLOP'}/s; {card}",
                  flush=True)
            tot["ms"] += t_k
            tot["plain_ms"] += t_p
            tot["library_ms"] = (None if t_l is None
                                 else tot["library_ms"] + t_l)
            tot["flops"] += flops
            tot["bytes"] += nbytes_
        if kernel in GAT_KERNELS:
            b_ms, b_by = gat_bound(tot["flops"], tot["exps"], tot["bytes"])
        elif kernel in ("block_matmul", *GCN_KERNELS):
            b_ms, b_by = bound(3 * tot["flops"], tot["bytes"],
                               TF32_FLOPS_PER_S)
        elif kernel == "fused_sage":
            b_ms, b_by = sage_bound(tot["walk_ops"], tot["combine_flops"],
                                    tot["bytes"])
        else:
            b_ms, b_by = bound(tot["flops"], tot["bytes"], peak)
        src, replaces = SOURCES[kernel]
        row = {"name": kernel, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[kernel],
               "max_abs_err": err[kernel], "ms": tot["ms"],
               "plain_ms": tot["plain_ms"], "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": tot["library_ms"],
               "per": f"one batch of {SLOTS} graphs at {CAP} nodes: "
                      + ", ".join(cases)}
        if kernel in SHARD_KERNELS:
            # the sharded path's launches ([shard]) join the count, and are
            # given apart too; so do its ranks' on a mesh ([mesh], summed
            # over the ranks) and through the pipeline there
            # ([mesh-pipeline])
            row["launches"] += (shard_launches[kernel] + mesh_launches[kernel]
                                + mesh_pipe_launches[kernel])
            row["shard_launches"] = shard_launches[kernel]
            row["mesh_launches"] = mesh_launches[kernel]
            row["mesh_pipeline_launches"] = mesh_pipe_launches[kernel]
        if kernel in TRAIN_KERNELS:
            # likewise the trained models' evaluation ([train])
            row["launches"] += train_launches[kernel]
            row["train_launches"] = train_launches[kernel]
        if kernel == "sage_max":
            row.update(rect_row)
        if kernel in GAT_KERNELS:
            f32_ms, f32_by = gat_bound(tot["flops"], tot["exps"],
                                       tot["bytes"], tf32=False)
            row.update(library="none: no one PyTorch call computes "
                               "leaky-ReLU-scored additively masked "
                               "attention",
                       device_ms=tot["device_ms"],
                       bound_note="3 TF32 products per product at 495 "
                                  "TFLOP/s, one expf per score at the SFU "
                                  "rate, or the bytes at 3.35 TB/s",
                       bound_fp32_fma_ms=f32_ms)
            print(f"[time] {kernel}, the batch's {len(cases)} layers: kernel "
                  f"{tot['ms']:.4f} ms (queued "
                  f"{ms_or_not(tot['device_ms'])}), plain "
                  f"{tot['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
                  f"3xTF32 products), {f32_ms:.4f} ms ({f32_by}, fp32 FMA "
                  f"products); {card}", flush=True)
            print(f"[time] {kernel} per batch on the SIMT attention body "
                  f"before the tensor-core redesign: "
                  f"{GAT_SIMT_MS[kernel]} ms, copied from PERF.md (section "
                  f"6; NVIDIA H100 80GB HBM3, 700 W), not measured in this "
                  f"run", flush=True)
        if kernel == "gat_attention":
            # what holds the body: each variant on the same layers
            parts = {}
            for label, args in cases.items():
                parts[label] = {"tensor-core body (gat_attention)":
                                queued_ms(lambda: ga.gat_attention(*args))}
                out = torch.empty_like(args[0])
                for v_label, fn in variant_fns["gat_attention"].items():
                    parts[label][v_label] = queued_ms(
                        lambda: run_gat_variant(fn, *args, out))
                    if v_label == "split by cvt.rna":
                        check(torch.equal(out, ga.gat_attention(*args)),
                              "gat_attention differs from its cvt.rna split")
                print(f"[breakdown] gat_attention's body, {label} of a "
                      f"batch, queued behind a spin: "
                      + ", ".join(f"{k_} {ms_or_not(v_)}"
                                  for k_, v_ in parts[label].items())
                      + f" (the cvt.rna split's output equals the body's bit "
                      f"for bit); {card}", flush=True)
            # the body's time against its blocks in flight: the first k
            # graphs of the layer-1 batch, 96 blocks of 32 rows each
            waves = {k: queued_ms(lambda: ga.gat_attention(
                *(a[:k] for a in cases["L1"]))) for k in range(1, SLOTS + 1)}
            print("[breakdown] gat_attention's body, L1 on the batch's first "
                  "k graphs (96 k blocks; 2 blocks an SM fit): " + ", ".join(
                      f"{k} {ms_or_not(v)}" for k, v in waves.items())
                  + f"; {card}", flush=True)
            row.update(body_variants_device_ms=parts,
                       body_l1_graphs_device_ms=waves)
        if kernel in INT8_KERNELS:
            row.update(device_ms=tot["device_ms"],
                       tops=tot["flops"] / tot["ms"] / 1e9,
                       library=("torch._int_mm (per graph where both "
                                "operands are batched), a yardstick only"
                                if kernel == "int8_matmul" else
                                "none: no one call computes the int8 layer"))
            if kernel == "int8_matmul":
                row.update(library_device_ms=tot["library_device_ms"])
            print(f"[time] {kernel}, the batch's {len(cases)} "
                  f"{'products' if kernel == 'int8_matmul' else 'layers'}: "
                  f"kernel {tot['ms']:.4f} ms (queued "
                  f"{ms_or_not(tot['device_ms'])})"
                  + (f", torch._int_mm {tot['library_ms']:.4f} ms (queued "
                     f"{ms_or_not(tot['library_device_ms'])})"
                     if kernel == "int8_matmul" else "")
                  + f", plain {tot['plain_ms']:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by}); {row['tops']:.1f} TOP/s; {card}", flush=True)
            print(f"[time] {kernel} per batch on the __dp4a tile before the "
                  f"s8 tensor-core tile: {INT8_DP4A_MS[kernel]} ms, copied "
                  f"from PERF.md (section 6, row "
                  f"{2 if kernel == 'int8_matmul' else 8}; NVIDIA H100 80GB "
                  f"HBM3, 700 W), not measured in this run", flush=True)
        if kernel == "int8_matmul":
            # the tile against its blocks in flight: layer 1's Aq @ Hq on
            # the batch's first k graphs, 48 blocks of 64 rows each
            a, b, xs, ws = cases["L1 Aq@Hq"]
            waves = {k: queued_ms(lambda: im.int8_matmul(a[:k], b[:k], xs,
                                                         ws))
                     for k in range(1, SLOTS + 1)}
            print("[breakdown] int8_matmul, L1 Aq@Hq on the batch's first k "
                  "graphs (48 k blocks; 2 blocks an SM fit): " + ", ".join(
                      f"{k} {ms_or_not(v)}" for k, v in waves.items())
                  + f"; {card}", flush=True)
            row.update(l1_aggregate_graphs_device_ms=waves)
        if kernel in SAGE_KERNELS:
            row.update(library="none: no one PyTorch call computes a "
                               "masked max over a sampled adjacency (GrAx3)"
                       + (" or the fused SAGE layer"
                          if kernel == "fused_sage" else ""))
        if kernel == "fused_sage":
            f32_ms, f32_by = sage_bound(tot["walk_ops"],
                                        tot["combine_flops"], tot["bytes"],
                                        tf32=False)
            row.update(mean_ms=tot["mean"], max_ms=tot["max"],
                       device_ms=tot["device_ms"],
                       mean_device_ms=tot["mean_device_ms"],
                       max_device_ms=tot["max_device_ms"],
                       dense_matmul_ms=tot["dense_ms"],
                       dense_matmul="torch.matmul(mean_mask, X), both "
                                    "layers",
                       bound_note="the walk's operations at 67 TFLOP/s, "
                                  "then 3 TF32 products per combine product "
                                  "at 495 TFLOP/s, or the bytes at 3.35 "
                                  "TB/s",
                       bound_fp32_fma_ms=f32_ms)
            print(f"[time] fused_sage, the batch's {len(cases)} layers: "
                  f"kernel {tot['ms']:.4f} ms (queued "
                  f"{ms_or_not(tot['device_ms'])}; mean pair "
                  f"{ms_or_not(tot['mean_device_ms'])}, max pair "
                  f"{ms_or_not(tot['max_device_ms'])}), plain "
                  f"{tot['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
                  f"3xTF32 combine products), {f32_ms:.4f} ms ({f32_by}, "
                  f"fp32 FMA products); {card}", flush=True)
            print(f"[time] fused_sage per batch (both layers) with the fp32 "
                  f"SIMT combine before the 3xTF32 tile: mean "
                  f"{FUSED_SAGE_SIMT_MS['mean']} ms, max "
                  f"{FUSED_SAGE_SIMT_MS['max']} ms, copied from PERF.md "
                  f"(section 6, row 12; NVIDIA H100 80GB HBM3, 700 W), not "
                  f"measured in this run", flush=True)

            def graph_slices(args, sl):
                return tuple(a[sl] if isinstance(a, torch.Tensor)
                             and a.dim() == 3 else a for a in args)
            # what holds layer 1: the walk, the combine and its two K loops
            # (X by 4-byte copies, AGG by 16-byte ones, the same K), the
            # combine with each K loop in blocks of its own, and the pair
            # run one graph at a time (17.6 MB of AGG a graph, against the
            # batch's 70 MB)
            parts = {}
            for label in ("mean L1 relu", "max L1 relu"):
                args = cases[label]
                per_graph = [graph_slices(args, slice(i, i + 1))
                             for i in range(SLOTS)]
                parts[label] = {"pair (fused_sage)": queued_ms(
                    lambda: fl.fused_sage(*args))}
                for v_label, fn in variant_fns["fused_sage"].items():
                    parts[label][v_label] = queued_ms(
                        lambda: run_sage_variant(fn, *args))
                parts[label]["pair, one graph at a time"] = queued_ms(
                    lambda: [fl.fused_sage(*g) for g in per_graph])
                x_ms = parts[label]["combine, X loop alone"]
                g_ms = parts[label]["combine, AGG loop alone"]
                print(f"[breakdown] fused_sage {label} per batch, queued "
                      f"behind a spin: " + ", ".join(
                          f"{k_} {ms_or_not(v_)}"
                          for k_, v_ in parts[label].items())
                      + "; the X loop's 4-byte copies cost "
                      + ("not measured" if x_ms is None or g_ms is None
                         else f"{x_ms - g_ms:.4f} ms over the AGG loop's "
                              f"16-byte copies")
                      + f"; {card}", flush=True)
            # the combine against its blocks in flight: layer 1 on the
            # batch's first k graphs, 48 k blocks of 64 rows on 132 SMs
            combine = variant_fns["fused_sage"]["combine alone"]
            args = cases["mean L1 relu"]
            waves = {k: queued_ms(lambda: run_sage_variant(
                combine, *graph_slices(args, slice(0, k))))
                for k in range(1, SLOTS + 1)}
            print("[breakdown] fused_sage's combine, L1 on the batch's first "
                  "k graphs (48 k blocks of 128 threads on 132 SMs): "
                  + ", ".join(f"{k} {ms_or_not(v)}" for k, v in waves.items())
                  + f"; {card}", flush=True)
            row.update(l1_parts_device_ms=parts,
                       l1_combine_graphs_device_ms=waves)
        if kernel == "block_matmul":
            f32_ms, f32_by = bound(tot["flops"], tot["bytes"])
            # what holds the tile: each variant over the same products
            parts = {"3xTF32 (block_matmul)": tot["device_ms"]}
            for label, fn in variant_fns["block_matmul"].items():
                ms = 0.0
                for a, b in cases.values():
                    out = torch.empty(
                        a.shape[0] if a.dim() == 3 else b.shape[0],
                        a.shape[-2], b.shape[-1], device=dev)
                    d_v = queued_ms(lambda: run_tile_variant(fn, a, b, out))
                    ms = None if ms is None or d_v is None else ms + d_v
                    if label == "split by cvt.rna":
                        # the integer rounding gives cvt.rna's bits
                        check(torch.equal(out, bm.block_matmul(a, b)),
                              "block_matmul differs from its cvt.rna split")
                parts[label] = ms
            parts["torch.matmul"] = tot["library_device_ms"]
            print(f"[breakdown] block_matmul's tile per batch, queued behind "
                  f"a spin: " + ", ".join(f"{k_} {ms_or_not(v_)}"
                                          for k_, v_ in parts.items())
                  + f" (the cvt.rna split's products equal block_matmul's "
                  f"bit for bit); {card}", flush=True)
            row.update(device_ms=tot["device_ms"],
                       library_device_ms=tot["library_device_ms"],
                       library="torch.matmul (fp32, TF32 off), a yardstick "
                               "only",
                       tflops=tot["flops"] / tot["ms"] / 1e9,
                       bound_note="3 TF32 products per product at 495 "
                                  "TFLOP/s, or the bytes at 3.35 TB/s",
                       bound_fp32_fma_ms=f32_ms,
                       rel_err_vs_float64={k: {"kernel": e, "torch.matmul": t}
                                           for k, (e, t) in f64_err.items()},
                       tile_variants_device_ms=parts)
            print(f"[time] block_matmul, the batch's {len(cases)} products: "
                  f"kernel {tot['ms']:.4f} ms (queued "
                  f"{ms_or_not(tot['device_ms'])}), torch.matmul "
                  f"{tot['library_ms']:.4f} ms (queued "
                  f"{ms_or_not(tot['library_device_ms'])}), plain "
                  f"{tot['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
                  f"3xTF32 on the TF32 tensor cores), {f32_ms:.4f} ms on "
                  f"fp32 FMA ({f32_by}); {row['tflops']:.1f} TFLOP/s of fp32 "
                  f"products; {card}", flush=True)
            print(f"[time] block_matmul per batch on the fp32 SIMT tile "
                  f"before the tensor-core redesign: {BLOCK_MATMUL_SIMT_MS} "
                  f"ms, copied from PERF.md (section 6, row 1; NVIDIA H100 "
                  f"80GB HBM3, 700 W), not measured in this run", flush=True)
        if kernel in GCN_KERNELS:
            f32_ms, f32_by = bound(tot["flops"], tot["bytes"])
            row.update(device_ms=tot["device_ms"],
                       library="none: no one PyTorch call computes "
                               "act(A(XW)+b)"
                               + (" over a block structure"
                                  if kernel == "fused_gcn_grasp" else ""),
                       bound_note="3 TF32 products per product at 495 "
                                  "TFLOP/s, or the bytes at 3.35 TB/s",
                       bound_fp32_fma_ms=f32_ms)
            if kernel == "fused_gcn_dense":
                row.update(rel_err_vs_float64={
                    k: {"kernel": e, "plain": t}
                    for k, (e, t) in dense_f64_err.items()})
            print(f"[time] {kernel}, the batch's {len(cases)} layers: kernel "
                  f"{tot['ms']:.4f} ms (queued "
                  f"{ms_or_not(tot['device_ms'])}), plain "
                  f"{tot['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
                  f"3xTF32 products), {f32_ms:.4f} ms ({f32_by}, fp32 FMA "
                  f"products); {tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s "
                  f"of fp32 products; {card}", flush=True)
            print(f"[time] {kernel} per batch (both layers) with its "
                  f"{'products' if kernel == 'fused_gcn_dense' else 'combine'}"
                  f" on the fp32 SIMT tile before the 3xTF32 kernel: "
                  f"{GCN_SIMT_MS[kernel]} ms, copied from PERF.md (section "
                  f"6, row {7 if kernel == 'fused_gcn_dense' else 9}; NVIDIA "
                  f"H100 80GB HBM3, 700 W), not measured in this run",
                  flush=True)
        if kernel == "bitmap_spmm":
            row.update(device_ms=tot["device_ms"],
                       zero_count_device_ms=tot["zero_count_ms"],
                       library_device_ms=tot["library_device_ms"],
                       dense_matmul_ms=tot["dense_ms"],
                       dense_matmul_device_ms=tot["dense_device_ms"],
                       library="torch.sparse.mm per graph on 128-block BSR",
                       library_refused=bsr_refused)
            print(f"[time] bitmap_spmm, the batch's {len(cases)} calls: "
                  f"queued behind a spin, kernel "
                  f"{ms_or_not(tot['device_ms'])}, every count 0 "
                  f"{ms_or_not(tot['zero_count_ms'])}, torch.sparse.mm "
                  f"{ms_or_not(tot['library_device_ms'])}, torch.matmul of "
                  f"the densified A {ms_or_not(tot['dense_device_ms'])}; "
                  f"by events kernel {tot['ms']:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by}); {card}", flush=True)
        if kernel == "bitmap_spmm":
            # the walk against its blocks in flight: L1 A@H on the batch's
            # first k graphs, 96 k blocks of 128 threads with a 55 KB ring
            # each (three blocks an SM fit 396 slots), with its counts and
            # with every count 0
            blocks_, cols_, counts_, h_ = cases["L1 A@H"]
            waves = {}
            for k in range(1, SLOTS + 1):
                sub = (blocks_[:k], cols_[:k], counts_[:k], h_[:k])
                idle = (*sub[:2], torch.zeros_like(sub[2]), sub[3])
                waves[k] = {"kernel": queued_ms(lambda: bs.bitmap_spmm(*sub)),
                            "every count 0": queued_ms(
                                lambda: bs.bitmap_spmm(*idle))}
            print("[breakdown] bitmap_spmm, L1 A@H on the batch's first k "
                  "graphs (96 k blocks), queued behind a spin: " + ", ".join(
                      f"{k} {ms_or_not(v['kernel'])} (every count 0 "
                      f"{ms_or_not(v['every count 0'])})"
                      for k, v in waves.items()) + f"; {card}", flush=True)
            row.update(l1_graphs_device_ms=waves)
        if kernel in ("bitmap_spmm", "fused_gcn_grasp"):
            print(f"[time] {kernel} per batch, queued, with the walk on the "
                  f"fp32 SIMT tile before the 3xTF32 tile: " + ", ".join(
                      f"{k} {v} ms" for k, v in WALK_SIMT_MS.items()
                      if k.startswith(kernel))
                  + "; copied from PERF.md (section 6, rows 3 and 9; "
                  "NVIDIA H100 80GB HBM3, 700 W), not measured in this run",
                  flush=True)
        rows.append(row)
    # the MoE, hybrid, encoder-decoder and vision paths' prefills and the
    # LM training's forwards join flash_attention's count, and are given
    # apart too
    flash = flash_row(dev, flash_launches + moe_launches + hybrid_launches
                      + audio_launches + vlm_launches + dense_launches
                      + scout_launches + train_lm_launches + mesh_lm_fwd,
                      flash_err, card)
    flash.update(serve_lm_launches=flash_launches,
                 serve_moe_launches=moe_launches,
                 serve_hybrid_launches=hybrid_launches,
                 serve_audio_launches=audio_launches,
                 serve_vlm_launches=vlm_launches,
                 serve_dense_launches=dense_launches,
                 serve_scout_launches=scout_launches,
                 train_lm_launches=train_lm_launches,
                 mesh_lm_launches=mesh_lm_fwd)
    rows.append(flash)
    bwd = bwd_row(dev, bwd_launches + mesh_lm_bwd, bwd_errors, card)
    bwd.update(train_lm_launches=bwd_launches, mesh_lm_launches=mesh_lm_bwd)
    rows.append(bwd)

    # the terms of the GraSp cost rule (core/costs.py), measured on each
    # bucket's serving batch, queued behind a spin: a launch's fixed cost
    # (the walk's call with every count 0, at the smallest bucket) shared
    # by the batch's graphs, the walk's rate over the real blocks'
    # products once that cost is taken off (at the largest), what is left
    # over per list step at that rate (at the smallest), and the dense
    # products' rate on block_matmul's kernel (at the largest)
    agg = {}
    for gcap, case in grasp_cases.items():
        st_, h = case["st"], case["h1"]
        idle = (st_[0], st_[1], torch.zeros_like(st_[2]))
        bsz, rb, budget = st_[1].shape
        f = h.shape[-1]
        flops, _ = grasp_work(st_[1], st_[2], f)
        agg[gcap] = dict(
            grasp=queued_ms(lambda: bs.bitmap_spmm(*st_, h)),
            zero=queued_ms(lambda: bs.bitmap_spmm(*idle, h)),
            block_matmul=queued_ms(lambda: bm.block_matmul(case["adj"], h)),
            matmul=queued_ms(lambda: torch.matmul(case["adj"], h)),
            flops=flops, dense_flops=2.0 * bsz * gcap * gcap * f,
            steps=bsz * rb * budget * max(f // 128, 1),
            model=agg_cost_model(gcap, f, nnz_blocks=int(st_[2].sum()) // bsz,
                                 max_nnz=budget),
            blocks=int(st_[2].sum()), bsz=bsz, f=f, budget=budget)
    lo, hi = agg[min(agg)], agg[max(agg)]
    timed = all(a[k] is not None for a in agg.values()
                for k in ("grasp", "zero", "block_matmul"))
    if timed and hi["grasp"] > hi["zero"]:
        walk_rate = hi["flops"] / (hi["grasp"] - hi["zero"]) * 1e3
        dense_rate = hi["dense_flops"] / hi["block_matmul"] * 1e3
        step_s = max(lo["grasp"] - lo["zero"] - lo["flops"] / walk_rate
                     * 1e3, 0.0) / lo["steps"] * 1e-3
        measured = {"DENSE_RATE": dense_rate, "GRASP_RATE": walk_rate,
                    "GRASP_STEP_OVERHEAD_S": step_s,
                    "AGG_CALL_S": lo["zero"] / lo["bsz"] * 1e-3}
    else:
        measured = None
    for gcap, a in agg.items():
        dense_s, grasp_s = a["model"]
        print(f"[agg] bucket {gcap}, batch of {a['bsz']}, F={a['f']}, "
              f"budget {a['budget']}, {a['blocks']} real blocks, "
              f"{a['steps']} list steps; queued behind a spin: grasp "
              f"(bitmap_spmm) {ms_or_not(a['grasp'])}, every count 0 "
              f"{ms_or_not(a['zero'])}, dense block_matmul "
              f"{ms_or_not(a['block_matmul'])}, dense torch.matmul "
              f"{ms_or_not(a['matmul'])}; modelled per batch dense "
              f"{dense_s * a['bsz'] * 1e3:.4f} ms, grasp "
              f"{grasp_s * a['bsz'] * 1e3:.4f} ms; {card}", flush=True)
    print("[agg] the cost rule's terms measured in this run: "
          + ("not measured" if measured is None else ", ".join(
              f"{k} {v:.4g}" for k, v in measured.items()))
          + "; core/costs.py has " + ", ".join(
              f"{k} {getattr(costs, k):.4g}" for k in SIMT_RULE_COSTS)
          + f"; {card}", flush=True)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
