"""Smoke run of the PyTorch port on one CUDA card (H100).

Drives the port's paths through the hand-written CUDA kernels, with
random weights from a seed and in-hindsight W8A8G8 quantization on the
fused backend: full-width starcoder2-3b (30 layers) serving (batch 4 x
1024-token prompts, 8 generated tokens) and training (AdamW steps on
batch 4 x 1024 tokens, remat on), the MoE family's qwen2-moe-a2.7b
(serving at full width and depth, training at full width), and the
paper's CNN training loop on
MobileNetV2 at its Tiny ImageNet width (64 x 64 x 3 images, 200 classes,
batch 128; ResNet18 and VGG16 one step each), and the dense family past
its window: starcoder2-7b at full width, depth 16 (4 x 1024 and 1 x
8192 prompts, fused, simulated and fp32), command-r-35b and nemotron-4-340b at full
width, the long-sequence train step and the paper's grad_only /
act_only policies, the hybrid family: recurrentgemma-9b (RG-LRU
blocks and local attention at hd 256, MQA) serving at full width, depth
18, past its 2048 window, and its train step at full width, and the
RWKV-6 family: rwkv6-7b (attention-free: the chunked WKV recurrence with
data-dependent decay) serving at full width, depth 16, up to a
32768-token prompt, and its train step at full width, and the enc-dec and VLM
families: seamless-m4t-medium (a bidirectional encoder on stub frame
embeddings, a decoder with cross attention) and paligemma-3b (an image
prefix of stub patch embeddings under the prefix-LM mask, MQA at hd 256)
serving and training at full width and depth, and the ``model`` mesh
axis: starcoder2-3b served and qwen2-moe-a2.7b trained on model shards,
recurrentgemma-9b and rwkv6-7b served and trained on model shards, and
starcoder2-3b trained on the sequence-parallel attention core, then
served, decoded over a length-sharded cache and trained on padded head
shards, over gloo ranks on the one card.  Each
kernel is checked against its plain PyTorch version at the shapes those
paths give it.  Every phase prints its wall seconds as it ends
(``[time] phase N ...``), and the run its total.
Phases, one line each:

  1. device        name, count, and nvidia-smi's name and power limit
  2. build         nvcc of every kernel source, in parallel
  3. kernels       each kernel vs its plain version (exact, or within the
                   stated tolerance; the on-chip Philox form of the
                   stochastic quantizer statistically), then timed with
                   CUDA events beside its bound, its plain version and a
                   library yardstick
  4. serve         repro_torch.launch.serve.main(...) with the launch
                   counters zeroed just before and read just after
  5. static path   one prefill's statistics folded into the quant state
                   (every activation leaf initialized), served again so the
                   single-pass hindsight branch runs
  6. parity        prefill logits, fused vs simulated backend, same params
  7. train         repro_torch.launch.train.main(...): 3 steps, 30 layers,
                   with the launch counters zeroed just before and read
                   just after
                   and one more step of the same state under torch.profiler
                   (device time by kernel family, the device's idle share)
  8. train parity  one forward + backward, fused vs simulated backend, same
                   params, batch and noise (4 layers at full width)
  9. fused layers  the paper's single-pass layer through
                   ops.int8_matmul_fused: starcoder2-3b's MLP up and down
                   projections at full width as two chained int8 layers
                   (B=4 x 1024 tokens), four in-hindsight steps, with the
                   launch counters zeroed just before and read just after
 10. cnn train     repro_torch.cnn.train.main(...): MobileNetV2-tiny at
                   width 1.0, batch 128, 2 calibration batches and 3 steps,
                   with the launch counters zeroed just before and read
                   just after; one more step under torch.profiler (device
                   time by kernel family, the depthwise convs' share, idle
                   share); ResNet18-tiny and VGG16-tiny one step each
 11. cnn parity    two steps of a reduced MobileNetV2, fused vs simulated
                   backend, with TF32 switched on globally: bit-equal
                   losses, quant and BN states and parameters; the conv
                   site's fp32 products checked against float64
 12. tele train    phase 7's run with --telemetry --guard, the launch
                   counters zeroed just before and read just after: the
                   JSONL checked (finite counters, every attention p-site
                   with the kernel's exact count) and rendered by
                   repro_torch.telemetry.report; then the steady step with
                   telemetry off and on, in turns (overhead, not gated)
 13. tele cnn      phase 10's MobileNetV2-tiny run with --guard: 106
                   width-10 quant leaves, the JSONL rendered, the overhead
 14. tele serve    phase 4's prefill with --telemetry PATH: per-site
                   records, the p-sites' exact counters
 15. guard parity  fused vs simulated with telemetry and a guard that fires
                   (threshold 0, patience 1): phase 11's reduced
                   MobileNetV2 for 3 steps, bit-equal width-10 quant trees
                   and equal guard events (widens among them); phase 8's
                   LM configuration, one forward + backward, the telemetry
                   slots within stated limits
 16. checkpoint    starcoder2-3b at full width, depth cut to 1 layer: a
                   3-step run uninterrupted (twice: does it repeat bit for
                   bit?), the same run with --ckpt-dir --ckpt-every 1
                   preempted (SIGTERM) after step 2, its restored state
                   against its in-memory one, --resume to step 3 against
                   the uninterrupted run, save and restore times, then
                   launch.serve --ckpt-dir against serving from memory
 17. moe serve     repro_torch.launch.serve.main(...) on qwen2-moe-a2.7b at
                   full width and depth (24 layers, 60 experts top-4 on the
                   int8 matmul's batch dimension, 14.31 B parameters), batch
                   4 x 1024-token prompts, 8 generated, with the launch
                   counters zeroed just before and read just after
 18. moe parity    phase 17's prefill logits, fused vs simulated on the
                   same parameters, and the share of layer 0's routing
                   decisions on which the backends agree
 19. moe train     repro_torch.launch.train.main(...) on qwen2-moe-a2.7b at
                   full width with depth cut to 2 layers: 3 AdamW steps
                   (aux and z losses), the launch counters zeroed just
                   before and read just after; one more step profiled
                   (families, idle share, the experts' int8 contractions);
                   phase 8's fused-vs-simulated check at 1 layer
 20. sc7 serve     starcoder2-7b at full width, depth cut to 16 of its
                   32 layers: launch.serve.main fused at 4 x 1024, then
                   serve.generate at 1 x 8192 (two windows: the int8 core's
                   sliding mask masks; decode on a wrapped 4096-slot ring),
                   8 and 32 generated, the launch counters zeroed just
                   before and read just after each
 21. sc7 parity    phase 20's 1 x 8192 run, fused vs simulated on the same
                   parameters: prefill logits and the 32 greedy tokens
 22. sc7 fp32      the fp32 policy (serve --policy fp32) at 1 x 8192 on
                   phase 20's parameters: every layer's prefill attention
                   through _local_attn, layer 0's held against _dense_attn
 23. command-r     command-r-35b at full width, 8 layers: serve --policy
                   fp32 at 1 x 8192 (_chunked_attn, layer 0 held against
                   _dense_attn), then fused at 4 x 1024 on the same
                   parameters
 24. nemotron      nemotron-4-340b at full width, 1 layer (12.89 B
                   parameters): serve.main fused at 1 x 1024, 4 generated;
                   the attention kernel at hd 192 on a model path
 25. long train    launch.train.main on starcoder2-7b at full width, 2
                   layers, --policy current --backend simulated at 1 x 8192
                   (3 steps through _local_attn, forward and backward); one
                   step each under QuantPolicy.grad_only / act_only
                   ("hindsight", fused), whose turned-off sites stay
                   uninitialized
 26. hybrid serve  recurrentgemma-9b at full width, depth cut to 18 of
                   its 38 layers (six rec, rec, local units: 12 RG-LRU
                   blocks and 6 local-attention blocks at hd 256, 16 q
                   heads on 1 kv head):
                   launch.serve.main fused at 4 x 1024, then
                   serve.generate at 1 x 8192 (four windows: the int8
                   core's sliding mask masks, each 2048-slot ring wraps,
                   the recurrent state carries through decode), 8 and 32
                   generated, the launch counters zeroed just before
                   and read just after each; one 1 x 8192 prefill and one
                   decode step profiled (families, idle share, the scan's
                   share)
 27. hybrid parity phase 26's 1 x 8192 run, fused vs simulated on the same
                   parameters (prefill logits, the 32 greedy tokens);
                   rglru_scan against a sequential fp32 loop on the first
                   RG-LRU block's operands of that prefill [1, 8192,
                   4096]; prefill-then-decode consistency at full width,
                   depth cut to 3 layers, under QuantPolicy.disabled()
 28. hybrid train  launch.train.main on recurrentgemma-9b at full width,
                   depth cut to 3 layers (one rec, rec, local unit), fused
                   hindsight W8A8G8 at 2 x 4096 (past the window), AdamW,
                   3 steps, the launch counters zeroed just before and
                   read just after; one more step profiled
 29. rwkv serve    rwkv6-7b at full width, depth cut to 16 of its 32
                   layers: launch.serve.main fused at 4 x 1024, then
                   serve.generate at 1 x 32768 (the WKV state and the
                   token-shift rows carry through decode), 8 generated
                   each, the launch counters zeroed just before and read
                   just after each (int8_matmul_fp: 8 projections x 16
                   layers x 8 forwards = 1024); one 1 x 32768 prefill and
                   one decode step profiled (families, idle share, the
                   WKV's share)
 30. rwkv parity   on phase 29's parameters, a fused 1 x 8192 run against
                   the simulated backend (prefill logits rel L2 <= 1e-3,
                   the 32 greedy tokens); wkv_chunked against wkv_step
                   token by token on layer 0's operands of that prefill
                   [1, 64, 8192, 64]; prefill-then-decode consistency at
                   full width, depth cut to 3 layers, under
                   QuantPolicy.disabled() (fp32 compute with fp32 mixes
                   held; the model's bf16 mixes in fp32 and bf16 compute
                   reported)
 31. rwkv train    launch.train.main on rwkv6-7b at full width, depth cut
                   to 4 layers (1.42 B parameters), fused hindsight W8A8G8
                   at 2 x 4096, AdamW, 3 steps, the launch counters zeroed
                   just before and read just after; one more step
                   profiled (with the WKV's share); phase 8's fused vs
                   simulated forward and backward at 1 layer
 32. encdec serve  seamless-m4t-medium at full width and depth (12
                   encoder + 12 decoder layers, 0.878 B parameters):
                   launch.serve.main fused at 4 x 1024 with 32 generated
                   (1056 frames: the encoder bidir, the cross core at
                   1024 x 1056), then serve.generate at 1 x 32768 frames
                   with a 1-token decoder prompt and cache_len 32768, 8
                   generated (cross decode attends the whole cached
                   encoder), the launch counters zeroed just before and
                   read just after each (int8_attention 36 and 12); the
                   32768 prefill and one decode step profiled (families,
                   idle share, the encoder attention's share)
 33. encdec parity phase 32's 4 x 1024 run, fused vs simulated on the same
                   parameters (prefill logits rel L2 <= 1e-3, the 32
                   greedy tokens); prefill-then-decode consistency at full
                   width, depth cut to 3 + 3 layers, under
                   QuantPolicy.disabled() (fp32 held, bf16 reported)
 34. encdec train  launch.train.main on seamless-m4t-medium at full width
                   and depth, fused hindsight W8A8G8 at 2 x 4096 (4096
                   frames and tokens; the head's N = 256206 on the int8
                   matmul), AdamW, 3 steps, the launch counters zeroed just
                   before and read just after; one more step profiled;
                   phase 8's fused vs simulated at 1 + 1 layers
 35. vlm serve     paligemma-3b at full width and depth (18 layers, 2.511
                   B parameters): launch.serve.main fused at 4 x 1024 with
                   32 generated as the reference's driver does it (256
                   patches + 800 text tokens; decode from position 1280),
                   the prefix core on the wide kernel (hd 256, G = 8; 18
                   launches); one prefill and one decode step profiled
 36. vlm parity    phase 35's run, fused vs simulated (prefill logits, the
                   32 greedy tokens); prefill-then-decode consistency at
                   full width, 3 layers, fp32 held (bf16 reported), at the
                   true position
 37. vlm train     launch.train.main on paligemma-3b at full width and
                   depth, fused hindsight W8A8G8 at 2 x 2048 (256 patches +
                   1792 text tokens), AdamW, 3 steps, the launch counters
                   zeroed just before and read just after; one more step
                   profiled; phase 8's fused vs simulated at 1 layer
 38. tall serve    launch.serve.main on starcoder2-3b at full width and
                   depth, 4 x 200 prompt (the tuner's (256, 128): q blocks
                   of 200 rows on the attention kernel's tall
                   instantiation), 7 decode steps, the launch counters
                   zeroed just before and read just after (30 attention
                   launches); fused vs simulated on the same parameters
                   (prefill logits, the greedy tokens)
 39. compress      runtime.compress on one full-width starcoder2-3b
                   layer's gradient-shaped leaves: 2 gloo ranks on the card
                   (spawned, FileStore under build/chip_smoke/; in phase
                   40's spawn when 40 runs), then a 1-rank NCCL group
                   (of rank 0 there); the step-0 and hindsight calls bit
                   for bit against the plain one-process emulation,
                   stochastic_quantize launches counted, the mean over 10
                   seeds within 5% of the fp32 mean; quantize / dequantize
                   ms per tree and the intra-card gloo collective's ms
 40. dp train      runtime.steps' data-parallel step on starcoder2-3b at
                   full width, 2 layers, 4 x 1024, 2 gloo ranks against one
                   process on the whole batch: the quant state bit for bit,
                   the loss within 1e-6, the parameters after one AdamW
                   step within 2 lr (tests/test_torch_dp.py's bound), the
                   train kernels counted; then once with compress against
                   its emulation; then ZeRO-3 in the same spawn: a fresh
                   stored state saved from its shares (the whole-leaf
                   file), restored in one process bit for bit the
                   one-process state, and the stored step
                   (sharding.store_state) with int8_weight_gather off
                   against the one-process step and on against the
                   replicated DP step (its products run the fp path, whose
                   GEMMs round by shape): quant state bit for bit,
                   gradients and params within the DP step's bars; stored
                   bytes and peak GiB a rank against the replicated DP
                   rank's (both must be lower), the gathers' and
                   reduce-scatters' ms
 41. decode cells  the reference's shape matrix: configs.cells() admits
                   long_500k for the four sub-quadratic archs and refuses
                   it for the six others with the reference's reason; the
                   decode cells one card holds, at full width and depth,
                   through runtime.steps.make_decode_step on inputs shaped
                   by configs.input_specs: long_500k (B 1 from position
                   524287) on starcoder2-3b, starcoder2-7b,
                   recurrentgemma-9b and rwkv6-7b, decode_32k (B 128 from
                   position 32767, a 4096-slot ring) on starcoder2-3b; the
                   cache one window prefilled through make_prefill_step
                   and re-based to end one position before (K rotated with
                   the port's apply_rope, the ring's slots rolled); 3 steps
                   past the ring's wrap, simulated vs fused on the same
                   cache (logits, greedy tokens), ms a step, peak GiB, the
                   re-basing gap, every int8 product of a step on the row
                   tile the tuner and the clamp give (16 at B 1, 128 at
                   B 128), the launch counters zeroed just before and read
                   just after
 42. general attn  the attention kernel's general instantiation (bkv in
                   (128, 512], bq above 256, hd in (256, 512]) against its
                   plain version at [8, 1024, 512] on bkv 512, [16, 1024,
                   128] on bkv 256 and on bq 512, and hd 320: m and
                   min/max/clip/n exact, out, l and err/sig within their
                   tolerances; ms beside its bound, its plain version and
                   bf16 SDPA; then the query offset at phase 47's shape
                   ([96, 128, 128] at q_start 896 against [8, 1024, 128],
                   sliding at window 4096): the rows bit for bit the
                   kernel's whole call's, held against the plain offset
                   call, timed beside its bound and bf16 SDPA on the rows
 43. tp serve      the model axis: starcoder2-3b at full width and depth
                   over 2 gloo ranks on the card (model 2: a KV head, half
                   the MLP's columns and of the vocabulary each; the
                   row-parallel products on the int32 mode and its
                   epilogue), through runtime.steps.make_prefill_step /
                   make_decode_step(model_group=): prefill of phase 4's
                   4 x 1024 prompt and 7 greedy decode steps against phase
                   4's kept outputs (statistics bit for bit, prefill
                   logits within 1e-5 rel L2, the 8 tokens identical);
                   each rank's peak GiB, its gloo collectives' ms (host
                   copies), the launch counters zeroed just before and
                   read just after
 44. tp train      make_train_step(group=, model_group=) of
                   qwen2-moe-a2.7b at full width, 1 layer, 4 x 1024 on
                   (1, 2) (30 experts a rank), then reduced on (2, 2), gloo
                   ranks on the card, against the one-process step on rank
                   0: activation-site quant state bit for bit, gradient
                   sites within 1e-5 of the largest element, the loss
                   within 1e-5 relative, the clipped gradients within 2**-7
                   relative L2 or 4 x the one-process step's own distance
                   under another fp32 association of its backward (and
                   doubled or halved gradients refused); first and warm
                   steps timed; then in the (2, 2) spawn the reduced
                   model's stored (ZeRO-3) step with expert parallelism
                   against one process with the same bars (the clipped
                   gradients within 2**-7), the params within 2 lr
 45. tp rglru      recurrentgemma-9b at full width, 3 layers (one rec,
                   rec, local unit), on (1, 2) gloo ranks: the RG-LRU's
                   channels over the ranks (w_a / w_x on their input
                   channels, int32 partials summed), the local attention
                   on the G heads; served 4 x 1024 + 7 decode steps
                   against one process (prefill statistics bit for bit,
                   each rank's h / conv / KV its slice of the one-process
                   cache, logits within 1e-5 rel L2, tokens identical),
                   then one 4 x 1024 train step with phase 44's bars,
                   each the larger of its fixed value and 4 x the
                   one-process step's own floor for what it holds (the
                   gradient-site leaves' worst; each gradient tensor's),
                   doubled or halved gradients refused by some tensor
 46. tp rwkv       rwkv6-7b at full width, 2 layers, on (1, 2): the time
                   mix's heads (the WKV, its state, the group norm) and
                   the channel mix's d_ff over the ranks; phase 45's runs
                   and bars
 47. seq train     starcoder2-3b (KV 2, G 12) at full width, 2 layers, on
                   (1, 8) gloo ranks: the sequence-parallel attention core
                   (each rank its 128 rows: the projections, RoPE at its
                   positions, k / v gathered, the offset kernel, the o
                   projection, the output gathered; the whole attention
                   weights' gradients summed), one 4 x 1024 train step
                   with phase 45's bars
 48. padded        (phase 47's spawn) the same model on padded heads (G 12
                   over 8: ranks 0-5 two heads, 6-7 none, no attention
                   launch there): a 4 x 1024 prefill on the int8 core into
                   a 1032-slot cache (129 slots a rank) against one
                   process (statistics, each rank's cache slots and the
                   logits bit for bit), 8 greedy decode steps over the
                   length-sharded cache (tokens identical, logits within
                   the larger of 1e-5 and 4 x the one-process decode's
                   distance from itself with its sums over L in 8 blocks;
                   the last step with wo doubled, and with rank 5's o
                   partial dropped, refused), then one 1 x 8192 train
                   step past the 4096 window (the sliding int8 core) with
                   phase 45's bars (rank 5's share of the padded tensors
                   dropped refused); then qwen2-moe-a2.7b at full width,
                   1 layer, its 60 experts split 8 x 7 + 4 over the 8
                   ranks (split_range): a 4 x 1024 prefill and 4 greedy
                   decode steps against one process (statistics bit for
                   bit, tokens identical), int8_matmul_fp launches by rank
 49. dryrun        python -m repro_torch.launch.dryrun (fake tensors on the
                   card's device under a fake process group, CostMode)
                   for starcoder2-3b train_4k on both production meshes
                   (256 and 512 ranks; the cell's own global batch and
                   microbatches, depth cut to 4 layers, printed) and
                   again on 16 x 16 with --seq-shard (its per-device
                   bytes below the unsharded trace's, more
                   reduce-scatters), in
                   subprocesses started after phase 3 that run beside
                   phases 4-48 (they need no kernel, only host time;
                   a timer kills what outlives DRYRUN_TIMEOUT): status ok,
                   rank 0's FLOPs, bytes, collective bytes by kind and
                   per-device bytes printed; and phase 40's configuration
                   (2 layers, 4 x 1024, (2, 1), ZeRO-3): its
                   stored_state_bytes equal byte for byte the parameters
                   and AdamW moments phase 40's rank 0 stores on the card
 50. seq shard     (phase 47's spawn) starcoder2-3b at full width, 2
                   layers, on (1, 8) with seq_shard (make_prefill_step /
                   make_decode_step / make_train_step: the residual
                   stream at every block boundary each rank's 128 rows,
                   or decode's one row on rank 0; the normed rows
                   gathered into each sublayer, its row-parallel product
                   reduce-scattered out on the int32 mode and its
                   epilogue): phase 48's 4 x 1024 prefill into the
                   1032-slot cache (statistics, cache slots and logits
                   bit for bit) and 8 greedy decode steps (tokens
                   identical, logits within phase 48's bars; rank 0's
                   share of every reduce-scatter dropped refused), then
                   phase 47's 4 x 1024 train step with phase 45's bars;
                   each rank's peak GiB and gloo ms beside phase 47's

Phase 39 runs its ranks in phase 40's spawn of 2 processes (its own
two spawns when 40 does not run), 43-46 their (1, 2) ranks in one spawn
of 2 processes (44's (2, 2) run in one of its own), 47-48 and 50 theirs
in one of 8; each phase's seconds are its share of the spawn and its
checks.  The main process only waits on a spawn, so 47-48 and 50's spawn
runs in a thread beside phase 16, 39-40's beside phases 32-36 and 38, and 44's
(2, 2) spawn beside 37 (:class:`Beside`; each pair's peaks fit the
card's memory together);
the checks of the spawned phases run after their ranks end.  The CNN
phases (10, 11, 13) run beside the attention source's nvcc, once the
other sources are built.  The phases run beside a spawn or a build
share the card or the host with it: their times are not those of the
card alone.

Phase 3 also holds ``int8_conv_fp`` (the conv site, im2col onto the int8
matmul kernel) against its plain version at four MobileNetV2-tiny layer
shapes, ``int8_matmul_fp`` at the MoE experts' shapes ``[B 60, M 552, K,
N]`` and decode's ``[60, 4, 2048, 1408]``, and the attention core at
qwen2-moe's G = 1 prefill shape and above hd 128: nemotron-4-340b's
``[96, 1024, 192]`` (G = 12) and hd 256 at G = 8, and the hybrid's
shapes: the attention core at ``[64, 1024, 256]`` and ``[16, 8192, 256]``
(G = 16, sliding at window 2048) and ``int8_matmul_fp`` at the RG-LRU's
4096 x 4096 x 4096 and the GeGLU's 4096 x 4096 x 12288, and rwkv6-7b's
channel mix: 4096 x 4096 x 14336 (key) and 4096 x 14336 x 4096 (value),
and the frontend families': the attention core bidir at ``[64, 1056,
64]`` and ``[16, 32768, 64]``, cross at ``[64, 1024 x 1056, 64]`` and
prefix at ``[32, 1056, 256]`` (G = 8, prefix 256), ``int8_matmul_fp`` at
``enc_in`` 8192 x 160 x 1024, ``patch_proj`` 1024 x 1152 x 2048 and
seamless's head chunk 1024 x 1024 x 256206 (N not a multiple of 8),
and every tile of the int8 matmul (row tiles 128, 64, 32 and 16, which
``kernels.tuning.matmul_block`` and the row clamp choose among) at
decode ``[1, 4, 3072, 12288]``, the experts' ``[60, 4, 2048, 1408]``,
``[1, 128, 3072, 12288]``, ``[1, 552, 2048, 1408]`` and ``4096 x 3072 x
12288`` and at one MobileNetV2-tiny conv (with a ``REPRO_MM_BLOCK`` pin
honoured, a bad one refused and ``REPRO_TUNE=benchmark``), and the
attention core at hd 200 (padded to 208 by its wrapper).  The
``int8_matmul_fp`` and ``int8_matmul_fused`` records carry a ``tiles``
list: every tile with its time, bound and launches.
The line before the last is the
kernels' JSON record; the last line is ``{"ok": true, "device":
{...}}``.  Any failure raises (exit code != 0)
and prints no result; so does a machine without a CUDA card.

    python3 chip_smoke.py [--out results.json] [--phases 1-3]

``--phases`` runs only the named phases (a list of numbers and ranges,
e.g. ``1-3`` to build and check the kernels without serve and train);
phase 1 always runs, 5-6 and 43 bring 4 along, whose serve run they
reuse, 18 brings 17, 21-22 bring 20, 27 brings 26, 30 brings 29, 33
brings 32, 36 brings 35 and 49 brings 40.  Kernels whose path phases
did not run report ``"launches": null``.  The default is all 49;
phases 12-16 and 39-40, 43-49 write their logs, checkpoints and rank records under
``build/chip_smoke/`` and remove the checkpoints when done.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

# Phase 16 may run under torch.use_deterministic_algorithms, which needs
# cuBLAS's workspace configured before its first use.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (dense): HBM bytes/s, int8 tensor-core ops/s,
# fp32 (non-tensor-core) ops/s.
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
FP32_OPS = 67e12

PROMPT, GEN, BATCH = 1024, 32, 4
# Decode steps of the serve runs that read only throughput (the runs whose
# greedy tokens a parity phase compares keep GEN).
GEN_RATE = 8
TRAIN_STEPS, PARITY_LAYERS, LAYER_STEPS = 3, 4, 4

# The kernels each path launches (the int8 matmuls' wrappers launch the
# weight's K-major transpose first).
SERVE_KERNELS = ("fused_quantize", "int8_transpose", "int8_matmul_fp",
                 "int8_attention")
TRAIN_KERNELS = SERVE_KERNELS + ("stochastic_quantize",)
# Sources whose products run on the tensor cores (mma_int8.cuh).
TENSOR_CORE_SOURCES = ("int8_matmul", "int8_attention")
LAYER_KERNELS = ("int8_transpose", "int8_matmul_fused")
# The CNN train path: every conv and the fc on int8_matmul_fp (with the
# weight's transpose), the quantizers and the gradient barriers.
CNN_KERNELS = ("fused_quantize", "int8_transpose", "int8_matmul_fp",
               "stochastic_quantize")
CNN_BATCH, CNN_STEPS, CNN_PARITY_STEPS = 128, 3, 2
GUARD_STEPS, CKPT_LAYERS = 3, 1
# The MoE family: qwen2-moe-a2.7b served at full depth; its train step at
# full width with depth cut (AdamW at 24 layers needs ~229 GB).
MOE_ARCH, MOE_TRAIN_LAYERS, MOE_PARITY_LAYERS = "qwen2-moe-a2.7b", 2, 1
# The dense family past its window: starcoder2-7b at full size (its train
# step at full width, depth cut), command-r-35b at full width with depth
# cut to what fits beside a 17 GB score tile, nemotron-4-340b at 1 layer.
LONG_ARCH, LONG_SEQ, LONG_TRAIN_LAYERS = "starcoder2-7b", 8192, 2
# The serve runs of phases 20-22, 26-27 and 29-30 at full width, depth cut
# to half (recurrentgemma-9b: six (rec, rec, local) units) to make room
# for phases 45-47 in the script's time.
SC7_SERVE_LAYERS, HYB_SERVE_LAYERS, RWKV_SERVE_LAYERS = 16, 18, 16
CMDR_ARCH, CMDR_LAYERS = "command-r-35b", 8
NEMO_ARCH, NEMO_GEN = "nemotron-4-340b", 4
# The hybrid family: recurrentgemma-9b served at full depth (9.40 B
# parameters fit one card); its train step at full width, depth cut to
# one (rec, rec, local) unit (~27 GB with its AdamW state), past the window.
HYB_ARCH, HYB_CUT, HYB_TRAIN_BATCH, HYB_TRAIN_SEQ = \
    "recurrentgemma-9b", 3, 2, 4096
SCAN_RANGE = "rglru_scan"
# The RWKV-6 family: rwkv6-7b served at full depth (7.58 B parameters) at 4
# x 1024 and 1 x 32768 (the reference's prefill_32k length, batch cut to
# 1); parity at 1 x 8192; decode-vs-prefill at 3 layers; its train step at
# full width, depth cut to 4 layers (~23 GB with AdamW; 32 layers need
# ~121 GB).  The path is attention-free: no int8_attention launch.
RWKV_ARCH, RWKV_LONG, RWKV_CUT = "rwkv6-7b", 32768, 3
RWKV_TRAIN_LAYERS, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ = 4, 2, 4096
RWKV_PARITY_LAYERS = 1
RWKV_SERVE_KERNELS = ("fused_quantize", "int8_transpose", "int8_matmul_fp")
RWKV_TRAIN_KERNELS = RWKV_SERVE_KERNELS + ("stochastic_quantize",)
# The enc-dec family: seamless-m4t-medium served at full width and depth
# (12 + 12 layers) at 4 x 1024 (1056 frames) and at 1 x 32768 frames with
# a 1-token decoder prompt (the reference's prefill_32k input, batch cut
# to 1); decode-vs-prefill at 3 + 3 layers; its train step at full width
# and depth (0.878 B parameters, ~14 GB with AdamW), 2 x 4096.
ENC_ARCH, ENC_LONG, ENC_CUT = "seamless-m4t-medium", 32768, 3
ENC_TRAIN_BATCH, ENC_TRAIN_SEQ = 2, 4096
# The VLM family: paligemma-3b (256 image patches as a prefix) served at
# full width and depth; decode-vs-prefill at 3 layers; its train step at
# full width and depth (2.511 B parameters, ~40 GB with AdamW), 2 x 2048
# (256 patches + 1792 text tokens).
VLM_ARCH, VLM_CUT = "paligemma-3b", 3
VLM_TRAIN_LAYERS, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ = 18, 2, 2048
# The repaired tall attention tile: starcoder2-3b served at full width
# and depth on a 4 x 200 prompt (the tuner's (256, 128): bq 200), 7 decode
# steps.  Distribution: the int8 gradient collective on one full-width
# starcoder2-3b layer's gradient-shaped leaves (2 gloo ranks on the card,
# then a 1-rank NCCL group), 10 seeds for its mean; the data-parallel
# train step at full width, depth cut to 2 layers, 4 x 1024, 2 gloo ranks.
TALL_SEQ, TALL_GEN = 200, 8
COMP_SEEDS, DP_LAYERS, DP_LR = 10, 2, 1e-3
# phase 49: the dry run's train cell at its own global batch and
# microbatches, depth cut (a full-depth trace takes minutes of host time
# a run: PERF.md section 5); and the seconds after which a timer kills a
# run that has not ended
DRYRUN_ARCH, DRYRUN_LAYERS = "starcoder2-3b", 4
DRYRUN_TIMEOUT = 600
# The reference's shape matrix (configs.SHAPES): the decode cells one card
# holds at full width and depth, through runtime.steps.make_decode_step on
# inputs shaped by configs.input_specs: long_500k (B 1 at position
# 524287) on the four archs configs.supports admits, and decode_32k (B
# 128 against a 32768-position cache, a 4096-slot ring) on starcoder2-3b.
# The cache is one real window, prefilled (decode_32k's for 8 rows, tiled
# to 128), re-based to end at the position before the cell's.
DECODE_CELLS = (("long_500k", "starcoder2-3b"), ("long_500k", "starcoder2-7b"),
                ("long_500k", "recurrentgemma-9b"), ("long_500k", "rwkv6-7b"),
                ("decode_32k", "starcoder2-3b"))
LONG_500K_ARCHS = {"starcoder2-3b", "starcoder2-7b", "recurrentgemma-9b",
                   "rwkv6-7b"}
LONG_500K_REFUSED = {"command-r-35b", "moonshot-v1-16b-a3b", "nemotron-4-340b",
                     "paligemma-3b", "qwen2-moe-a2.7b", "seamless-m4t-medium"}
CELL_REFUSAL = ("full attention: 512k decode needs an O(S) KV cache per "
                "token; skipped per assignment rules")
# (3 steps a run: cut from 7 to make room for phases 45-47)
CELL_STEPS, CELL_PREFILL_ROWS, RWKV_CELL_WINDOW = 3, 8, 2048
# The decode path's kernels (decode attention is the plain core).
DECODE_KERNELS = ("fused_quantize", "int8_transpose", "int8_matmul_fp")
# The attention kernel's general instantiation (phase 42): [8, 1024, 512]
# on bkv 512, [16, 1024, 128] on bkv 256 and on bq 512, and hd 320, each
# at batch 1 and S = 1024 (causal).
GENERAL_SEQ = 1024
GENERAL_TILES = (("hd512-bkv512", 8, 2, 512, (128, 512)),
                 ("hd128-bkv256", 16, 2, 128, (128, 256)),
                 ("hd128-bq512", 16, 2, 128, (512, 128)),
                 ("hd320", 8, 2, 320, (128, 128)))
# The model axis (phases 43-44): gloo ranks on the one card.  Serve:
# starcoder2-3b at full width and depth on (1, 2); train: qwen2-moe-a2.7b
# at full width, depth 1, 4 x 1024 on (1, 2), then reduced on (2, 2) at 4
# x 32.  The kernels of the sharded path (the row-parallel products run
# the int32 mode and its epilogue).
TP_SIZE = 2
TP_KERNELS = SERVE_KERNELS + ("int8_matmul_int32", "int8_matmul_epilogue")
TP_TRAIN_RUNS = (("full", (1, 2), False, 1, BATCH, PROMPT),
                 ("reduced", (2, 2), True, 0, 4, 32))
# The sharded step's clipped gradients are held within 2**-7 relative L2
# of the one-process step's, or within this many times the one-process
# step's own distance from itself under another fp32 association of its
# backward (stochastically rounded gradients carry any reordering's flips
# down the layers: tests/test_torch_tp.py, PERF.md).
TP_FLOOR_MARGIN = 4.0
# The model axis of the recurrent kinds (phases 45-46): recurrentgemma-9b
# and rwkv6-7b on (1, 2) at full width, depth cut to one pattern unit
# (rec, rec, local) and to 2 layers (the one-process step and AdamW
# beside both ranks', and the time budget); served 4 x 1024 + 7 decode
# steps, then one 4 x 1024 train step.  The sequence-parallel core (phase
# 47): starcoder2-3b (KV 2, G 12) on (1, 8) at full width, 2 layers, one
# 4 x 1024 train step; the last rank's rows are phase 42's offset shape.
TP_FAMILY = (
    (45, "recurrentgemma-9b", 3, TP_KERNELS + ("stochastic_quantize",)),
    (46, "rwkv6-7b", 2, RWKV_SERVE_KERNELS + (
        "int8_matmul_int32", "int8_matmul_epilogue", "stochastic_quantize")))
SEQ_ARCH, SEQ_SIZE, SEQ_LAYERS = "starcoder2-3b", 8, 2
# Padded head sharding (phase 48, in phase 47's spawn): starcoder2-3b (G
# 12 over 8: 2 heads on ranks 0-5, none on 6-7) at full width, 2 layers,
# on (1, 8): a 4 x 1024 prefill into a 1032-slot cache (129 slots a rank:
# the length-sharded cache), 8 greedy decode steps, then one 1 x 8192
# train step past the 4096 window (the local path, the sliding int8
# core).  The decode logits' fixed bar (rel L2), beside 4 x the
# one-process decode's own floor with its sums over L in 8 blocks.
PAD_LAYERS, PAD_GEN, PAD_TRAIN_SEQ, PAD_LOGITS_TOL = 2, 8, 8192, 1e-5
# Uneven expert shares (phase 48, in the same spawn): qwen2-moe-a2.7b at
# full width, 1 layer, on (1, 8): its 60 experts split 8 x 7 + 4; a 4 x
# 1024 prefill and 4 greedy decode steps against one process.
UNEVEN_LAYERS, UNEVEN_GEN = 1, 4
# Phase 4's one-process outputs, kept for phase 43.
KEPT: dict = {}
N_PHASES = 50
# Where phases 12-16 write their JSONL logs and checkpoints (git-ignored).
OUT_DIR = ROOT / "build" / "chip_smoke"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int, warmup: int = 1, keep: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls.  With
    ``keep``, every call's outputs stay allocated until the end, so no call
    writes into memory the previous one left in L2; a first untimed round
    of ``reps`` kept calls fills PyTorch's allocator cache, so the timed
    round allocates no device memory (a cudaMalloc would be timed too)."""
    for _ in range(warmup):
        fn()
    if keep:
        kept = [fn() for _ in range(reps)]
        torch.cuda.synchronize()
        del kept
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    kept = []
    start.record()
    for _ in range(reps):
        out = fn()
        if keep:
            kept.append(out)
    end.record()
    torch.cuda.synchronize()
    del kept
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn``'s launches, captured once in a CUDA graph
    and replayed ``reps`` times: no host time between launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, reps)
    del graph
    return ms


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: each kernel at the slice's shapes.
# ---------------------------------------------------------------------------
def check_fused_quantize(dev, gen, cfg):
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels import fused_quantize as fq
    from repro_torch.kernels import ops

    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv
    m = BATCH * PROMPT
    act = QuantSpec(bits=8, symmetric=False)
    sym = QuantSpec(bits=8, symmetric=True)
    shapes = [  # (what, shape, spec): prefill acts, attention q/k/v, weights
        ("act d", (m, d), act), ("act ff", (m, f), act),
        ("attn q/o", (m * nh, hd), act), ("attn k/v", (m * nkv, hd), sym),
        ("wq", (d * nh, hd), sym), ("wk/wv", (d * nkv, hd), sym),
        ("wo", (d, d), sym), ("w_up", (d, f), sym), ("w_down", (f, d), sym),
        ("embed", (v, d), sym), ("head", (d, v), sym),
        ("decode act", (BATCH, d), act), ("decode ff", (BATCH, f), act)]
    worst = 0.0
    for what, shape, spec in shapes:
        x = torch.randn(shape, generator=gen, device=dev) * 2.0
        lo, hi = (-3.0, 5.0) if not spec.symmetric else torch.aminmax(x)
        qp = ops._qparams(torch.as_tensor(lo, device=dev),
                          torch.as_tensor(hi, device=dev), spec)
        qk, mnk, mxk = fq.fused_quantize_cuda(x, qp, spec)
        qr, mnr, mxr = fq.fused_quantize_plain(x, qp, spec)
        torch.cuda.synchronize()
        err = (qk.to(torch.int32) - qr.to(torch.int32)).abs().max().item()
        if err != 0 or not (torch.equal(mnk, mnr) and torch.equal(mxk, mxr)):
            raise AssertionError(f"fused_quantize {what} {shape}: max |dq| "
                                 f"{err}, min/max {mnk.item()}/{mnr.item()} "
                                 f"{mxk.item()}/{mxr.item()}")
        worst = max(worst, err)
    log("kernels", f"fused_quantize: {len(shapes)} shapes bit-exact "
                   f"(images and min/max)")
    # Timed at the largest activation site, the MLP hidden [4096, 12288].
    x = torch.randn((m, f), generator=gen, device=dev) * 2.0
    qp = ops._qparams(torch.tensor(-3.0, device=dev),
                      torch.tensor(5.0, device=dev), act)
    ms = time_ms(lambda: fq.fused_quantize_cuda(x, qp, act), 20)
    plain_ms = time_ms(lambda: fq.fused_quantize_plain(x, qp, act), 5)
    n = x.numel()
    b_ms, b_by = bound(n * 4 + n, n * 5, FP32_OPS)
    return dict(name="fused_quantize", route="cuda",
                source="src/repro_torch/csrc/fused_quantize.cu",
                replaces="src/repro/kernels/fused_quantize.py:64",
                shape=[m, f], max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_stochastic_quantize(dev, gen, cfg):
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import stochastic_quantize as sq

    d, f, hd, nkv = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_kv
    m = BATCH * PROMPT
    spec = QuantSpec(bits=8, symmetric=False, stochastic=True)
    shapes = [  # (what, shape, bf16 input): the gradient sites of a step
        ("grad d", (m, d), False), ("grad ff", (m, f), False),
        ("grad k/v", (m, nkv * hd), False), ("ragged", (4093, 3001), False),
        ("bf16 grad d", (m, d), True)]
    qp = ops._qparams(torch.tensor(-2.5e-3, device=dev),
                      torch.tensor(3e-3, device=dev), spec)   # clips tails
    for what, shape, bf16 in shapes:
        x = torch.randn(shape, generator=gen, device=dev) * 1e-3
        if bf16:
            x = x.to(torch.bfloat16).to(torch.float32)
        u = torch.rand(shape, generator=gen, device=dev)
        qk, mnk, mxk = sq.stochastic_quantize_cuda(x, qp, u, spec)
        qr, mnr, mxr = sq.stochastic_quantize_plain(x, qp, u, spec)
        torch.cuda.synchronize()
        if not (torch.equal(qk, qr) and torch.equal(mnk, mnr)
                and torch.equal(mxk, mxr)):
            n_bad = int((qk != qr).sum())
            raise AssertionError(f"stochastic_quantize {what} {shape}: "
                                 f"{n_bad} images differ, min/max "
                                 f"{mnk.item()}/{mnr.item()} "
                                 f"{mxk.item()}/{mxr.item()}")
    log("kernels", f"stochastic_quantize (operand form): {len(shapes)} "
                   f"shapes bit-exact (images and min/max) with the same "
                   f"noise")

    # On-chip Philox form: statistics only (its noise has no plain twin).
    x = torch.randn((m, f), generator=gen, device=dev) * 1e-3
    lo, hi = torch.aminmax(x)
    qp_full = ops._qparams(lo, hi, spec)
    q1, mn1, mx1 = ops.stochastic_quantize(x, lo, hi, None, spec=spec,
                                           on_chip_prng=True, seed=5)
    q2, _, _ = ops.stochastic_quantize(x, lo, hi, None, spec=spec,
                                       on_chip_prng=True, seed=6)
    if not (torch.equal(mn1, lo) and torch.equal(mx1, hi)):
        raise AssertionError("stochastic_quantize on-chip: min/max differ")
    err = (q1.to(torch.float32) - qp_full[1]) * qp_full[0] - x
    mean, sigma = err.double().mean().item(), err.double().std().item()
    bound4 = 4.0 * sigma / math.sqrt(err.numel())
    if not abs(mean) <= bound4:
        raise AssertionError(f"on-chip rounding biased: mean {mean:.3e} > "
                             f"4 sigma/sqrt(n) {bound4:.3e}")
    diff_seeds = (q1 != q2).float().mean().item()
    if not diff_seeds > 0.2:
        raise AssertionError(f"seeds 5 and 6 give {diff_seeds:.4f} "
                             f"differing elements")
    # A constant input half a level above a grid point rounds up iff its
    # u >= 0.5: the image is the noise's top bit, tile by tile.
    c = torch.full((m, f), 0.5, device=dev)
    qc, _, _ = ops.stochastic_quantize(c, torch.tensor(0.0, device=dev),
                                       torch.tensor(255.0, device=dev), None,
                                       spec=spec, on_chip_prng=True, seed=5)
    tiles = qc.reshape(m // 256, 256, f // 256, 256).permute(
        0, 2, 1, 3).reshape(-1, 256 * 256)
    n_unique = torch.unique(tiles, dim=0).shape[0]
    up = qc.float().mean().item()
    if n_unique != tiles.shape[0] or abs(up - 0.5) > 1e-3:
        raise AssertionError(f"on-chip noise: {n_unique} distinct of "
                             f"{tiles.shape[0]} tiles, P(u >= 0.5) = {up}")
    log("kernels", f"stochastic_quantize (on-chip Philox form) at "
                   f"[{m}, {f}]: mean rounding error {mean:.3e} within 4 "
                   f"sigma/sqrt(n) = {bound4:.3e}; seeds 5 vs 6 differ in "
                   f"{diff_seeds:.4f} of elements; {n_unique} of "
                   f"{tiles.shape[0]} 256x256 tiles distinct; P(u >= 0.5) "
                   f"= {up:.5f}")

    # Timed at the largest gradient site, the MLP hidden [4096, 12288].
    u = torch.rand((m, f), generator=gen, device=dev)
    ms = time_ms(lambda: sq.stochastic_quantize_cuda(x, qp, u, spec), 20)
    plain_ms = time_ms(lambda: sq.stochastic_quantize_plain(x, qp, u, spec),
                       5)
    onchip_ms = time_ms(lambda: sq.stochastic_quantize_onchip_cuda(
        x, qp, 5, spec), 20)
    n = x.numel()
    b_ms, b_by = bound(n * 9, n * 6, FP32_OPS)
    ob_ms, _ = bound(n * 5, n * 6, FP32_OPS)
    return dict(name="stochastic_quantize", route="cuda",
                source="src/repro_torch/csrc/stochastic_quantize.cu",
                replaces="src/repro/kernels/stochastic_quantize.py:87",
                shape=[m, f], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                onchip_ms=onchip_ms, onchip_bound_ms=ob_ms)


def check_int8_matmul(dev, gen, cfg):
    from repro_torch.kernels import int8_matmul as mm

    d, f, hd, nkv = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_kv
    cases = []
    for m in (BATCH * PROMPT, BATCH):
        cases += [("q", m, d, d, 117.0), ("k/v", m, d, nkv * hd, 117.0),
                  ("o", m, d, d, 117.0), ("up", m, d, f, 117.0),
                  ("down", m, f, d, 117.0)]
    # the training loss's chunked LM head: [4, 512, 3072] x [3072, 49152]
    cases.append(("head", BATCH * cfg.loss_chunk, d, cfg.vocab, 117.0))
    # a zero point off the integers: the shift round(128 - zp) is not
    # 128 - zp (the paths' zero points are integers; the op takes any)
    cases.append(("q, zp 117.3", BATCH * PROMPT, d, d, 117.3))
    alpha = torch.tensor(2.3e-5, device=dev)
    worst = 0.0
    for what, m, k, n, x_zp in cases:
        zp = torch.tensor(x_zp, device=dev)
        x = torch.randint(0, 256, (1, m, k), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(-127, 128, (1, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        yk, mnk, mxk = mm.int8_matmul_fp_cuda(x, w, zp, alpha)
        yr, mnr, mxr = mm.int8_matmul_fp_plain(x, w, zp, alpha)
        torch.cuda.synchronize()
        err = (yk - yr).abs().max().item()
        if err != 0 or not (torch.equal(mnk, mnr) and torch.equal(mxk, mxr)):
            raise AssertionError(f"int8_matmul_fp {what} M={m} K={k} N={n}: "
                                 f"max |dy| {err}")
        worst = max(worst, err)
    log("kernels", f"int8_matmul_fp: {len(cases)} shapes bit-exact "
                   f"(y and min/max), prefill M={BATCH * PROMPT}, decode "
                   f"M={BATCH}, the LM-head chunk M={BATCH * cfg.loss_chunk}"
                   f" N={cfg.vocab} and x_zp 117.3")
    zp = torch.tensor(117.0, device=dev)
    # Timed at the MLP up projection [4096, 3072] x [3072, 12288]
    m, k, n = BATCH * PROMPT, d, f
    up = check_matmul_shape(dev, gen, "up", m, k, n)
    w = torch.randint(-127, 128, (1, k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    # Decode: the up projection at M = 4 (bound by the weight's bytes).
    xd = torch.randint(0, 256, (1, BATCH, k), generator=gen, device=dev,
                       dtype=torch.uint8)
    decode_ms = time_ms(lambda: mm.int8_matmul_fp_cuda(xd, w, zp, alpha), 20)
    decode_device_ms = graph_ms(
        lambda: mm.int8_matmul_fp_cuda(xd, w, zp, alpha), 20)
    xk, wk = mm.stage_operands(xd, w)
    decode_kernel_ms = graph_ms(lambda: mm.int8_matmul_fp_cuda_staged(
        xk, wk, zp, alpha), 20)
    decode_bound, decode_by = bound(BATCH * k + k * n + 4 * BATCH * n,
                                    2 * BATCH * n * k, INT8_OPS)
    log("kernels", f"int8_matmul_fp at decode up [{BATCH}, {k}, {n}]: "
                   f"{decode_ms:.4f} ms back to back (host-bound); device "
                   f"time from a CUDA graph {decode_device_ms:.4f} ms, of "
                   f"which the matmul on staged operands "
                   f"{decode_kernel_ms:.4f} ms (bound {decode_bound:.4f} ms, "
                   f"{decode_by})")
    del xk, wk
    # Also timed at the training loss's LM-head chunk [2048, 3072, 49152].
    hm, hn = BATCH * cfg.loss_chunk, cfg.vocab
    xh = torch.randint(0, 256, (1, hm, k), generator=gen, device=dev,
                       dtype=torch.uint8)
    wh = torch.randint(-127, 128, (1, k, hn), generator=gen, device=dev,
                       dtype=torch.int8)
    head_ms = time_ms(lambda: mm.int8_matmul_fp_cuda(xh, wh, zp, alpha), 5)
    head_bound, _ = bound(hm * k + k * hn + 4 * hm * hn, 2 * hm * hn * k,
                          INT8_OPS)
    log("kernels", f"int8_matmul_fp at the LM-head chunk [{hm}, {k}, {hn}]: "
                   f"{head_ms:.4f} ms, bound {head_bound:.4f} ms")
    return dict(name="int8_matmul_fp", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:139",
                **dict(up, max_abs_err=worst), decode_ms=decode_ms,
                decode_device_ms=decode_device_ms,
                decode_kernel_ms=decode_kernel_ms,
                decode_bound_ms=decode_bound, head_ms=head_ms,
                head_bound_ms=head_bound)


def check_matmul_shape(dev, gen, what, m, k, n) -> dict:
    """``int8_matmul_fp`` at one ``[1, M, K] x [1, K, N]`` shape: bit-exact
    against its plain version (x_zp 117), then timed with the weight's
    transpose and on staged operands beside its bound, its plain version
    and ``torch._int_mm`` (the int8 product alone)."""
    from repro_torch.kernels import int8_matmul as mm

    zp = torch.tensor(117.0, device=dev)
    alpha = torch.tensor(2.3e-5, device=dev)
    x = torch.randint(0, 256, (1, m, k), generator=gen, device=dev,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, (1, k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    yk, mnk, mxk = mm.int8_matmul_fp_cuda(x, w, zp, alpha)
    yr, mnr, mxr = mm.int8_matmul_fp_plain(x, w, zp, alpha)
    torch.cuda.synchronize()
    if not (torch.equal(yk, yr) and torch.equal(mnk, mnr)
            and torch.equal(mxk, mxr)):
        raise AssertionError(f"int8_matmul_fp {what} [{m}, {k}, {n}]: max "
                             f"|dy| {(yk - yr).abs().max().item()}")
    del yk, yr
    ms = time_ms(lambda: mm.int8_matmul_fp_cuda(x, w, zp, alpha), 10)
    xk, wk = mm.stage_operands(x, w)
    kernel_ms = time_ms(lambda: mm.int8_matmul_fp_cuda_staged(
        xk, wk, zp, alpha), 10)
    del xk, wk
    plain_ms = time_ms(lambda: mm.int8_matmul_fp_plain(x, w, zp, alpha), 3)
    xs = (x[0].to(torch.int16) - 128).to(torch.int8)
    # torch._int_mm takes N only in multiples of 8: pad the weight's
    # columns (2 more of 256206 for the seamless head)
    wl = w[0] if n % 8 == 0 else torch.nn.functional.pad(
        w[0], (0, -n % 8))
    try:   # yardstick only: one library call, the int8 GEMM alone
        lib_ms = time_ms(lambda: torch._int_mm(xs, wl), 10)
    except RuntimeError as e:
        log("kernels", f"torch._int_mm yardstick unavailable: {e}")
        lib_ms = None
    b_ms, b_by = bound(m * k + k * n + 4 * m * n, 2 * m * n * k, INT8_OPS)
    log("kernels", f"int8_matmul_fp at {what} [{m}, {k}, {n}]: bit-exact; "
                   f"{ms:.4f} ms with the weight's transpose, "
                   f"{kernel_ms:.4f} ms staged (bound {b_ms:.4f} ms, "
                   f"{b_by}), plain {plain_ms:.4f} ms, torch._int_mm "
                   + ("n/a" if lib_ms is None else f"{lib_ms:.4f}") + " ms")
    return dict(shape=[m, k, n], max_abs_err=0.0, ms=ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def check_int8_matmul_int32(dev, gen, cfg):
    """The int8 matmul's int32 mode at the row-parallel products of
    phase 43's (1, 2) starcoder2-3b: the attention output ``[4096, 1536] x
    [1536, 3072]`` (one rank's kv head) and the MLP down projection
    ``[4096, 6144] x [6144, 3072]``: exact against its plain version, and
    the two ranks' partials summed through the epilogue equal
    ``int8_matmul_fp`` on the whole K bit for bit; timed at the down
    projection beside its bound, its plain version and ``torch._int_mm``
    (the int8 product alone)."""
    from repro_torch.kernels import int8_matmul as mm

    m, d = BATCH * PROMPT, cfg.d_model
    zp = torch.tensor(117.0, device=dev)
    alpha = torch.tensor(2.3e-5, device=dev)
    shapes = (("o", cfg.n_heads * cfg.head_dim // 2), ("down", cfg.d_ff // 2))
    for what, k in shapes:
        x = torch.randint(0, 256, (1, m, 2 * k), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(-127, 128, (1, 2 * k, d), generator=gen,
                          device=dev, dtype=torch.int8)
        parts = [mm.int8_matmul_int32_cuda(x[..., i * k:(i + 1) * k],
                                           w[:, i * k:(i + 1) * k], zp)
                 for i in range(2)]
        for i, p in enumerate(parts):
            want = mm.int8_matmul_int32_plain(
                x[..., i * k:(i + 1) * k], w[:, i * k:(i + 1) * k], zp)
            if not torch.equal(p, want):
                raise AssertionError(f"int8_matmul_int32 {what} shard {i}: "
                                     f"differs from its plain version")
        y, mn, mx = mm.int8_matmul_epilogue_cuda(parts[0] + parts[1], alpha)
        yw, mnw, mxw = mm.int8_matmul_fp_cuda(x, w, zp, alpha)
        torch.cuda.synchronize()
        if not (torch.equal(y, yw) and torch.equal(mn, mnw)
                and torch.equal(mx, mxw)):
            raise AssertionError(f"int8_matmul_int32 {what}: the summed "
                                 f"shards' epilogue is not int8_matmul_fp")
        del parts, y, yw
    xs, ws = x[..., :k].contiguous(), w[:, :k].contiguous()
    ms = time_ms(lambda: mm.int8_matmul_int32_cuda(xs, ws, zp), 10)
    plain_ms = time_ms(lambda: mm.int8_matmul_int32_plain(xs, ws, zp), 3)
    try:   # yardstick only: one library call, the int8 GEMM alone
        xl = (xs[0].to(torch.int16) - 128).to(torch.int8)
        lib_ms = time_ms(lambda: torch._int_mm(xl, ws[0]), 10)
    except RuntimeError as e:
        log("kernels", f"torch._int_mm yardstick unavailable: {e}")
        lib_ms = None
    b_ms, b_by = bound(m * k + k * d + 4 * m * d, 2 * m * k * d, INT8_OPS)
    log("kernels", f"int8_matmul_int32 at {', '.join(w_ for w_, _ in shapes)}"
                   f" (K halves): exact, the summed halves' epilogue bit for "
                   f"bit int8_matmul_fp; [{m}, {k}, {d}] {ms:.4f} ms with "
                   f"the weight's transpose (bound {b_ms:.4f} ms, {b_by}), "
                   f"plain {plain_ms:.4f} ms, torch._int_mm "
                   + ("n/a" if lib_ms is None else f"{lib_ms:.4f}") + " ms")
    return dict(name="int8_matmul_int32", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:139",
                shape=[m, k, d], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_int8_matmul_epilogue(dev, gen, cfg):
    """The int32 mode's epilogue at phase 43's row-parallel output
    ``[4096, 3072]``: bit for bit its plain version (values and min/max),
    timed beside its bound, its plain version and ``torch.mul`` (the
    scaling alone)."""
    from repro_torch.kernels import int8_matmul as mm

    n = BATCH * PROMPT * cfg.d_model
    acc = torch.randint(-2 ** 26, 2 ** 26, (BATCH * PROMPT, cfg.d_model),
                        generator=gen, device=dev, dtype=torch.int32)
    alpha = torch.tensor(2.3e-5, device=dev)
    yk, mnk, mxk = mm.int8_matmul_epilogue_cuda(acc, alpha)
    yr, mnr, mxr = mm.int8_matmul_epilogue_plain(acc, alpha)
    torch.cuda.synchronize()
    if not (torch.equal(yk, yr) and torch.equal(mnk, mnr)
            and torch.equal(mxk, mxr)):
        raise AssertionError("int8_matmul_epilogue differs from its plain "
                             "version")
    ms = time_ms(lambda: mm.int8_matmul_epilogue_cuda(acc, alpha), 20)
    plain_ms = time_ms(lambda: mm.int8_matmul_epilogue_plain(acc, alpha), 20)
    lib_ms = time_ms(lambda: torch.mul(acc, alpha), 20)
    b_ms, b_by = bound(8 * n, n, FP32_OPS)
    log("kernels", f"int8_matmul_epilogue [{BATCH * PROMPT}, "
                   f"{cfg.d_model}]: bit-exact; {ms:.4f} ms (bound "
                   f"{b_ms:.4f} ms, {b_by}), plain {plain_ms:.4f} ms, "
                   f"torch.mul {lib_ms:.4f} ms")
    return dict(name="int8_matmul_epilogue", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:139",
                shape=[BATCH * PROMPT, cfg.d_model], max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)

def check_moe_matmul(dev, gen, mcfg) -> dict:
    """``int8_matmul_fp`` at the MoE experts' shapes (B = experts, M =
    groups x capacity): bit-exact against the plain version, with empty
    capacity slots (rows at the zero point's image) and x_zp 117 and
    117.3; timed with the weight's transpose, and on staged operands
    (decode from a CUDA graph: its launches are host-bound).  No library
    column: ``torch._int_mm`` has no batch dimension."""
    from repro_torch.kernels import int8_matmul as mm

    d, f, e = mcfg.d_model, mcfg.moe.d_expert, mcfg.moe.n_experts
    tokens = BATCH * PROMPT
    g = tokens // mcfg.moe.group_size
    m = g * mcfg.moe.capacity()                     # 8 x 69 = 552
    md = mcfg.moe.capacity(BATCH)                   # decode: 1 group of 4
    cases = [("up/gate", m, d, f), ("down", m, f, d), ("decode up", md, d, f)]
    alpha = torch.tensor(2.3e-5, device=dev)
    out = {}
    for what, rows, k, n in cases:
        x = torch.randint(0, 256, (e, rows, k), generator=gen, device=dev,
                          dtype=torch.uint8)
        x[:, rows // 2:] = 117          # the empty slots' image
        w = torch.randint(-127, 128, (e, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        for x_zp in (117.0, 117.3):
            zp = torch.tensor(x_zp, device=dev)
            yk, mnk, mxk = mm.int8_matmul_fp_cuda(x, w, zp, alpha)
            yr, mnr, mxr = mm.int8_matmul_fp_plain(x, w, zp, alpha)
            torch.cuda.synchronize()
            if not (torch.equal(yk, yr) and torch.equal(mnk, mnr)
                    and torch.equal(mxk, mxr)):
                raise AssertionError(
                    f"int8_matmul_fp experts {what} [{e}, {rows}, {k}, {n}] "
                    f"x_zp {x_zp}: max |dy| {(yk - yr).abs().max().item()}")
            del yk, yr
        zp = torch.tensor(117.0, device=dev)
        decode = rows < 128
        timer = graph_ms if decode else time_ms
        ms = timer(lambda: mm.int8_matmul_fp_cuda(x, w, zp, alpha),
                   20 if decode else 10)
        xk, wk = mm.stage_operands(x, w)
        kernel_ms = timer(lambda: mm.int8_matmul_fp_cuda_staged(
            xk, wk, zp, alpha), 20 if decode else 10)
        plain_ms = time_ms(lambda: mm.int8_matmul_fp_plain(x, w, zp, alpha),
                           3)
        b_ms, b_by = bound(e * rows * k + e * k * n + 4 * e * rows * n,
                           2 * e * rows * n * k, INT8_OPS)
        log("kernels", f"int8_matmul_fp experts {what} [B {e}, M {rows}, K "
                       f"{k}, N {n}]: bit-exact at x_zp 117 and 117.3 with "
                       f"{rows - rows // 2} empty slots per expert; "
                       f"{ms:.4f} ms with the transpose, {kernel_ms:.4f} ms "
                       f"staged{' (CUDA graph)' if decode else ''}, bound "
                       f"{b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms; "
                       f"library: none (torch._int_mm has no batch "
                       f"dimension)")
        out[what] = dict(shape=[e, rows, k, n], ms=ms, kernel_ms=kernel_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
        del x, w, xk, wk
        torch.cuda.empty_cache()
    return out


def check_matmul_tiles(dev, gen, cfg, mcfg) -> dict:
    """Every tile of the int8 matmul (``tuning.MATMUL_TILES``: row tiles
    128, 64, 32 and 16) at the slice's shapes ``[B, M, K, N]``: decode
    ``[1, 4, 3072, 12288]`` and the MoE experts' ``[60, 4, 2048, 1408]``,
    ``[1, 128, 3072, 12288]`` (decode_32k's B 128), ``[1, 552, 2048,
    1408]`` and the prefill's ``[1, 4096, 3072, 12288]``, and one
    MobileNetV2-tiny conv.  ``int8_matmul_fp``: each tile runs as it is
    (the row clamp off), held bit for bit against the plain version (y
    and min/max) and timed with CUDA events on staged operands (from a
    CUDA graph below 128 rows: those launches are host-bound) beside its
    bound; ``int8_matmul_fused`` at the 2-D shapes: each tile as the op
    runs it (the clamp on), its bytes and min/max bit for bit.  Logs which tile ``matmul_block`` and
    the clamp pick at each shape, checks that a ``REPRO_MM_BLOCK`` pin is
    honoured and a bad one raises, and runs ``REPRO_TUNE=benchmark`` with
    a thunk that launches the kernel."""
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import ops, tuning

    d, f = cfg.d_model, cfg.d_ff
    md, mf, e = mcfg.d_model, mcfg.moe.d_expert, mcfg.moe.n_experts
    shapes = [("decode", 1, BATCH, d, f), ("experts decode", e, BATCH, md, mf),
              ("decode B128", 1, 128, d, f), ("MoE prefill", 1, 552, md, mf),
              ("prefill", 1, BATCH * PROMPT, d, f)]
    zp = torch.tensor(117.3, device=dev)
    alpha = torch.tensor(2.3e-5, device=dev)
    spec = QuantSpec(bits=8, symmetric=False)
    qp = ops._qparams(torch.tensor(-3.0, device=dev),
                      torch.tensor(3.0, device=dev), spec)
    out = {}
    for what, b, m, k, n in shapes:
        x = torch.randint(0, 256, (b, m, k), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(-127, 128, (b, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        yr, mnr, mxr = mm.int8_matmul_fp_plain(x, w, zp, alpha)
        xk, wk = mm.stage_operands(x, w)
        timer = graph_ms if m < 128 else time_ms
        reps = 20 if m < 128 else 10
        rec = dict(shape=[b, m, k, n], tiles={}, fused_tiles={})
        bias = torch.randn((n,), generator=gen, device=dev) * 0.05
        if b == 1:
            qr, qmnr, qmxr = mm.int8_matmul_fused_plain(x[0], w[0], zp, alpha,
                                                        bias, qp, spec)
        for tile in tuning.MATMUL_TILES:
            yk, mnk, mxk = mm.int8_matmul_fp_cuda_staged(
                xk, wk, zp, alpha, block=tile, clamp=False)
            torch.cuda.synchronize()
            if not (torch.equal(yk, yr) and torch.equal(mnk, mnr)
                    and torch.equal(mxk, mxr)):
                raise AssertionError(
                    f"int8_matmul_fp tile {tile} at {what} {rec['shape']}: "
                    f"{int((yk != yr).sum())} outputs differ")
            del yk
            rec["tiles"][tile[0]] = timer(
                lambda: mm.int8_matmul_fp_cuda_staged(
                    xk, wk, zp, alpha, block=tile, clamp=False), reps)
            run = mm.row_tile(tile[0], m)    # the fused op clamps its rows
            if b == 1 and run not in rec["fused_tiles"]:
                qk, qmnk, qmxk = mm.int8_matmul_fused_cuda(
                    x[0], w[0], zp, alpha, bias, qp, spec, block=tile)
                torch.cuda.synchronize()
                if not (torch.equal(qk, qr) and torch.equal(qmnk, qmnr)
                        and torch.equal(qmxk, qmxr)):
                    raise AssertionError(
                        f"int8_matmul_fused tile {tile} at {what} "
                        f"{rec['shape']}: {int((qk != qr).sum())} bytes "
                        f"differ")
                del qk
                rec["fused_tiles"][run] = timer(
                    lambda: mm.int8_matmul_fused_cuda(
                        x[0], w[0], zp, alpha, bias, qp, spec, block=tile),
                    reps)
        pick = tuning.matmul_block(m, n, k, dtype="uint8")
        runs = mm.row_tile(pick[0], m)
        rec.update(pick=list(pick), runs=runs, ms=rec["tiles"][runs])
        rec["plain_ms"] = time_ms(
            lambda: mm.int8_matmul_fp_plain(x, w, zp, alpha), 3)
        rec["bound_ms"], rec["bound_by"] = bound(
            b * (m * k + k * n + 4 * m * n), 2 * b * m * n * k, INT8_OPS)
        (rec["fused_bound_ms"], rec["fused_bound_by"]), _ = \
            _fused_bounds(m, k, n)
        if b == 1:
            rec["fused_plain_ms"] = time_ms(lambda: mm.int8_matmul_fused_plain(
                x[0], w[0], zp, alpha, bias, qp, spec), 2)
        lib = None
        if b == 1 and m > 16:     # torch._int_mm takes M > 16 only
            xs = (x[0].to(torch.int16) - 128).to(torch.int8)
            try:
                lib = time_ms(lambda: torch._int_mm(xs, w[0]), reps)
            except RuntimeError as err:
                log("kernels", f"torch._int_mm yardstick unavailable: {err}")
            del xs
        rec["library_ms"] = lib
        log("kernels", f"int8_matmul_fp tiles at {what} {rec['shape']} "
                       f"(bit-exact each, the clamp off): "
                       + ", ".join(f"bm{bm} {ms:.4f}"
                                   for bm, ms in rec["tiles"].items())
                       + f" ms; bound {rec['bound_ms']:.4f} ms "
                       f"({rec['bound_by']}), plain {rec['plain_ms']:.4f} "
                       f"ms, torch._int_mm "
                       + ("n/a" if lib is None else f"{lib:.4f}") + " ms; "
                       f"matmul_block picks {tuple(pick)}, the clamp runs "
                       f"bm{runs}"
                       + ("; int8_matmul_fused (with the transpose): "
                          + ", ".join(f"bm{bm} {ms:.4f}" for bm, ms in
                                      rec["fused_tiles"].items()) + " ms"
                          if rec["fused_tiles"] else ""))
        out[what] = rec
        del x, w, xk, wk, yr
        torch.cuda.empty_cache()

    # one MobileNetV2-tiny conv of a batch of 128 (block 2's expand 1x1,
    # M = 524288 rows, K = 24, N = 144) on every tile
    xs, ws = (CNN_BATCH, 64, 64, 24), (1, 1, 24, 144)
    plan = ops.plan_conv(xs, ws, 1, "SAME", 1, 1)
    x = torch.randint(0, 256, xs, generator=gen, device=dev,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, ws, generator=gen, device=dev,
                      dtype=torch.int8)
    yr, mnr, mxr = conv_plain(x, w, zp, alpha, plan)
    conv = dict(shape=[plan.groups, plan.m, plan.k, plan.cout_g], tiles={})
    for tile in tuning.MATMUL_TILES:
        yk, mnk, mxk = ops.int8_conv_fp(x, w, zp, alpha, plan=plan,
                                        block=tile)
        torch.cuda.synchronize()
        if not (torch.equal(yk, yr) and torch.equal(mnk, mnr)
                and torch.equal(mxk, mxr)):
            raise AssertionError(f"int8_conv_fp tile {tile}: "
                                 f"{int((yk != yr).sum())} outputs differ")
        del yk
        conv["tiles"][tile[0]] = time_ms(lambda: ops.int8_conv_fp(
            x, w, zp, alpha, plan=plan, block=tile), 5)
    conv["pick"] = list(tuning.matmul_block(plan.m, plan.cout_g, plan.k,
                                            dtype="uint8"))
    log("kernels", f"int8_conv_fp tiles at b2 expand 1x1 {conv['shape']} "
                   f"(bit-exact each): "
                   + ", ".join(f"bm{bm} {ms:.4f}"
                               for bm, ms in conv["tiles"].items())
                   + f" ms; matmul_block picks {tuple(conv['pick'])}")
    out["conv"] = conv
    del x, w, yr

    # a pin is honoured, a pin of no instantiated tile raises, and the
    # benchmark mode times the candidates through a thunk that launches
    # the kernel
    b, m, k, n = shapes[-1][1:]
    x = torch.randint(0, 256, (m, k), generator=gen, device=dev,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    plan2 = ops.plan_einsum("mk,kn->mn", 2, 2)
    yr, _, _ = mm.int8_matmul_fp_plain(x[None], w[None], zp, alpha)
    saved = {v: os.environ.pop(v, None) for v in ("REPRO_MM_BLOCK",
                                                  "REPRO_TUNE")}
    try:
        os.environ["REPRO_MM_BLOCK"] = "64,128,128"
        tuning.clear_cache()
        ops.reset_launch_counts()
        y, _, _ = ops.int8_matmul_fp(x, w, zp, alpha, plan=plan2)
        tiles = ops.tile_launch_counts()
        if tiles[("int8_matmul_fp", 64)] != 1 or not torch.equal(y, yr[0]):
            raise AssertionError(f"the pin 64,128,128 was not honoured: "
                                 f"{tiles}")
        os.environ["REPRO_MM_BLOCK"] = "256,256,256"
        try:
            ops.int8_matmul_fp(x, w, zp, alpha, plan=plan2)
        except ValueError as err:
            refused = str(err)
        else:
            raise AssertionError("the pin 256,256,256 was not refused")
        del os.environ["REPRO_MM_BLOCK"]
        os.environ["REPRO_TUNE"] = "benchmark"
        tuning.clear_cache()
        bench = {}
        for what, b, m, k, n in (shapes[3], shapes[4]):
            xb = torch.randint(0, 256, (b, m, k), generator=gen, device=dev,
                               dtype=torch.uint8)
            wb = torch.randint(-127, 128, (b, k, n), generator=gen,
                               device=dev, dtype=torch.int8)
            xk, wk = mm.stage_operands(xb, wb)

            def thunk(tile, xk=xk, wk=wk):
                return lambda: mm.int8_matmul_fp_cuda_staged(
                    xk, wk, zp, alpha, block=tile)
            choice = tuning.matmul_block(m, n, k, dtype="uint8",
                                         bench_thunk=thunk)
            if choice not in tuning.MATMUL_CANDIDATES:
                raise AssertionError(f"benchmark mode chose {choice}")
            bench[what] = list(choice)
            del xb, wb, xk, wk
    finally:
        for v, val in saved.items():
            os.environ.pop(v, None)
            if val is not None:
                os.environ[v] = val
        tuning.clear_cache()
    log("kernels", f"REPRO_MM_BLOCK=64,128,128 honoured (one bm64 launch, "
                   f"bit-exact); 256,256,256 refused: {refused}; "
                   f"REPRO_TUNE=benchmark with a thunk launching the kernel "
                   f"picks: {bench}")
    out["pin_honoured"], out["benchmark"] = True, bench
    del x, w, yr
    torch.cuda.empty_cache()
    return out


def _note_tiles(results, what: str) -> None:
    """The int8 matmuls' launches by row tile of the path run just read
    (the counters were zeroed just before it)."""
    from repro_torch.kernels import ops

    results.setdefault("tile_launches", {})[what] = {
        f"{k}:{bm}": n for (k, bm), n in ops.tile_launch_counts().items()}


def tile_records(tiles: dict) -> tuple:
    """The ``tiles`` lists of the ``int8_matmul_fp`` and
    ``int8_matmul_fused`` records: each tile timed as it is at decode
    ``[1, 4, 3072, 12288]`` (``int8_matmul_fp``) and at the prefill's
    ``[1, 4096, 3072, 12288]`` (the fused kernel), its times at the other
    shapes in ``by_shape``; ``launches`` are set by the path phases."""
    from repro_torch.kernels import tuning

    fp, fused = [], []
    dec, pre = tiles["decode"], tiles["prefill"]
    for tile in tuning.MATMUL_TILES:
        bm = tile[0]
        common = dict(tile=list(tile), route="cuda", max_abs_err=0.0,
                      launches=None)
        fp.append(dict(common, shape=dec["shape"], ms=dec["tiles"][bm],
                       plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
                       bound_by=dec["bound_by"], library_ms=None,
                       by_shape={w: r["tiles"][bm] for w, r in tiles.items()
                                 if isinstance(r, dict) and "tiles" in r}))
        fused.append(dict(common, shape=pre["shape"],
                          ms=pre["fused_tiles"][bm],
                          plain_ms=pre["fused_plain_ms"],
                          bound_ms=pre["fused_bound_ms"],
                          bound_by=pre["fused_bound_by"], library_ms=None,
                          by_shape={w: r["fused_tiles"][bm]
                                    for w, r in tiles.items()
                                    if isinstance(r, dict)
                                    and bm in r.get("fused_tiles", {})}))
    return fp, fused


def check_int8_transpose(dev, gen, cfg):
    """The int8 matmuls' weight staging: w [K, N] -> its K-major image,
    exact at every projection's weight shape, timed at the up weight."""
    from repro_torch.kernels import int8_matmul as mm

    d, f, hd, nkv, v = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_kv, cfg.vocab
    shapes = [("q/o", d, d), ("k/v", d, nkv * hd), ("up", d, f),
              ("down", f, d), ("head", d, v), ("ragged", 3001, 77)]
    for what, k, n in shapes:
        w = torch.randint(-127, 128, (1, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        if not torch.equal(mm.weight_kmajor_cuda(w),
                           mm.weight_kmajor_plain(w)):
            raise AssertionError(f"int8_transpose {what} [{k}, {n}] differs "
                                 f"from its plain version")
    log("kernels", f"int8_transpose: {len(shapes)} weight shapes bit-exact: "
                   + ", ".join(f"{s_[0]} [{s_[1]}, {s_[2]}]"
                               for s_ in shapes))
    k, n = d, f
    w = torch.randint(-127, 128, (1, k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    ms = time_ms(lambda: mm.weight_kmajor_cuda(w), 20)
    plain_ms = time_ms(lambda: mm.weight_kmajor_plain(w), 5)
    lib_ms = time_ms(lambda: w.mT.contiguous(), 5)   # one PyTorch call
    b_ms, b_by = bound(2 * k * n, 0, INT8_OPS)
    return dict(name="int8_transpose", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                # no TPU counterpart (the MXU takes either layout): the
                # operand staging of the int8 matmuls' port
                replaces="src/repro/kernels/int8_matmul.py:139",
                shape=[k, n], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def _fused_bounds(m, k, n):
    """(fused, two-pass) bounds of one layer with a bias: the fused kernel
    reads x, w and the bias and writes 1 B per output; the two-pass route
    also writes y in fp32 and reads it back."""
    ops_n = 2 * m * n * k
    io = m * k + k * n + 4 * n + m * n
    return bound(io, ops_n, INT8_OPS), bound(io + 8 * m * n, ops_n, INT8_OPS)


def time_fused_layer(dev, gen, what, m, k, n):
    """Times of the fused kernel, its plain version, the two-pass route
    (int8_matmul_fp_cuda, then fused_quantize_cuda on its fp32 output) and
    torch._int_mm (the int8 product alone) at one layer shape.  The inputs
    rotate over copies that exceed L2 together, and every output is kept,
    so no call finds its operands or its output lines in L2."""
    import itertools

    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels import fused_quantize as fq
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import ops

    spec = QuantSpec(bits=8, symmetric=False)
    copies = max(2, -(-64 * 2 ** 20 // (m * k)))
    xs = [torch.randint(0, 256, (m, k), generator=gen, device=dev,
                        dtype=torch.uint8) for _ in range(copies)]
    w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    bias = torch.randn((n,), generator=gen, device=dev) * 0.5
    zp = torch.tensor(117.0, device=dev)
    alpha = torch.tensor(1.0 / (74.0 * 73.0 * math.sqrt(k)), device=dev)
    qp = ops._qparams(torch.tensor(-2.5, device=dev),
                      torch.tensor(3.0, device=dev), spec)
    nxt = itertools.cycle(xs).__next__

    def two_pass():
        x = nxt()
        y, _, _ = mm.int8_matmul_fp_cuda(x[None], w[None], zp, alpha)
        return fq.fused_quantize_cuda(y, qp, spec)

    y, _, _ = mm.int8_matmul_fp_cuda(xs[0][None], w[None], zp, alpha)
    t = dict(
        ms=time_ms(lambda: mm.int8_matmul_fused_cuda(
            nxt(), w, zp, alpha, bias, qp, spec), 10, keep=True),
        two_pass_ms=time_ms(two_pass, 10, keep=True),
        # the two passes apart
        fp_pass_ms=time_ms(lambda: mm.int8_matmul_fp_cuda(
            nxt()[None], w[None], zp, alpha), 10, keep=True),
        quantize_pass_ms=time_ms(lambda: fq.fused_quantize_cuda(y, qp, spec),
                                 10, keep=True),
        plain_ms=time_ms(lambda: mm.int8_matmul_fused_plain(
            nxt(), w, zp, alpha, bias, qp, spec), 3, keep=True))
    del y
    # The two-pass bias is not folded in (int8_matmul_fp takes none): its
    # time is a floor for that route.
    try:   # yardstick only: one library call, the int8 product alone
        ws = [(x.to(torch.int16) - 128).to(torch.int8) for x in xs]
        nxs = itertools.cycle(ws).__next__
        t["library_ms"] = time_ms(lambda: torch._int_mm(nxs(), w), 10,
                                  keep=True)
    except RuntimeError as e:
        log("kernels", f"torch._int_mm yardstick unavailable at {what}: {e}")
        t["library_ms"] = None
    (t["bound_ms"], t["bound_by"]), (t["two_pass_bound_ms"], _) = \
        _fused_bounds(m, k, n)
    lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
    log("kernels", f"int8_matmul_fused at {what} [{m}, {k}] x [{k}, {n}]: "
                   f"fused {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, "
                   f"{t['bound_by']}) vs two-pass int8_matmul_fp + "
                   f"fused_quantize {t['two_pass_ms']:.4f} ms (bound "
                   f"{t['two_pass_bound_ms']:.4f} ms; the passes apart "
                   f"{t['fp_pass_ms']:.4f} + {t['quantize_pass_ms']:.4f} ms)"
                   f": {t['two_pass_ms'] / t['ms']:.2f}x; plain "
                   f"{t['plain_ms']:.4f} ms; torch._int_mm (product only) "
                   f"{lib} ms")
    return t


def check_int8_matmul_fused(dev, gen, cfg):
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import ops

    d, f, hd, nkv = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_kv
    m = BATCH * PROMPT
    imgs = 32                      # an ImageNet batch, the paper's Table 5
    cases = [  # (what, M, K, N): LM projections; CNN layers as im2col
        ("q/o", m, d, d), ("k/v", m, d, nkv * hd), ("up", m, d, f),
        ("down", m, f, d), ("decode up", BATCH, d, f),
        ("MobileNetV2 1x1 16->96 @112", imgs * 112 * 112, 16, 96),
        ("ResNet18 3x3 64->64 @56", imgs * 56 * 56, 9 * 64, 64),
        ("ResNet18 3x3 256->256 @14", imgs * 14 * 14, 9 * 256, 256),
        ("ragged", 4093, 3001, 77)]
    def hold(x, w, zp, alpha, b, qp, spec, what):
        """The kernel against its plain version, bit for bit."""
        qk, mnk, mxk = mm.int8_matmul_fused_cuda(x, w, zp, alpha, b, qp, spec)
        qr, mnr, mxr = mm.int8_matmul_fused_plain(x, w, zp, alpha, b, qp,
                                                  spec)
        torch.cuda.synchronize()
        if not (torch.equal(qk, qr) and torch.equal(mnk, mnr)
                and torch.equal(mxk, mxr)):
            raise AssertionError(
                f"int8_matmul_fused {what}: {int((qk != qr).sum())} images "
                f"differ, min/max {mnk.item()}/{mnr.item()} "
                f"{mxk.item()}/{mxr.item()}")
        return qk

    # (symmetric out grid, bias, x_zp): both grids, with and without a
    # bias, an integer and a non-integer zero point
    variants = [(False, True, 117.0), (True, False, 117.0),
                (False, False, 117.3), (True, True, 117.3)]
    n_checked = 0
    clipped = 0.0
    for what, rows, k, n in cases:
        x = torch.randint(0, 256, (rows, k), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randn((n,), generator=gen, device=dev) * 0.5
        alpha = torch.tensor(1.0 / (74.0 * 73.0 * math.sqrt(k)), device=dev)
        for sym, bias, x_zp in variants:
            spec = QuantSpec(bits=8, symmetric=sym)
            qp = ops._qparams(torch.tensor(-2.5, device=dev),
                              torch.tensor(3.0, device=dev), spec)
            q = hold(x, w, torch.tensor(x_zp, device=dev), alpha,
                     b if bias else None, qp, spec,
                     f"{what} M={rows} K={k} N={n} sym={sym} bias={bias} "
                     f"x_zp={x_zp}").to(torch.int32)
            clipped = max(clipped, ((q == spec.int_min)
                                    | (q == spec.int_max)).float().mean()
                          .item())
            n_checked += 1
        del x, w, q
    # Ties: power-of-two scales put bias images and requantized values on
    # .5; both versions round half to even.
    rows, k, n = 4093, 3001, 77
    x = torch.randint(0, 256, (rows, k), generator=gen, device=dev,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    alpha = torch.tensor(2.0 ** -16, device=dev)
    b = (torch.arange(n, device=dev) - n // 2 + 0.5) * alpha
    zp = torch.tensor(117.0, device=dev)
    step = 2.0 ** -3             # out scale: y / scale + zp = v / 2**13 + zp
    v = mm._acc_plain(x[None], w[None], zp)[0] + torch.round(b / alpha)
    ties = int((torch.remainder(v, 2 ** 13) == 2 ** 12).sum())
    if ties == 0:
        raise AssertionError("the ties case has no .5 tie")
    for sym in (False, True):
        spec = QuantSpec(bits=8, symmetric=sym)
        qp = ops._qparams(torch.tensor((-127 if sym else -128) * step,
                                       device=dev),
                          torch.tensor(127 * step, device=dev), spec)
        hold(x, w, zp, alpha, b, qp, spec, f"ties sym={sym}")
        n_checked += 1
    log("kernels", f"int8_matmul_fused: {n_checked} (shape, grid, bias, "
                   f"x_zp) cases bit-exact (q and min/max): "
                   + ", ".join(f"{c[0]} [{c[1]}, {c[2]}] x [{c[2]}, {c[3]}]"
                               for c in cases)
                   + f", each with both 8-bit grids, with and without a bias"
                   f", x_zp 117.0 and 117.3 (largest share at the grid's ends "
                   f"{clipped:.4f}); and {ties} .5 ties (plus the bias "
                   f"images') on both grids at [{rows}, {k}] x [{k}, {n}]")
    del x, w, v
    torch.cuda.empty_cache()
    up = time_fused_layer(dev, gen, "up", m, d, f)
    mb = imgs * 112 * 112
    cnn = time_fused_layer(dev, gen, "MobileNetV2 1x1 16->96 @112", mb, 16,
                           96)
    torch.cuda.empty_cache()
    return dict(name="int8_matmul_fused", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:196",
                shape=[m, d, f], max_abs_err=0.0, library_note="product only",
                **up, cnn_shape=[mb, 16, 96],
                **{f"cnn_{k_}": v for k_, v in cnn.items()})


def _mask_pairs(mode, sq, skv, window, prefix_len) -> int:
    """The unmasked (q, k) pairs of one head: causal, at most ``window``
    keys a query, the prefix-LM mask, or every pair (bidir, cross)."""
    if mode in ("bidir", "cross"):
        return sq * skv
    if mode == "prefix":
        return sum(min(max(i + 1, prefix_len), skv) for i in range(sq))
    w = skv if window is None else window
    return sum(min(i + 1, w) for i in range(sq))


def check_attention(dev, gen, cfg, batch=BATCH, seq=PROMPT, window=None,
                    skv=None, mode=None, prefix_len=0, light=False,
                    block=None):
    """The attention kernel at ``cfg``'s prefill head layout, ``batch`` x
    ``seq`` queries against ``skv`` keys (default ``seq``), under a
    sliding mask of ``window`` (default: the config's ``sliding_window``)
    or causal, or under ``mode`` (bidir, cross, or prefix with
    ``prefix_len``), on the tile ``block`` (default: the tuner's).
    ``light`` (a long shape, whose plain version takes seconds): held
    once, the plain version timed once."""
    import torch.nn.functional as F

    from repro_torch.kernels import int8_attention as attn
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import tuning

    s, hd, nh, nkv = seq, cfg.head_dim, cfg.n_heads, cfg.n_kv
    skv = skv or s
    g = nh // nkv
    bh, zb = batch * nh, batch * nkv
    bq, bkv = block or tuning.attention_block(s, skv, hd)
    window = window or cfg.sliding_window
    mode = mode or ("causal" if window is None else "sliding")
    sched = attn.make_schedule(sq=s, skv=skv, hd=hd, bq=bq, bkv=bkv,
                               groups=g, mode=mode, window=window or 0,
                               prefix_len=prefix_len, sm_scale=hd ** -0.5)
    q = torch.randint(0, 256, (bh, s, hd), generator=gen, device=dev,
                      dtype=torch.uint8)
    k = torch.randint(-127, 128, (zb, skv, hd), generator=gen, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (zb, skv, hd), generator=gen, device=dev,
                      dtype=torch.int8)
    kvl = torch.tensor([skv], device=dev, dtype=torch.int32)

    def hold(regs, what):
        ok, mlk, psk = attn.attention_cuda(q, k, v, regs, kvl, sched=sched)
        orf, mlr, psr = attn.attention_core_reference(q, k, v, regs, kvl,
                                                      sched=sched)
        torch.cuda.synchronize()
        if not torch.equal(mlk[..., 0], mlr[..., 0]):
            raise AssertionError(f"attention ({what}): running max m differs")
        if not torch.equal(psk[..., :4], psr[..., :4]):
            raise AssertionError(f"attention ({what}): p-site "
                                 f"min/max/clip/n differ")
        err = (ok - orf).abs().max().item()
        same = (ok == orf).float().mean().item()
        # Tolerance: expf vs torch.exp may differ by an ulp, moving a
        # requantized probability by one level (1/255 of the row's weight).
        torch.testing.assert_close(ok, orf, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(mlk[..., 1], mlr[..., 1], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(psk[..., 4:], psr[..., 4:], rtol=1e-4,
                                   atol=1e-6)
        log("kernels", f"attention {cfg.name} ({what}) {tuple(q.shape)} x "
                       f"{tuple(k.shape)} G={g} {mode} (window {window}, "
                       f"prefix {prefix_len}) "
                       f"(bq, bkv)=({bq}, {bkv}) "
                       f"width={sched.width}: m, min/max/clip/n exact; out "
                       f"max |d| {err:.3e} ({same:.6f} of elements "
                       f"identical), l and err/sig within 1e-4")
        return err, (ok, mlk, psk)

    scale_p = 1.0 / 255.0
    # scores of unit-order spread: alpha_qk * |acc| ~ 1e-5 * 6e4
    regs = torch.tensor([128.0, 1e-5, scale_p, 0.0, scale_p * 0.02, 0.0, 1.0,
                         0.0], device=dev, dtype=torch.float32)
    err, (ok, mlk, psk) = hold(regs, "zp_q 128, zp_p 0")
    # Both zero points off zero, zp_q off the integers: the reference
    # truncates them, and p's grid [-0.1, 1.0] puts zp_p at 23.
    scale_z = 1.1 / 255.0
    regs_z = torch.tensor([117.7, 1e-5, scale_z, round(0.1 / scale_z),
                           scale_z * 0.02, -0.1, 1.0, 0.0], device=dev,
                          dtype=torch.float32)
    if not light:
        err = max(err, hold(regs_z, "zp_q 117.7, zp_p 23")[0])
    ms = time_ms(lambda: attn.attention_cuda(q, k, v, regs, kvl,
                                             sched=sched), 10)
    # The wrapper's time holds one V^T image (the P.V product's B operand,
    # made by the int8 matmul's transpose kernel); its share apart:
    vt_ms = time_ms(lambda: mm.weight_kmajor_cuda(v), 10)
    log("kernels", f"attention: V^T image {vt_ms:.4f} ms of the call's "
                   f"{ms:.4f} ms")
    plain_ms = time_ms(lambda: attn.attention_core_reference(
        q, k, v, regs, kvl, sched=sched), 1 if light else 2,
        warmup=0 if light else 1)
    qb = torch.randn((batch, nh, s, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    kb = torch.randn((batch, nkv, skv, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vb = torch.randn((batch, nkv, skv, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    # yardstick only: bf16 SDPA (with GQA where G > 1), causal, unmasked
    # (bidir, cross), or under an explicit boolean mask where a sliding
    # window masks or for the prefix-LM mask
    mask = None
    pos = torch.arange(s, device=dev)
    if mode == "sliding" and window < s:
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[:, None] - pos[None, :] < window)
    elif mode == "prefix":
        mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < prefix_len)
    causal = mode in ("causal", "sliding") and mask is None
    try:
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, is_causal=causal,
            enable_gqa=g > 1), 10)
    except (RuntimeError, TypeError) as e:
        log("kernels", f"scaled_dot_product_attention yardstick "
                       f"unavailable: {e}")
        lib_ms = None
    pairs = bh * _mask_pairs(mode, s, skv, window, prefix_len)
    nbytes = q.numel() + k.numel() + v.numel() + 4 * (ok.numel()
                                                      + mlk.numel()
                                                      + psk.numel())
    b_ms, b_by = bound(nbytes, 4 * pairs * hd, INT8_OPS)
    return dict(name="int8_attention", route="cuda",
                source="src/repro_torch/csrc/int8_attention.cu",
                replaces="src/repro/kernels/int8_attention.py:367",
                shape=[bh, s, hd] if skv == s else [bh, s, skv, hd],
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                groups=g, mode=mode, window=window, prefix_len=prefix_len,
                block=[bq, bkv])


def conv_plain(x, w, x_zp, alpha, plan):
    """``ops.int8_conv_fp``'s plain version on the card: the same lowering
    with ``int8_matmul_fp``'s plain version (exact in float64)."""
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import ops

    patches = ops.conv_patches(x, plan, torch.round(x_zp))
    y3, mn, mx = mm.int8_matmul_fp_plain(
        patches, ops.conv_lower_weights(w, plan), x_zp, alpha)
    return ops.conv_unlower_output(y3, plan).contiguous(), mn, mx


def check_int8_conv(dev, gen):
    """The conv site's int8 contraction, ``ops.int8_conv_fp`` (im2col of
    the uint8 image onto ``int8_matmul_fp``'s kernel, the groups on its
    batch dimension), against its plain version, bit for bit, at four
    MobileNetV2-tiny layers of a batch of 128: the stem (K = 27), block
    2's expand 1x1 (M = 524,288), its depthwise 3x3 (G = 144, K = 9,
    N = 1) and block 3's stride-2 depthwise; zero points 117 and 117.3
    (the padded taps take round(zp)).  Timed with CUDA events: the op,
    its parts (im2col, the staged matmul), its plain version, and cuDNN's
    fp32 conv of the same shapes (TF32 off) as a yardstick of another
    function."""
    import torch.nn.functional as F

    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import ops

    b = CNN_BATCH
    cases = [  # (what, x NHWC, w HWIO, stride, groups)
        ("stem 3x3 3->32 @64", (b, 64, 64, 3), (3, 3, 3, 32), 1, 1),
        ("b2 expand 1x1 24->144 @64", (b, 64, 64, 24), (1, 1, 24, 144), 1,
         1),
        ("b2 depthwise 3x3 x144 @64", (b, 64, 64, 144), (3, 3, 1, 144), 1,
         144),
        ("b3 depthwise 3x3 x144 s2 @64->32", (b, 64, 64, 144),
         (3, 3, 1, 144), 2, 144)]
    alpha = torch.tensor(2.3e-4, device=dev)
    out = []
    for what, xs, ws, stride, groups in cases:
        plan = ops.plan_conv(xs, ws, stride, "SAME", 1, groups)
        x = torch.randint(0, 256, xs, generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(-127, 128, ws, generator=gen, device=dev,
                          dtype=torch.int8)
        for zp_v in (117.0, 117.3):
            zp = torch.tensor(zp_v, device=dev)
            yk, mnk, mxk = ops.int8_conv_fp(x, w, zp, alpha, plan=plan)
            yr, mnr, mxr = conv_plain(x, w, zp, alpha, plan)
            torch.cuda.synchronize()
            if not (torch.equal(yk, yr) and torch.equal(mnk, mnr)
                    and torch.equal(mxk, mxr)):
                raise AssertionError(
                    f"int8_conv_fp {what} x_zp {zp_v}: "
                    f"{int((yk != yr).sum())} outputs differ, min/max "
                    f"{mnk.item()}/{mnr.item()} {mxk.item()}/{mxr.item()}")
            del yk, yr
        zp = torch.tensor(117.3, device=dev)
        ms = time_ms(lambda: ops.int8_conv_fp(x, w, zp, alpha, plan=plan),
                     10)
        patches = ops.conv_patches(x, plan, torch.round(zp))
        im2col_ms = time_ms(lambda: ops.conv_patches(x, plan,
                                                     torch.round(zp)), 10)
        w3 = ops.conv_lower_weights(w, plan)
        stage_ms = time_ms(lambda: mm.stage_operands(patches, w3), 10)
        xk, wk = mm.stage_operands(patches, w3)
        kernel_ms = time_ms(lambda: mm.int8_matmul_fp_cuda_staged(
            xk, wk, zp, alpha), 10)
        y3, _, _ = mm.int8_matmul_fp_cuda_staged(xk, wk, zp, alpha)
        unlower_ms = time_ms(
            lambda: ops.conv_unlower_output(y3, plan).contiguous(), 10)
        del patches, xk, wk, y3
        # The site's backward (plain fp32, shared by both backends) at
        # this shape, by part: the fp32 patches of the on-grid input, the
        # two batched products, the col2im.
        xq = torch.randn(xs, generator=gen, device=dev)
        gq = torch.randn((plan.n, plan.oh, plan.ow, plan.cout),
                         generator=gen, device=dev)
        gl = ops.conv_lower_output(gq, plan)
        wl = ops.conv_lower_weights(w.to(torch.float32), plan)
        bwd = dict(patches_ms=time_ms(
            lambda: ops.conv_patches(xq, plan, 0.0), 5))
        xl = ops.conv_patches(xq, plan, 0.0)
        bwd["dw_bmm_ms"] = time_ms(lambda: torch.bmm(xl.transpose(1, 2), gl),
                                   5)
        del xl
        bwd["dx_bmm_ms"] = time_ms(lambda: torch.bmm(gl, wl.transpose(1, 2)),
                                   5)
        dp = torch.bmm(gl, wl.transpose(1, 2))
        bwd["col2im_ms"] = time_ms(lambda: ops.conv_unpatch(dp, plan), 5)
        del xq, gq, gl, wl, dp
        plain_ms = time_ms(lambda: conv_plain(x, w, zp, alpha, plan), 2)
        xf = x.to(torch.float32).permute(0, 3, 1, 2)
        wf = w.to(torch.float32).permute(3, 2, 0, 1)
        pads = plan.pads
        xf = F.pad(xf, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        cudnn_ms = time_ms(lambda: F.conv2d(xf, wf, stride=stride,
                                            groups=groups), 10)
        del xf, wf
        ops_n = 2 * plan.m * plan.k * plan.cout_g * plan.groups
        nbytes = x.numel() + w.numel() + 4 * plan.m * plan.cout
        b_ms, b_by = bound(nbytes, ops_n, INT8_OPS)
        rec = dict(what=what, x=list(xs), w=list(ws), stride=stride,
                   groups=groups, gmkn=[plan.groups, plan.m, plan.k,
                                        plan.cout_g],
                   ms=ms, im2col_ms=im2col_ms, stage_ms=stage_ms,
                   kernel_ms=kernel_ms, unlower_ms=unlower_ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, cudnn_fp32_conv_ms=cudnn_ms,
                   backward=bwd)
        log("kernels", f"int8_conv_fp {what} [G {plan.groups}, M {plan.m}, "
                       f"K {plan.k}, N {plan.cout_g}]: bit-exact at x_zp 117 "
                       f"and 117.3; {ms:.4f} ms (im2col {im2col_ms:.4f}, "
                       f"staging: K padded to 16 and the weight's "
                       f"transpose {stage_ms:.4f}, matmul on staged operands "
                       f"{kernel_ms:.4f}, NHWC copy of the output "
                       f"{unlower_ms:.4f}), bound {b_ms:.4f} ms ({b_by}), "
                       f"plain {plain_ms:.4f} ms; cuDNN fp32 conv (another "
                       f"function) {cudnn_ms:.4f} ms; the site's fp32 "
                       f"backward by part (ms): "
                       + ", ".join(f"{k[:-3]} {v:.4f}"
                                   for k, v in bwd.items()))
        out.append(rec)
        del x, w
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 7-8: the training path.
# ---------------------------------------------------------------------------
def train_phase(cfg) -> dict:
    from repro_torch.core.state import INITED, tree_leaves, tree_map_with_path
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    argv = ["--arch", cfg.name, "--batch", str(BATCH), "--seq", str(PROMPT),
            "--steps", str(TRAIN_STEPS), "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = train.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(counts[k] > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a kernel of the train path never launched: "
                             f"{counts}")
    if len(run.losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in run.losses):
        raise AssertionError(f"train losses {run.losses}")
    # Every site visited in a step holds a range after it: all grad
    # leaves, and all act leaves but the k/v ones (q/k/v share one input
    # site, whose range lives on "q").  The count after step 0 must
    # already be the final one.
    quant = run.state["quant"]
    leaves = tree_leaves(quant)
    grad_leaves = []
    tree_map_with_path(lambda path, leaf: grad_leaves.append(leaf)
                       if path[-1] == "grad" else None, quant)
    expect = len(leaves) - 2 * cfg.n_layers
    inited = [m["inited_sites"] for m in run.metrics]
    if not all(float(leaf[INITED]) == 1.0 for leaf in grad_leaves) or \
            inited != [expect] * TRAIN_STEPS:
        raise AssertionError(f"initialized sites per step {inited}, "
                             f"expected {expect} of {len(leaves)}")
    steady = run.step_ms[1:]
    step_ms = sum(steady) / len(steady)
    tok_s = BATCH * PROMPT / (step_ms / 1e3)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    log("train", f"{cfg.n_layers} layers d={cfg.d_model} B={BATCH} "
                 f"S={PROMPT}, AdamW, remat: losses "
                 f"{[round(v, 4) for v in run.losses]}; step 0 "
                 f"{run.step_ms[0]:.1f} ms (uninitialized-leaf double pass), "
                 f"steps 1-{TRAIN_STEPS - 1} {[round(v, 1) for v in steady]} "
                 f"ms, {tok_s:.1f} tokens/s; peak {peak:.2f} GiB; "
                 f"{inited[0]} of {len(leaves)} quant sites initialized "
                 f"after step 0; launches per step {per_step}")
    out = dict(losses=run.losses, step_ms=run.step_ms,
               steady_step_ms=step_ms, tokens_per_s=tok_s, peak_gib=peak,
               launches=counts, launches_per_step=per_step,
               inited_sites=inited, profile=profile_step(run))
    del run, quant, leaves, grad_leaves
    return out


KERNEL_FAMILIES = (   # (family, substrings of the kernel name), first match
    ("int8_matmul_fp (ours)", ("int8_matmul_fp_kernel",)),
    ("int8_matmul_fused (ours)", ("int8_matmul_fused_kernel",)),
    ("int8_transpose (ours: K-major weights, attention's V^T)",
     ("int8_transpose_kernel",)),
    ("int8_attention (ours)", ("int8_attention_kernel",)),
    ("fused_quantize (ours)", ("fused_quantize_kernel",)),
    ("stochastic_quantize (ours)", ("stochastic_quantize_kernel",)),
    ("cuBLAS GEMM (fp32 backward, fp64 QK^T recompute)",
     ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("RNG (gradient noise)", ("philox", "distribution")),
    ("reductions", ("reduce",)),
)


def profile_device(run_once, tag: str, ranges=()) -> dict:
    """``run_once()`` (one step, ending in a host read) under
    torch.profiler: device time by kernel family and the share of the wall
    time the card idled.  With ``ranges``, the CPU activity is traced too
    and the device time of kernels launched inside the named
    ``record_function`` ranges is summed per range name substring (that
    tracing adds host time, so the idle share is then not reported)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam: dict = {}
    kernels = []
    in_ranges = {r: 0.0 for r in ranges}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:   # host ops and ranges
            us = getattr(evt, "device_time_total", None)
            if us is None:
                us = evt.cuda_time_total
            for r in ranges:
                if evt.key.startswith(r):
                    in_ranges[r] += us / 1e3
            continue
        if any(evt.key.startswith(r) for r in ranges):
            continue        # a range's span on the device timeline
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us <= 0:
            continue
        kernels.append((us / 1e3, evt.count, evt.key))
        low = evt.key.lower()
        name = next((f for f, subs in KERNEL_FAMILIES
                     if any(x in low for x in subs)), "other elementwise/copy")
        ms, n = fam.get(name, (0.0, 0))
        fam[name] = (ms + us / 1e3, n + evt.count)
    busy_ms = sum(ms for ms, _, _ in kernels)
    if busy_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    kernels.sort(reverse=True)
    fam = dict(sorted(fam.items(), key=lambda kv: -kv[1][0]))
    idle = "" if ranges else \
        f" (idle {100 * (1 - busy_ms / wall_ms):.1f}% of the step)"
    log(tag, f"one steady step under torch.profiler: wall {wall_ms:.1f} ms, "
             f"device busy {busy_ms:.1f} ms{idle}; by family (ms, "
             f"launches): " + "; ".join(f"{k} {v[0]:.1f} ({v[1]})"
                                        for k, v in fam.items()))
    log(tag, "top kernels (ms, launches): " + "; ".join(
        f"{k[:60]} {ms:.1f} ({n})" for ms, n, k in kernels[:10]))
    if ranges:
        log(tag, "device time inside ranges (ms): " + "; ".join(
            f"{r} {ms:.1f}" for r, ms in in_ranges.items()))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, families=fam,
                top=kernels[:25], ranges=in_ranges,
                idle_share=None if ranges else 1 - busy_ms / wall_ms)


def profile_step(run, tag: str = "train-profile", ranges=(), batch=BATCH,
                 seq=PROMPT, profiled: bool = True):
    """One more training step of ``run``'s state at ``batch`` x ``seq``
    under torch.profiler (CUDA activity only, to keep the host overhead
    low, unless ``ranges`` are asked for); with ``profiled=False`` the
    step runs bare (for a caller's own timing)."""
    from repro_torch import data
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import steps

    step = steps.make_train_step(run.cfg, run.policy, adamw(), constant(1e-4))
    stream = data.for_arch(run.cfg, seq_len=seq, global_batch=batch)
    batch = {k: v.to("cuda") for k, v in stream.batch(TRAIN_STEPS).items()}

    def once():
        run.state, met = step(run.state, batch)
        float(met["loss"])
    if not profiled:
        return once()
    return profile_device(once, tag, ranges)


def train_parity_phase(cfg, dev, tag: str = "train-parity",
                       kernels=TRAIN_KERNELS) -> dict:
    """One forward + backward of ``cfg`` (its depth as given), fused vs
    simulated backend, same params, batch and noise; the fused run
    launches every kernel of ``kernels``."""
    from repro_torch import data
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.state import tree_map_with_path
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    state = steps.init_train_state(cfg, adamw(), seed=1, device=dev)
    stream = data.for_arch(cfg, seq_len=PROMPT, global_batch=BATCH, seed=1)
    batch = {k: v.to(dev) for k, v in stream.batch(0).items()}
    out = {}
    for bk in ("fused", "simulated"):
        ops.reset_launch_counts()
        quant = model.init_quant_state(cfg, device=dev)
        out[bk] = steps.forward_backward(
            cfg, QuantPolicy.w8a8g8(backend=bk), state["params"], quant,
            batch, 0, 0)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ok = all(counts[k] for k in kernels) if bk == "fused" \
            else not any(counts.values())
        if not ok:
            raise AssertionError(f"{bk} backend launches {counts}")
    (lf, gf, sf, _), (ls, gs, ss, _) = out["fused"], out["simulated"]
    loss_rel = abs(lf.item() - ls.item()) / abs(ls.item())
    site_rel = {"act": 0.0, "grad": 0.0}

    def cmp(path, a, b):
        if not torch.equal(a[2], b[2]):
            raise AssertionError(f"visited flags differ at {path}")
        kind = "grad" if path[-1] == "grad" else "act"
        rel = ((a - b).abs() / b.abs().clamp(min=1e-12)).max().item()
        site_rel[kind] = max(site_rel[kind], rel)
    tree_map_with_path(cmp, sf, ss)
    grad_rel = 0.0
    for name, g in gs.items():
        if name.endswith("attn.bk"):       # exact gradient is zero
            continue
        grad_rel = max(grad_rel, ((gf[name] - g).norm()
                                  / g.norm().clamp(min=1e-30)).item())
    # Tolerances: the fused kernels are bit-exact to the plain versions but
    # the attention kernel's expf may differ from torch.exp by an ulp and
    # flip a requantized probability; a flipped level moves the next
    # stochastic roundings by one level, which the layers below carry on.
    limits = dict(loss=1e-3, act=1e-2, grad=5e-2, param_grad=5e-2)
    if not (loss_rel <= limits["loss"] and site_rel["act"] <= limits["act"]
            and site_rel["grad"] <= limits["grad"]
            and grad_rel <= limits["param_grad"]):
        raise AssertionError(f"train parity: loss rel {loss_rel:.3e}, site "
                             f"rel {site_rel}, param-grad rel L2 "
                             f"{grad_rel:.3e} (limits {limits})")
    log(tag, f"{cfg.name}: {cfg.n_layers} layers at full width, one "
             f"forward + backward, fused vs simulated: loss {lf.item():.6f} "
             f"vs {ls.item():.6f} (rel {loss_rel:.3e}); site min/max rel act "
             f"{site_rel['act']:.3e}, grad {site_rel['grad']:.3e}; worst "
             f"param-grad rel L2 {grad_rel:.3e} (limits {limits})")
    del state, out
    return dict(loss_rel=loss_rel, site_rel=site_rel, param_grad_rel=grad_rel)


# ---------------------------------------------------------------------------
# Phase 9: the fused layer path.
# ---------------------------------------------------------------------------
def fused_layer_phase(cfg, dev) -> dict:
    """The paper's single-pass layer (Fig. 2/3) through its public op,
    ``ops.int8_matmul_fused``: starcoder2-3b's MLP up and down projections
    at full width, with biases, chained as two int8 layers (the up layer's
    uint8 image and grid are the down layer's input; no activation between
    them: the fused kernel has none) over ``LAYER_STEPS`` in-hindsight
    steps of fresh B=4 x 1024-token inputs.  Each layer's out range is its
    hindsight estimate (EMA of earlier steps' min/max); at step 0 the
    estimate does not exist yet and the layer runs twice, first for its
    statistics, as the port's fused backend does for a new site.  Every
    step's images and statistics are held against the plain version."""
    from repro_torch.core import estimators, quant
    from repro_torch.core.quant import QuantSpec
    from repro_torch.core.state import INITED, init_range_state, pack_stats
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import ops

    est = estimators.EstimatorConfig()                 # hindsight, eta 0.9
    act = QuantSpec(bits=8, symmetric=False)
    gen = torch.Generator(device=dev).manual_seed(9)
    m, d, f = BATCH * PROMPT, cfg.d_model, cfg.d_ff
    # the input grid: [-3, 3]; weights and biases of unit-order outputs
    in_scale, in_zp = quant.scale_zero_point(torch.tensor(-3.0, device=dev),
                                             torch.tensor(3.0, device=dev),
                                             act)
    x_std = 74.0 * float(in_scale)
    layers = []
    for k, n, scale in ((d, f, 1.0 / (73.0 * math.sqrt(d) * x_std)),
                        (f, d, 1.0 / (73.0 * math.sqrt(f)))):
        layers.append(dict(
            w=torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8),
            w_scale=torch.tensor(scale, device=dev),
            bias=torch.randn((n,), generator=gen, device=dev) * 0.1,
            leaf=init_range_state(device=dev)))

    def run(x_q, x_scale, x_zp, layer, check):
        w, ws, b = layer["w"], layer["w_scale"], layer["bias"]
        if float(layer["leaf"][INITED]) < 0.5:   # no hindsight range yet
            _, lo, hi = ops.int8_matmul_fused(x_q, w, x_scale, x_zp, ws, b,
                                              -1.0, 1.0)
        else:
            lo, hi = estimators.static_ranges(est, layer["leaf"])
        q, mn, mx = ops.int8_matmul_fused(x_q, w, x_scale, x_zp, ws, b, lo,
                                          hi, out_spec=act)
        qp = ops._qparams(lo, hi, act)
        qr, mnr, mxr = mm.int8_matmul_fused_plain(
            x_q, w, torch.as_tensor(x_zp, device=dev),
            torch.as_tensor(x_scale, device=dev) * ws, b, qp, act)
        check.append(torch.equal(q, qr) and torch.equal(mn, mnr)
                     and torch.equal(mx, mxr))
        layer["leaf"] = estimators.update(est, layer["leaf"],
                                          pack_stats(mn, mx))
        clip = ((q == act.int_min) | (q == act.int_max)).float().mean()
        return q, qp[0], qp[1], clip.item()

    clips, step_ms, checks = [], [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for _ in range(LAYER_STEPS):
        x = torch.randint(0, 256, (m, d), generator=gen, device=dev,
                          dtype=torch.uint8)
        t0 = time.perf_counter()
        h, h_scale, h_zp, c_up = run(x, in_scale, in_zp, layers[0], checks)
        out, _, _, c_down = run(h, h_scale, h_zp, layers[1], checks)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        clips.append((c_up, c_down))
    counts = ops.launch_counts()
    expect = 2 * LAYER_STEPS + 2                 # + step 0's first passes
    if any(counts[k] != expect for k in LAYER_KERNELS) or any(
            counts[k] for k in counts if k not in LAYER_KERNELS):
        raise AssertionError(f"fused layer path launches {counts}, "
                             f"expected {expect} of each of {LAYER_KERNELS} "
                             f"only")
    if not all(checks):
        raise AssertionError(f"fused layer path: kernel vs plain {checks}")
    if out.shape != (m, d) or out.dtype != torch.uint8:
        raise AssertionError(f"fused layer output {out.dtype} "
                             f"{tuple(out.shape)}")
    # From step 1 on each range is in hindsight: fresh inputs of the same
    # distribution may only just leave it.
    worst = max(max(c) for c in clips[1:])
    if not worst <= 1e-4:
        raise AssertionError(f"hindsight ranges clip {clips}")
    log("fused-layers", f"starcoder2-3b MLP up [{m}, {d}] x [{d}, {f}] and "
                        f"down [{m}, {f}] x [{f}, {d}] as two chained fused "
                        f"int8 layers, {LAYER_STEPS} in-hindsight steps: "
                        f"every step bit-exact to the plain version; share "
                        f"at the grid's ends (up, down) per step {clips}; "
                        f"step ms "
                        f"{[round(v, 3) for v in step_ms]} (with the plain "
                        f"checks); launches {counts}")
    return dict(launches=counts, clipped=clips, step_ms=step_ms)


# ---------------------------------------------------------------------------
# Phases 10-11: the CNN training path.
# ---------------------------------------------------------------------------
DW_RANGES = ("qconv_int8_fused", "qconv_int8_bwd",
             "qconv_int8_fused_depthwise", "qconv_int8_bwd_depthwise")


def cnn_train_phase(dev) -> dict:
    """Phase 10: ``repro_torch.cnn.train.main`` on MobileNetV2 at its Tiny
    ImageNet width (1.0, 64 x 64 x 3, 200 classes), batch 128 of the
    synthetic ImageStream (seed 0), w8a8g8 hindsight on the fused backend,
    2 calibration batches and ``CNN_STEPS`` steps, with the launch
    counters zeroed just before and read just after; then one more step
    under the profiler twice (kernels only: families and idle share; with
    host ranges: the conv sites' and the depthwise convs' device time);
    then one step each of ResNet18-tiny and VGG16-tiny."""
    from repro_torch.cnn import models
    from repro_torch.cnn import train as cnn_train
    from repro_torch.core.state import INITED, tree_leaves
    from repro_torch.data import ImageStream
    from repro_torch.kernels import ops
    from repro_torch.optim import sgdm
    from repro_torch.optim.schedules import constant

    argv = ["--arch", "mobilenetv2", "--width", "1.0", "--image-size", "64",
            "--num-classes", "200", "--batch", str(CNN_BATCH), "--steps",
            str(CNN_STEPS), "--backend", "fused", "--calibration-batches",
            "2"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = cnn_train.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    off_path = [k for k in counts if k not in CNN_KERNELS and counts[k]]
    if not all(counts[k] > 0 for k in CNN_KERNELS) or off_path:
        raise AssertionError(f"cnn train path launches {counts}")
    losses = [h["loss"] for h in run.history]
    if len(losses) != CNN_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"cnn train losses {losses}")
    if dataclasses.astuple(run.cfg)[1:] != \
            dataclasses.astuple(models.MOBILENETV2_TINY)[1:]:
        raise AssertionError(f"not MobileNetV2-tiny: {run.cfg}")
    n_leaves = len(tree_leaves(run.state["quant"]))
    inited = [int(h["inited_sites"]) for h in run.history]
    if inited != [n_leaves] * CNN_STEPS:
        raise AssertionError(f"initialized quant leaves per step {inited} "
                             f"of {n_leaves}")
    step_ms = [h["step_ms"] for h in run.history]
    steady = sum(step_ms[1:]) / len(step_ms[1:])
    img_s = CNN_BATCH / (steady / 1e3)
    log("cnn-train", f"MobileNetV2-tiny B={CNN_BATCH} 64x64, SGD-M, 2 "
                     f"calibration batches: losses "
                     f"{[round(v, 4) for v in losses]}; step 0 "
                     f"{step_ms[0]:.1f} ms (first-batch double pass), steps "
                     f"1-{CNN_STEPS - 1} {[round(v, 1) for v in step_ms[1:]]}"
                     f" ms, {img_s:.1f} images/s; peak {peak:.2f} GiB; "
                     f"{inited[0]} of {n_leaves} quant leaves initialized "
                     f"after step 0; launches {counts} (per step "
                     f"{ {k: v / CNN_STEPS for k, v in counts.items()} }, "
                     f"calibration and eval add none: 16-bit grids and "
                     f"forward-only fp32 or int8 sites); eval acc "
                     f"{run.acc:.4f}")
    step = cnn_train.make_cnn_train_step(
        run.cfg, run.policy, sgdm(momentum=0.9, weight_decay=1e-4),
        constant(0.01))
    stream = ImageStream(200, 64, 3, CNN_BATCH, seed=0)
    batch = {k: v.to(dev) for k, v in stream.batch(CNN_STEPS).items()}

    def once():
        run.state, met = step(run.state, batch)
        float(met["loss"])
    ops.reset_launch_counts()
    prof = profile_device(once, "cnn-profile")
    per_step = ops.launch_counts()
    ranges = profile_device(once, "cnn-profile", ranges=DW_RANGES)["ranges"]
    conv_ms = ranges["qconv_int8_fused"] + ranges["qconv_int8_bwd"]
    dw_ms = ranges["qconv_int8_fused_depthwise"] \
        + ranges["qconv_int8_bwd_depthwise"]
    log("cnn-profile", f"conv sites (forward + backward, lowering "
                       f"included) {conv_ms:.1f} ms of the step's device "
                       f"time, of which the 17 depthwise convs "
                       f"{dw_ms:.1f} ms: {100 * dw_ms / prof['busy_ms']:.1f}%"
                       f" of the busy time of the kernels-only profile; "
                       f"launches in one step {per_step}")
    out = dict(losses=losses, step_ms=step_ms, steady_step_ms=steady,
               images_per_s=img_s, peak_gib=peak, launches=counts,
               launches_per_step=per_step, inited=inited, acc=run.acc,
               profile=prof, conv_ms=conv_ms, depthwise_ms=dw_ms,
               depthwise_share=dw_ms / prof["busy_ms"])
    policy = run.policy
    del run, step, batch, prof
    torch.cuda.empty_cache()

    for cfg in (models.RESNET18_TINY, models.VGG16_TINY):
        torch.cuda.reset_peak_memory_stats()
        r = cnn_train.train_cnn(cfg, policy, steps=1,
                                batch=CNN_BATCH, calibration_batches=0,
                                eval_batches=0, device=dev)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        (h,) = r.history
        if not math.isfinite(h["loss"]):
            raise AssertionError(f"{cfg.name} loss {h['loss']}")
        log("cnn-train", f"{cfg.name} B={CNN_BATCH} 64x64, one step (the "
                         f"first: first-batch double pass): loss "
                         f"{h['loss']:.4f}, {h['step_ms']:.1f} ms, "
                         f"{CNN_BATCH / (h['step_ms'] / 1e3):.1f} images/s; "
                         f"peak {peak:.2f} GiB")
        out[cfg.name] = dict(loss=h["loss"], step_ms=h["step_ms"],
                             peak_gib=peak)
        del r
        torch.cuda.empty_cache()
    return out


def _tf32_guard(dev, gen) -> dict:
    """The conv site's fp32 products with TF32 on globally: its backward
    (``dw``) and its fp path's forward held against float64.  TF32's
    10-bit mantissa gives errors near 1e-3; full fp32 near 1e-6."""
    from repro_torch.core import backend
    from repro_torch.core.calibration import observation_policy
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import ops

    plan = ops.plan_conv((8, 32, 32, 64), (3, 3, 64, 64), 1, "SAME", 1, 1)
    x = torch.randn((8, 32, 32, 64), generator=gen, device=dev)
    w = torch.randn((3, 3, 64, 64), generator=gen, device=dev) * 0.05
    g = torch.randn((8, 32, 32, 64), generator=gen, device=dev)
    pol = QuantPolicy.w8a8g8(backend="fused")
    xq = x.clone().requires_grad_(True)
    wq = w.clone().requires_grad_(True)
    one = torch.ones((), device=dev)
    qx = backend.QTensor(torch.randint(0, 256, x.shape, generator=gen,
                                       device=dev, dtype=torch.uint8),
                         one * 0.02, one * 128.0)
    qw = backend.QTensor(torch.randint(-127, 128, w.shape, generator=gen,
                                       device=dev, dtype=torch.int8),
                         one * 0.001, one * 0.0)
    y = backend.qconv(pol, xq, qx, wq, qw)
    (dw,) = torch.autograd.grad(y, [wq], g)
    xl = ops.conv_patches(x.double(), plan, 0.0)
    gl = ops.conv_lower_output(g.double(), plan)
    dw64 = ops.conv_unlower_weights(torch.bmm(xl.transpose(1, 2), gl), plan)
    dw_rel = ((dw.double() - dw64).abs().max() / dw64.abs().max()).item()
    y_fp = backend.qconv(observation_policy(pol), x, None, w, None)
    y64 = backend._conv_fp(x.double(), w.double(), plan)
    fp_rel = ((y_fp.double() - y64).abs().max() / y64.abs().max()).item()
    if not (dw_rel <= 1e-5 and fp_rel <= 1e-5):
        raise AssertionError(f"fp32 products not full fp32 under global "
                             f"TF32: dw rel {dw_rel:.3e}, fp conv rel "
                             f"{fp_rel:.3e} (limit 1e-5)")
    return dict(dw_rel=dw_rel, fp_conv_rel=fp_rel)


def cnn_parity_phase(dev) -> dict:
    """Phase 11: ``CNN_PARITY_STEPS`` steps of a reduced MobileNetV2
    (width 0.25, 16 x 16, 4 classes, batch 4, seed 1), fused vs simulated
    backend from the same parameters, batches and noise, with TF32
    switched on globally so a leak into the port's fp32 products would
    show.  Losses, quant states, BN states and parameters must be
    bit-equal: both backends compute every int contraction exactly and
    share every fp op."""
    from repro_torch.cnn import models
    from repro_torch.cnn import train as cnn_train
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.state import tree_leaves
    from repro_torch.data import ImageStream
    from repro_torch.kernels import ops
    from repro_torch.optim import sgdm
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime.steps import named_params

    cfg = models.bench_config("mobilenetv2", num_classes=4, width=0.25,
                              image_size=16)
    stream = ImageStream(4, 16, 3, 4, seed=1)
    batches = [{k: v.to(dev) for k, v in stream.batch(i).items()}
               for i in range(CNN_PARITY_STEPS)]
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = True
    out = {}
    try:
        for bk in ("fused", "simulated"):
            params, bn = models.init(cfg, seed=1, device=dev)
            for p in params.parameters():
                p.requires_grad_(True)
            opt = sgdm(momentum=0.9, weight_decay=1e-4)
            state = {"params": params, "bn": bn,
                     "opt": opt.init(named_params(params)),
                     "quant": models.init_sites(cfg, device=dev), "step": 0}
            step = cnn_train.make_cnn_train_step(
                cfg, QuantPolicy.w8a8g8(backend=bk), opt, constant(0.05))
            ops.reset_launch_counts()
            losses = []
            for b in batches:
                state, met = step(state, b)
                losses.append(float(met["loss"]))
            counts = ops.launch_counts()
            ok = all(counts[k] for k in CNN_KERNELS) if bk == "fused" \
                else not any(counts.values())
            if not ok:
                raise AssertionError(f"{bk} backend launches {counts}")
            out[bk] = (losses,
                       [t.detach().clone() for t in params.parameters()],
                       tree_leaves(state["bn"]), tree_leaves(state["quant"]))
        gen = torch.Generator(device=dev).manual_seed(11)
        guard = _tf32_guard(dev, gen)
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved
    (lf, pf, bf, qf), (ls, ps, bs, qs) = out["fused"], out["simulated"]
    diff = {name: sum(int(not torch.equal(a, b)) for a, b in zip(x, y))
            for name, x, y in (("params", pf, ps), ("bn", bf, bs),
                               ("quant", qf, qs))}
    if lf != ls or any(diff.values()):
        raise AssertionError(f"cnn parity: losses {lf} vs {ls}, differing "
                             f"tensors {diff}")
    log("cnn-parity", f"reduced MobileNetV2 (width 0.25, 16x16, 4 classes, "
                      f"B=4), {CNN_PARITY_STEPS} steps with TF32 on "
                      f"globally, fused vs simulated: losses {lf} "
                      f"identical; all {len(pf)} parameters, {len(bf)} BN "
                      f"and {len(qf)} quant tensors bit-equal; the conv "
                      f"site's fp32 products against float64: dw rel "
                      f"{guard['dw_rel']:.3e}, fp conv rel "
                      f"{guard['fp_conv_rel']:.3e} (limit 1e-5)")
    return dict(losses=lf, n_params=len(pf), n_bn=len(bf), n_quant=len(qf),
                **guard)


# ---------------------------------------------------------------------------
# Phases 12-16: telemetry, the overflow guard and checkpoints.
# ---------------------------------------------------------------------------
def _finite_records(records: dict, what: str) -> None:
    bad = [k for k, r in records.items()
           if not all(math.isfinite(v) for v in r.values())]
    if not records or bad:
        raise AssertionError(f"{what}: {len(records)} site records, "
                             f"non-finite {bad[:5]}")


def _check_psites(records: dict, n_expect: int, what: str) -> int:
    """Every attention probability site's counters come from the kernel's
    full-tensor partials: n counts every probability, and err and sig are
    positive (0 < SQNR < its 99 dB cap)."""
    ps = {k: r for k, r in records.items() if "/core/p/act" in k}
    bad = [k for k, r in ps.items()
           if r["n"] != n_expect or not 0 < r["sqnr_db"] < 99]
    if not ps or bad:
        raise AssertionError(f"{what}: p-site records {len(ps)}, wrong "
                             f"{bad[:3]} (n expected {n_expect})")
    return len(ps)


def _report(path: str, tag: str) -> dict:
    """``repro_torch.telemetry.report`` on a JSONL: the health table (the
    worst sites) and the perf table, as a user renders them."""
    from repro_torch.telemetry import report
    print(f"[{tag}] python -m repro_torch.telemetry.report {path} --top 6",
          flush=True)
    summary = report.main([path, "--top", "6", "--events", "4"])
    perf = report.main([path, "--perf", "--slowest", "2"])
    if not summary:
        raise AssertionError(f"{tag}: the report found no sites in {path}")
    return dict(sites=len(summary), perf=perf and {
        k: v for k, v in perf.items() if k != "records"})


def _overhead(step_off, state_off, step_on, state_on, batch, collect,
              pairs: int = 2) -> dict:
    """Steady steps with telemetry off and on, in turns (off, on, on, off,
    ...), each fenced by a host read and a synchronize; the "on" step
    includes the driver's telemetry phase (``collect``)."""
    times = {"off": [], "on": []}
    order = ["off", "on", "on", "off"] * ((pairs + 1) // 2)
    for which in order[:2 * pairs]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "off":
            state_off, met = step_off(state_off, batch)
            float(met["loss"])
        else:
            state_on, met = step_on(state_on, batch)
            float(met["loss"])
            collect(state_on["quant"])
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3)
    off = sum(times["off"]) / len(times["off"])
    on = sum(times["on"]) / len(times["on"])
    return dict(off_ms=times["off"], on_ms=times["on"], off_mean_ms=off,
                on_mean_ms=on, overhead_pct=100 * (on - off) / off)


def _narrow(quant):
    from repro_torch.core.state import tree_map
    return tree_map(lambda leaf: leaf[:3].clone(), quant)


def tele_train_phase(cfg, dev, out_dir: Path) -> dict:
    """Phase 12: ``launch.train.main`` with ``--telemetry --guard`` (widen)
    at full width and depth, the launch counters zeroed just before and
    read just after; the JSONL checked and rendered; then the steady step
    with telemetry off and on, in turns."""
    from repro_torch import data, telemetry
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import steps

    tdir = out_dir / "tele_train"
    shutil.rmtree(tdir, ignore_errors=True)
    argv = ["--arch", cfg.name, "--batch", str(BATCH), "--seq", str(PROMPT),
            "--steps", str(TRAIN_STEPS), "--log-every", "1", "--telemetry",
            "--guard", "--telemetry-dir", str(tdir)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = train.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(counts[k] > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"telemetry train path launches {counts}")
    if not all(math.isfinite(v) for v in run.losses):
        raise AssertionError(f"losses {run.losses}")
    lines = telemetry.read_jsonl_records(run.telemetry_path)
    if [ln["step"] for ln in lines] != list(range(TRAIN_STEPS)) or \
            not all(ln["perf"] for ln in lines):
        raise AssertionError(f"JSONL steps {[ln['step'] for ln in lines]}")
    last = lines[-1]["sites"]
    _finite_records(last, "tele-train")
    n_p = _check_psites(last, BATCH * cfg.n_heads * PROMPT * PROMPT,
                        "tele-train")
    rendered = _report(run.telemetry_path, "tele-train")
    tele_ms = [ln["perf"]["phases_ms"].get("telemetry", 0.0) for ln in lines]
    log("tele-train", f"{cfg.n_layers} layers B={BATCH} S={PROMPT} "
                      f"--telemetry --guard: losses "
                      f"{[round(v, 4) for v in run.losses]}; steps "
                      f"{[round(v, 1) for v in run.step_ms]} ms; the "
                      f"telemetry phase (collect + events) "
                      f"{[round(v, 2) for v in tele_ms]} ms; {len(last)} "
                      f"site records, all finite; {n_p} p-sites with the "
                      f"kernel's exact n = {BATCH * cfg.n_heads * PROMPT ** 2}"
                      f"; {len(run.events)} guard events; peak {peak:.2f} "
                      f"GiB; launches {counts}")
    # Telemetry off vs on, in turns, on the same parameters and batch.
    stream = data.for_arch(cfg, seq_len=PROMPT, global_batch=BATCH)
    batch = {k: v.to(dev) for k, v in stream.batch(TRAIN_STEPS).items()}
    step_on = steps.make_train_step(cfg, run.policy, adamw(), constant(1e-4))
    step_off = steps.make_train_step(
        cfg, QuantPolicy.w8a8g8(backend="fused"), adamw(), constant(1e-4))
    state_off = dict(run.state, quant=_narrow(run.state["quant"]))
    ov = _overhead(step_off, state_off, step_on, run.state, batch,
                   lambda q: telemetry.collect(q, cfg=cfg))
    log("tele-train", f"steady step, telemetry off vs on in turns: off "
                      f"{[round(v, 1) for v in ov['off_ms']]} ms, on "
                      f"{[round(v, 1) for v in ov['on_ms']]} ms: overhead "
                      f"{ov['overhead_pct']:.2f}% (not gated)")
    out = dict(losses=run.losses, step_ms=run.step_ms, telemetry_ms=tele_ms,
               sites=len(last), psites=n_p, events=len(run.events),
               peak_gib=peak, launches=counts,
               launches_per_step={k: v / TRAIN_STEPS
                                  for k, v in counts.items()},
               report=rendered, overhead=ov)
    del run, state_off, batch
    return out


def tele_cnn_phase(dev, out_dir: Path) -> dict:
    """Phase 13: ``cnn.train.main --guard`` on MobileNetV2-tiny (phase
    10's configuration), the JSONL checked and rendered, then the steady
    step with telemetry off and on, in turns."""
    from repro_torch import telemetry
    from repro_torch.cnn import train as cnn_train
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.state import tree_leaves
    from repro_torch.data import ImageStream
    from repro_torch.kernels import ops
    from repro_torch.optim import sgdm
    from repro_torch.optim.schedules import constant

    path = out_dir / "tele_cnn.jsonl"
    path.unlink(missing_ok=True)
    argv = ["--arch", "mobilenetv2", "--width", "1.0", "--image-size", "64",
            "--num-classes", "200", "--batch", str(CNN_BATCH), "--steps",
            str(CNN_STEPS), "--calibration-batches", "2", "--guard",
            "--telemetry-out", str(path)]
    ops.reset_launch_counts()
    run = cnn_train.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if not all(counts[k] > 0 for k in CNN_KERNELS):
        raise AssertionError(f"telemetry cnn path launches {counts}")
    leaves = tree_leaves(run.state["quant"])
    if len(leaves) != 106 or any(leaf.shape != (10,) for leaf in leaves):
        raise AssertionError(f"{len(leaves)} quant leaves, widths "
                             f"{ {tuple(leaf.shape) for leaf in leaves} }")
    lines = telemetry.read_jsonl_records(str(path))
    if [ln["step"] for ln in lines] != list(range(CNN_STEPS)):
        raise AssertionError(f"JSONL steps {[ln['step'] for ln in lines]}")
    _finite_records(lines[-1]["sites"], "tele-cnn")
    rendered = _report(str(path), "tele-cnn")
    step_ms = [h["step_ms"] for h in run.history]
    tele_ms = [ln["perf"]["phases_ms"].get("telemetry", 0.0) for ln in lines]
    log("tele-cnn", f"MobileNetV2-tiny B={CNN_BATCH} --guard: losses "
                    f"{[round(h['loss'], 4) for h in run.history]}; steps "
                    f"{[round(v, 1) for v in step_ms]} ms; the telemetry "
                    f"phase {[round(v, 2) for v in tele_ms]} ms; 106 quant "
                    f"leaves at width 10, {len(lines[-1]['sites'])} site "
                    f"records, all finite; launches {counts}")
    stream = ImageStream(200, 64, 3, CNN_BATCH, seed=0)
    batch = {k: v.to(dev) for k, v in stream.batch(CNN_STEPS).items()}
    opt = sgdm(momentum=0.9, weight_decay=1e-4)
    step_on = cnn_train.make_cnn_train_step(run.cfg, run.policy, opt,
                                            constant(0.01))
    step_off = cnn_train.make_cnn_train_step(
        run.cfg, QuantPolicy.w8a8g8(backend="fused"), opt, constant(0.01))
    state_off = dict(run.state, quant=_narrow(run.state["quant"]))
    ov = _overhead(step_off, state_off, step_on, run.state, batch,
                   telemetry.collect)
    log("tele-cnn", f"steady step, telemetry off vs on in turns: off "
                    f"{[round(v, 1) for v in ov['off_ms']]} ms, on "
                    f"{[round(v, 1) for v in ov['on_ms']]} ms: overhead "
                    f"{ov['overhead_pct']:.2f}% (not gated)")
    out = dict(losses=[h["loss"] for h in run.history], step_ms=step_ms,
               telemetry_ms=tele_ms, launches=counts, report=rendered,
               overhead=ov)
    del run, state_off, batch
    return out


def tele_serve_phase(cfg, out_dir: Path) -> dict:
    """Phase 14: ``launch.serve.main --telemetry PATH`` at full width and
    depth: per-site prefill records, the p-sites' exact counters."""
    from repro_torch import telemetry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    path = out_dir / "tele_serve.jsonl"
    path.unlink(missing_ok=True)
    ops.reset_launch_counts()
    run = serve.main(["--arch", cfg.name, "--batch", str(BATCH),
                      "--prompt-len", str(PROMPT), "--gen", "4",
                      "--telemetry", str(path)])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if not all(counts[k] > 0 for k in SERVE_KERNELS):
        raise AssertionError(f"telemetry serve path launches {counts}")
    ((step, recs),) = telemetry.read_jsonl(str(path))
    _finite_records(recs, "tele-serve")
    n_p = _check_psites(recs, BATCH * cfg.n_heads * PROMPT * PROMPT,
                        "tele-serve")
    p0 = recs["decoder/blocks/b0/attn/core/p/act[0]"]
    rendered = _report(str(path), "tele-serve")
    log("tele-serve", f"prefill B={BATCH} S={PROMPT} with --telemetry: "
                      f"{run.prefill_ms:.1f} ms; {len(recs)} site records, "
                      f"all finite; layer 0's p-site: n {p0['n']:.0f}, "
                      f"clipped {p0['clipped']:.0f}, SQNR "
                      f"{p0['sqnr_db']:.2f} dB, util {p0['util']:.4f}; "
                      f"launches {counts}")
    out = dict(prefill_ms=run.prefill_ms, sites=len(recs), psites=n_p,
               p0=p0, launches=counts, report=rendered)
    del run
    return out


GUARD_FIRE = dict(guard=True, clip_threshold=0.0, patience=1)


def guard_parity_phase(cfg, dev) -> dict:
    """Phase 15: fused vs simulated with telemetry and a guard that fires
    (threshold 0, patience 1).  (a) The reduced MobileNetV2 of phase 11,
    TF32 on globally, 3 steps: width-10 quant trees, BN states and
    parameters bit-equal, guard event lists equal, at least one widen.
    (b) Phase 8's LM configuration (4 layers at full width), one forward +
    backward: the statistics trees within phase 8's tolerances, the
    telemetry slots within the ones stated below."""
    from repro_torch import data, telemetry
    from repro_torch.cnn import models
    from repro_torch.cnn import train as cnn_train
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.state import tree_leaves, tree_map_with_path
    from repro_torch.data import ImageStream
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.optim import adamw, sgdm
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import steps
    from repro_torch.runtime.steps import named_params

    ccfg = models.bench_config("mobilenetv2", num_classes=4, width=0.25,
                               image_size=16)
    stream = ImageStream(4, 16, 3, 4, seed=1)
    batches = [{k: v.to(dev) for k, v in stream.batch(i).items()}
               for i in range(GUARD_STEPS)]
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = True
    out = {}
    try:
        for bk in ("fused", "simulated"):
            policy = QuantPolicy.w8a8g8().with_telemetry(**GUARD_FIRE) \
                .with_backend(bk)
            params, bn = models.init(ccfg, seed=1, device=dev)
            for p in params.parameters():
                p.requires_grad_(True)
            opt = sgdm(momentum=0.9, weight_decay=1e-4)
            state = {"params": params, "bn": bn,
                     "opt": opt.init(named_params(params)),
                     "quant": models.init_sites(ccfg, policy, device=dev),
                     "step": 0}
            step = cnn_train.make_cnn_train_step(ccfg, policy, opt,
                                                 constant(0.05))
            det = telemetry.GuardEventDetector(policy.telemetry, policy)
            ops.reset_launch_counts()
            losses, events = [], []
            for i, b in enumerate(batches):
                state, met = step(state, b)
                losses.append(float(met["loss"]))
                events += det.update(i, telemetry.collect(state["quant"]))
            counts = ops.launch_counts()
            ok = all(counts[k] for k in CNN_KERNELS) if bk == "fused" \
                else not any(counts.values())
            if not ok:
                raise AssertionError(f"{bk} backend launches {counts}")
            out[bk] = (losses, events,
                       [t.detach().clone() for t in params.parameters()],
                       tree_leaves(state["bn"]), tree_leaves(state["quant"]))
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved
    (lf, ef, pf, bf, qf), (ls, es, ps, bs, qs) = out["fused"], \
        out["simulated"]
    diff = {name: sum(int(not torch.equal(a, b)) for a, b in zip(x, y))
            for name, x, y in (("params", pf, ps), ("bn", bf, bs),
                               ("quant", qf, qs))}
    widens = sum(e["action"] == "widen" for e in ef)
    if lf != ls or any(diff.values()) or ef != es or not widens \
            or any(q.shape != (10,) for q in qf):
        raise AssertionError(f"guard parity (cnn): losses {lf} vs {ls}, "
                             f"differing tensors {diff}, events "
                             f"{len(ef)} vs {len(es)} ({widens} widens)")
    log("guard-parity", f"reduced MobileNetV2, {GUARD_STEPS} steps with "
                        f"TF32 on globally, telemetry + guard (threshold 0, "
                        f"patience 1), fused vs simulated: losses {lf} "
                        f"identical; {len(qf)} width-10 quant, {len(bf)} BN "
                        f"and {len(pf)} parameter tensors bit-equal; "
                        f"{len(ef)} guard events equal, {widens} widens")
    res = dict(cnn=dict(losses=lf, events=len(ef), widens=widens,
                        n_quant=len(qf)))
    del out

    # (b) The LM, phase 8's configuration, one forward + backward.
    cfg4 = cfg
    state = steps.init_train_state(cfg4, adamw(), seed=1, device=dev)
    stream = data.for_arch(cfg4, seq_len=PROMPT, global_batch=BATCH, seed=1)
    batch = {k: v.to(dev) for k, v in stream.batch(0).items()}
    fb = {}
    for bk in ("fused", "simulated"):
        policy = QuantPolicy.w8a8g8().with_telemetry(**GUARD_FIRE) \
            .with_backend(bk)
        quant = model.init_quant_state(cfg4, policy, device=dev)
        fb[bk] = steps.forward_backward(cfg4, policy, state["params"], quant,
                                        batch, 0, 0)[2]
        torch.cuda.synchronize()
    worst = {}

    def cmp(path, a, b):
        kind = "grad" if path[-1] == "grad" else "act"
        if not (torch.equal(a[2], b[2]) and torch.equal(a[4], b[4])):
            raise AssertionError(f"visited flags or counts differ at {path}")
        rel = ((a - b).abs() / b.abs().clamp(min=1e-12))
        for name, idx in (("range", [0, 1]), ("err", [5]), ("sig", [6]),
                          ("util", [7])):
            key = f"{kind}_{name}"
            worst[key] = max(worst.get(key, 0.0), rel[idx].max().item())
        rate = ((a[3] - b[3]).abs() / b[4].clamp(min=1.0)).item()
        worst[f"{kind}_clip_rate"] = max(worst.get(f"{kind}_clip_rate", 0.0),
                                         rate)
    tree_map_with_path(cmp, fb["fused"], fb["simulated"])
    # Phase 8's limits for the ranges (act 1e-2, grad 5e-2 relative), the
    # same for util (a ratio of ranges); err/sig 5e-2 / 1e-1 relative and
    # clip rates 1e-3 absolute: one flipped probability level (expf vs
    # torch.exp) moves the stochastic roundings below it by a level.
    limits = dict(act_range=1e-2, grad_range=5e-2, act_util=1e-2,
                  grad_util=5e-2, act_err=5e-2, grad_err=1e-1, act_sig=5e-2,
                  grad_sig=1e-1, act_clip_rate=1e-3, grad_clip_rate=1e-3)
    over = {k: v for k, v in worst.items() if v > limits[k]}
    if over:
        raise AssertionError(f"guard parity (LM): {over} over {limits}")
    log("guard-parity", f"{PARITY_LAYERS} LM layers at full width, one "
                        f"forward + backward with telemetry, fused vs "
                        f"simulated: flags and counts equal; worst "
                        + ", ".join(f"{k} {v:.3e}" for k, v in
                                    sorted(worst.items()))
                        + f" (limits {limits})")
    res["lm"] = worst
    del state, fb
    return res


def _tree_equal(a, b) -> list:
    """Paths where two train states differ (tensors bit for bit, numbers
    exactly)."""
    from repro_torch.checkpoint.checkpoint import _flatten
    la, lb = list(_flatten(a)), list(_flatten(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["<structure>"]
    return [p for (p, x), (_, y) in zip(la, lb)
            if not (torch.equal(x, y) and x.dtype == y.dtype
                    if isinstance(x, torch.Tensor) else x == y)]


def _tree_spread(a, b) -> dict:
    """Largest relative difference per top-level part of two states."""
    from repro_torch.checkpoint.checkpoint import _flatten
    out = {}
    for (p, x), (_, y) in zip(_flatten(a), _flatten(b)):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            d = ((x - y).abs().max() / x.abs().max().clamp(min=1e-30)).item()
            part = p.split("/")[0]
            out[part] = max(out.get(part, 0.0), d)
    return out


class _Preempted:
    """The driver's stream, sending this process SIGTERM while it fetches
    batch ``at``: the driver finishes that step, checkpoints and stops
    (the reference's preemption path), with the full run's LR schedule."""

    def __init__(self, stream, at: int):
        self.stream, self.at = stream, at

    def batch(self, i):
        if i == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.stream.batch(i)


def ckpt_phase(cfg, out_dir: Path) -> dict:
    """Phase 16: checkpoint and resume, starcoder2-3b at full width with
    depth cut to ``CKPT_LAYERS`` layers (1: 0.398 B parameters; a 4.78 GB
    checkpoint with the AdamW moments), through ``launch.train.main`` and
    ``launch.serve.main``: a 3-step run uninterrupted; the same run
    with ``--ckpt-dir --ckpt-every 1 --telemetry`` preempted after step 2;
    the restored step-2 state against that run's in-memory one; ``--resume``
    to step 3 against the uninterrupted run; then serving from the
    checkpoint against serving the same state from memory."""
    from repro_torch import checkpoint, configs, data, telemetry
    from repro_torch.configs.arch import register
    from repro_torch.launch import serve, train

    cfg2 = dataclasses.replace(cfg, name=f"{cfg.name}-{CKPT_LAYERS}l",
                               n_layers=CKPT_LAYERS)
    configs.names()                 # load the registry before adding to it
    register(cfg2, lambda: cfg2)
    ck = out_dir / "ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", cfg2.name, "--batch", str(BATCH), "--seq",
            str(PROMPT), "--steps", "3", "--log-every", "1", "--telemetry",
            "--telemetry-dir", str(out_dir / "ckpt_tele")]

    def straight():
        run = train.main(argv)
        torch.cuda.synchronize()
        return run.state

    def preempted():
        real = data.for_arch
        data.for_arch = lambda *a, **k: _Preempted(real(*a, **k), 1)
        try:
            return train.main(argv + ["--ckpt-dir", str(ck),
                                      "--ckpt-every", "1"])
        finally:
            data.for_arch = real

    # Does a 3-step run repeat itself bit for bit on the card?  If not,
    # the phase runs under torch.use_deterministic_algorithms; if some op
    # has no deterministic form, the resumed run is held to the spread of
    # two repeats.
    ref, again = straight(), straight()
    ref2 = None
    differ = _tree_equal(ref, again)
    mode, spread = "default", _tree_spread(ref, again) if differ else {}
    if differ:
        log("ckpt", f"two uninterrupted runs differ at {len(differ)} "
                    f"leaves (first {differ[:3]}; spread {spread}): "
                    f"rerunning under torch.use_deterministic_algorithms")
        again = None
        torch.use_deterministic_algorithms(True)
        try:
            ref2, again = straight(), straight()
        except RuntimeError as e:
            torch.use_deterministic_algorithms(False)
            mode = f"spread; no deterministic form: {str(e)[:200]}"
        else:
            ref, mode = ref2, "deterministic"
            differ = _tree_equal(ref, again)
            spread = _tree_spread(ref, again) if differ else {}
    again = ref2 = None
    try:
        shutil.rmtree(ck, ignore_errors=True)
        first = preempted()
        if first.state["step"] != 2 or checkpoint.all_steps(str(ck)) != [1, 2]:
            raise AssertionError(f"preempted run ended at step "
                                 f"{first.state['step']}, checkpoints "
                                 f"{checkpoint.all_steps(str(ck))}")
        nbytes = sum(os.path.getsize(ck / f"step_{2:010d}" / f)
                     for f in ("arrays.npz", "manifest.json"))
        save_ms = first.ckpt_ms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = checkpoint.restore(str(ck), 2, first.state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        bad = _tree_equal(first.state, restored)
        if bad:
            raise AssertionError(f"restored step-2 state differs from the "
                                 f"saving run's at {bad[:5]}")
        del restored, first
        resumed = train.main(argv + ["--ckpt-dir", str(ck), "--resume"])
        torch.cuda.synchronize()
        res_bad = _tree_equal(ref, resumed.state)
        res_spread = _tree_spread(ref, resumed.state) if res_bad else {}
        # Bit-equal where two repeats are; otherwise within twice the
        # repeats' own spread, part by part.
        if res_bad and (not differ or any(
                v > 2 * spread.get(k, 0.0) for k, v in res_spread.items())):
            raise AssertionError(f"resumed step 3 differs from the "
                                 f"uninterrupted run at {len(res_bad)} "
                                 f"leaves ({res_bad[:3]}; spread "
                                 f"{res_spread}, repeat spread {spread})")
        # Serve the checkpoint (step 3) and the same state from memory.
        spath = str(out_dir / "ckpt_serve.jsonl")
        served = serve.main(["--arch", cfg2.name, "--batch", str(BATCH),
                             "--prompt-len", str(PROMPT), "--gen", "2",
                             "--ckpt-dir", str(ck), "--telemetry", spath,
                             "--verbose"])
        policy = served.policy
        mem = serve.generate(resumed.state["params"], resumed.state["quant"],
                             served.prompt, cfg2, policy, 2)
        same = torch.equal(served.prefill_logits, mem.prefill_logits)
        if not same or not torch.isfinite(served.prefill_logits).all():
            d = (served.prefill_logits - mem.prefill_logits).abs().max()
            raise AssertionError(f"served-from-checkpoint prefill logits "
                                 f"differ from in-memory by {d.item():.3e}")
        _finite_records(telemetry.read_jsonl(spath)[0][1], "ckpt-serve")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ck, ignore_errors=True)
    gb = nbytes / 1e9
    n_params = sum(p.numel() for p in ref["params"].parameters()) / 1e9
    repeat = "bit-equal" if not differ else f"differs, spread {spread}"
    resumed_as = "bit-equal to" if not res_bad else f"within {res_spread} of"
    log("ckpt", f"{cfg2.name}: {n_params:.3f} B parameters; repeat of the "
                f"uninterrupted run: {repeat} ({mode}); restored step 2 "
                f"bit-equal to the saving run's state (params, AdamW "
                f"m/v/count, width-10 quant, step); resumed step 3 "
                f"{resumed_as} the uninterrupted run; checkpoint {gb:.3f} "
                f"GB: saves {[round(v, 1) for v in save_ms]} ms "
                f"({[round(gb / (v / 1e3), 3) for v in save_ms]} GB/s), "
                f"restore {restore_ms:.1f} ms ({gb / (restore_ms / 1e3):.3f} "
                f"GB/s); served from the checkpoint: prefill logits equal "
                f"to serving the state from memory")
    return dict(params_b=n_params, repeat_equal=not differ,
                repeat_spread=spread,
                mode=mode, resumed_equal=not res_bad,
                resumed_spread=res_spread, ckpt_gb=gb, save_ms=save_ms,
                restore_ms=restore_ms, save_gbps=[gb / (v / 1e3)
                                                  for v in save_ms],
                restore_gbps=gb / (restore_ms / 1e3), serve_equal=same)


# ---------------------------------------------------------------------------
# Phases 17-19: the MoE LM family (qwen2-moe-a2.7b).
# ---------------------------------------------------------------------------
class _MoeSpy:
    """Records, without launching anything, the batch dimension and rows of
    every ``int8_matmul_fp`` launch and the first router call's top-k
    selection (layer 0 of a prefill)."""

    def __init__(self):
        from repro_torch.kernels import int8_matmul as mm
        from repro_torch.models import moe
        self.mm, self.moe = mm, moe
        self.real_mm = mm.int8_matmul_fp_cuda_staged
        self.real_gating = moe._top_k_gating
        self.shapes: set = set()
        self.layer0 = None

    def __enter__(self):
        def staged(xk, wk, zp, alpha, **kw):
            self.shapes.add(tuple(xk.shape[:2]))
            return self.real_mm(xk, wk, zp, alpha, **kw)

        def gating(logits, spec):
            out = self.real_gating(logits, spec)
            if self.layer0 is None:
                self.layer0 = out[0] > 0
            return out
        self.mm.int8_matmul_fp_cuda_staged = staged
        self.moe._top_k_gating = gating
        return self

    def __exit__(self, *exc):
        self.mm.int8_matmul_fp_cuda_staged = self.real_mm
        self.moe._top_k_gating = self.real_gating


def moe_serve_phase(mcfg, records, results):
    """Phase 17: ``launch.serve.main`` on qwen2-moe-a2.7b at full width and
    depth (24 layers, 14.31 B parameters, 57.3 GB in fp32), batch 4 x
    1024-token prompts, ``GEN_RATE`` generated, fused backend, with the launch
    counters zeroed just before and read just after.  Returns the run
    (its parameters are phase 18's)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    argv = ["--arch", mcfg.name, "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN_RATE)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _MoeSpy() as spy:
        run = serve.main(argv)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(counts[k] > 0 for k in SERVE_KERNELS):
        raise AssertionError(f"a kernel of the MoE serve path never "
                             f"launched: {counts}")
    e = mcfg.moe.n_experts
    want = {(e, mcfg.moe.capacity() * BATCH * PROMPT
             // mcfg.moe.group_size), (e, mcfg.moe.capacity(BATCH))}
    if not want <= spy.shapes:
        raise AssertionError(f"the experts never ran on the kernel's batch "
                             f"dimension as {want}: {sorted(spy.shapes)}")
    if not torch.isfinite(run.prefill_logits).all():
        raise AssertionError("non-finite MoE prefill logits")
    n_params = sum(p.numel() for p in run.params.parameters())
    log("moe-serve", f"{mcfg.name}: {mcfg.n_layers} layers d="
                     f"{mcfg.d_model}, {n_params / 1e9:.3f} B parameters, "
                     f"B={BATCH} S={PROMPT} gen={GEN_RATE}: prefill "
                     f"{run.prefill_ms:.1f} ms, decode "
                     f"{run.decode_tok_s:.1f} tok/s ({run.decode_ms:.1f} ms "
                     f"for {GEN_RATE - 1} steps), peak {peak:.2f} GiB, "
                     f"launches "
                     f"{counts}; int8_matmul_fp (B, M) with B > 1: "
                     f"{sorted(x for x in spy.shapes if x[0] > 1)}")
    results["moe_serve"] = dict(prefill_ms=run.prefill_ms,
                                decode_ms=run.decode_ms,
                                decode_tok_s=run.decode_tok_s,
                                peak_gib=peak, launches=counts,
                                params_b=n_params / 1e9,
                                expert_shapes=sorted(spy.shapes),
                                **serve_profiles(run, "moe"))
    for r in records:
        r["moe_serve_launches"] = counts[r["name"]]
    _note_tiles(results, "moe serve")
    return run, spy.layer0


def serve_profiles(run, tag: str, prefill_ranges=()) -> dict:
    """One more prefill and one decode step of a serve run's state under
    the profiler (kernels only): device time by family and the idle share;
    with ``prefill_ranges``, the prefill once more with host ranges (the
    device time inside them)."""
    from repro_torch.models import model

    args = (run.params, run.quant_state)
    inputs = _inputs(run)
    b, s = run.prompt.shape
    if "patches" in inputs:
        s += inputs["patches"].shape[1]
    # an enc-dec cross cache holds every frame, as the served run's did
    cache_len = run.cache_len if "frames" in inputs else s + 1
    logits, caches = model.prefill(*args, inputs, run.cfg, run.policy,
                                   cache_len=cache_len)
    tok = torch.argmax(logits, dim=-1)[:, None]
    pos = torch.full((b,), s, dtype=torch.int64, device=tok.device)

    def prefill_once():
        out, _ = model.prefill(*args, inputs, run.cfg, run.policy)
        float(out[0, 0])

    def decode_once():      # rewrites the same cache slot each call
        out, _ = model.decode_step(*args, tok, pos, caches, run.cfg,
                                   run.policy)
        float(out[0, 0])
    out = dict(profile_prefill=profile_device(prefill_once,
                                              f"{tag}-prefill-profile"),
               profile_decode=profile_device(decode_once,
                                             f"{tag}-decode-profile"))
    if prefill_ranges:
        out["ranges_prefill"] = profile_device(
            prefill_once, f"{tag}-prefill-profile", prefill_ranges)["ranges"]
    del caches
    return out


def moe_parity_phase(run, layer0_fused, dev, results) -> None:
    """Phase 18: phase 17's prefill logits, fused vs simulated backend on
    the same parameters (no second copy) and prompt, under phase 6's
    tolerance; and the share of layer 0's routing decisions (tokens whose
    top-k selection is the same) on which the backends agree."""
    from repro_torch.kernels import ops
    from repro_torch.models import model

    sim = run.policy.with_backend("simulated")
    ops.reset_launch_counts()
    with _MoeSpy() as spy:
        logits_sim, _ = model.prefill(
            run.params, model.init_quant_state(run.cfg, device=dev),
            {"tokens": run.prompt}, run.cfg, sim)
        torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        raise AssertionError("the simulated backend launched a kernel")
    a, b = run.prefill_logits, logits_sim
    d_max = (a - b).abs().max().item()
    rel = ((a - b).norm() / b.norm()).item()
    same = torch.all(layer0_fused == spy.layer0, dim=-1).float().mean().item()
    if not (rel <= 1e-2 and d_max <= 0.1 and math.isfinite(rel)):
        raise AssertionError(f"MoE fused vs simulated: rel L2 {rel:.3e}, "
                             f"max |d| {d_max:.3e}")
    log("moe-parity", f"prefill logits fused vs simulated ({run.cfg.n_layers}"
                      f" layers, same parameters): rel L2 {rel:.3e}, max |d| "
                      f"{d_max:.3e} (tolerance: rel L2 <= 1e-2, max |d| <= "
                      f"0.1); layer-0 routing: {same:.6f} of "
                      f"{spy.layer0.shape[0] * spy.layer0.shape[1]} tokens "
                      f"select the same experts")
    results["moe_parity"] = dict(rel_l2=rel, max_abs=d_max,
                                 layer0_routing_agree=same)


MOE_RANGES = ("qmatmul_int8_fused egcd,edf->egcf",
              "qmatmul_int8_fused egcf,efd->egcd", "qmatmul_int8_fused")


def moe_train_phase(mcfg, dev, records) -> dict:
    """Phase 19: ``launch.train.main`` on qwen2-moe-a2.7b at full width
    with depth cut to ``MOE_TRAIN_LAYERS`` (its AdamW state at 24 layers,
    ~229 GB, fits no card), batch 4 x 1024, AdamW, ``TRAIN_STEPS`` steps,
    fused, the launch counters zeroed just before and read just after;
    one more step under the profiler twice (kernels only: families and
    idle share; with host ranges: the experts' int8 contractions); then
    phase 8's fused-vs-simulated check at ``MOE_PARITY_LAYERS`` layer."""
    from repro_torch import configs
    from repro_torch.configs.arch import register
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    cfg2 = dataclasses.replace(mcfg, name=f"{mcfg.name}-{MOE_TRAIN_LAYERS}l",
                               n_layers=MOE_TRAIN_LAYERS)
    configs.names()                 # load the registry before adding to it
    register(cfg2, lambda: cfg2)
    argv = ["--arch", cfg2.name, "--batch", str(BATCH), "--seq", str(PROMPT),
            "--steps", str(TRAIN_STEPS), "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = train.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(counts[k] > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a kernel of the MoE train path never "
                             f"launched: {counts}")
    if len(run.losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in run.losses):
        raise AssertionError(f"MoE train losses {run.losses}")
    aux = [m["aux_loss"] for m in run.metrics]
    zl = [m["z_loss"] for m in run.metrics]
    if not (all(v > 0 for v in aux) and all(math.isfinite(v) for v in zl)):
        raise AssertionError(f"MoE aux losses {aux}, z losses {zl}")
    n_params = sum(p.numel() for p in run.state["params"].parameters())
    steady = run.step_ms[1:]
    step_ms = sum(steady) / len(steady)
    tok_s = BATCH * PROMPT / (step_ms / 1e3)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    log("moe-train", f"{cfg2.name}: {MOE_TRAIN_LAYERS} layers d="
                     f"{mcfg.d_model}, {n_params / 1e9:.3f} B parameters, "
                     f"B={BATCH} S={PROMPT}, AdamW, remat: losses "
                     f"{[round(v, 4) for v in run.losses]}, aux "
                     f"{[round(v, 5) for v in aux]}, z "
                     f"{[round(v, 5) for v in zl]}; step 0 "
                     f"{run.step_ms[0]:.1f} ms, steps 1-{TRAIN_STEPS - 1} "
                     f"{[round(v, 1) for v in steady]} ms, {tok_s:.1f} "
                     f"tokens/s; peak {peak:.2f} GiB; launches per step "
                     f"{per_step}")
    prof = profile_step(run, "moe-train-profile")
    ranges = profile_step(run, "moe-train-profile",
                          ranges=MOE_RANGES)["ranges"]
    experts_ms = ranges[MOE_RANGES[0]] + ranges[MOE_RANGES[1]]
    fam_ms = prof["families"].get("int8_matmul_fp (ours)", (0.0, 0))[0]
    log("moe-train-profile", f"the experts' int8 contractions (forward and "
                             f"remat recompute; staging and partials "
                             f"included) {experts_ms:.1f} ms of all int8 "
                             f"contractions' {ranges[MOE_RANGES[2]]:.1f} ms; "
                             f"int8_matmul_fp kernels {fam_ms:.1f} ms of "
                             f"{prof['busy_ms']:.1f} ms busy "
                             f"({100 * fam_ms / prof['busy_ms']:.1f}%)")
    out = dict(losses=run.losses, step_ms=run.step_ms, steady_step_ms=step_ms,
               tokens_per_s=tok_s, peak_gib=peak, launches=counts,
               launches_per_step=per_step, aux_loss=aux, z_loss=zl,
               params_b=n_params / 1e9, profile=prof, ranges=ranges,
               experts_int8_ms=experts_ms)
    for r in records:
        r["moe_train_launches_per_step"] = per_step[r["name"]]
    del run, prof
    torch.cuda.empty_cache()
    cfg1 = dataclasses.replace(mcfg, n_layers=MOE_PARITY_LAYERS)
    out["parity"] = train_parity_phase(cfg1, dev, tag="moe-train-parity")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 20-25: the dense family past its window, the fp attention paths,
# command-r-35b and nemotron-4-340b at full width, the paper's policies.
# ---------------------------------------------------------------------------
class _FpSpy:
    """Records the first call of each fp attention path (``_local_attn``,
    ``_chunked_attn``, ``_dense_attn``): its q/k/v and keywords (layer 0),
    and counts every call."""

    NAMES = ("_local_attn", "_chunked_attn", "_dense_attn")

    def __init__(self):
        from repro_torch.models import attention
        self.mod = attention
        self.real = {n: getattr(attention, n) for n in self.NAMES}
        self.first: dict = {}
        self.calls = {n: 0 for n in self.NAMES}

    def __enter__(self):
        for name in self.NAMES:
            def wrapped(q, k, v, *, _n=name, **kw):
                self.calls[_n] += 1
                if _n not in self.first:
                    self.first[_n] = (q.detach().clone(), k.detach().clone(),
                                      v.detach().clone(), kw)
                return self.real[_n](q, k, v, **kw)
            setattr(self.mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.mod, name, fn)


def _register_cut(cfg, n_layers: int):
    """``cfg`` with its depth cut to ``n_layers``, registered under a name
    of its own so the drivers' ``--arch`` reaches it."""
    from repro_torch import configs
    from repro_torch.configs.arch import register

    cut = dataclasses.replace(cfg, name=f"{cfg.name}-{n_layers}l",
                              n_layers=n_layers)
    configs.names()                 # load the registry before adding to it
    register(cut, lambda: cut)
    return cut


def _prompt(cfg, batch: int, seq: int, dev):
    """The serve driver's prompt: the config's data stream, seed 0."""
    return _prompt_batch(cfg, batch, seq, dev)["tokens"]


def _prompt_batch(cfg, batch: int, seq: int, dev, stream_len=None):
    """The serve driver's prompt batch: ``seq`` tokens of the config's
    stream at ``stream_len`` (default ``seq + GEN``; seed 0), and its
    frames (enc-dec, ``stream_len`` of them) or image patches (VLM)."""
    from repro_torch import data
    stream = data.for_arch(cfg, seq_len=stream_len or seq + GEN,
                           global_batch=batch, seed=0)
    return {k: (v[:, :seq] if k == "tokens" else v).to(dev)
            for k, v in stream.batch(0).items()
            if k in ("tokens", "frames", "patches")}


def _serve_record(tag, what, run, counts, peak, kernels=SERVE_KERNELS):
    """Checks one serve run (every kernel of ``kernels`` launched, or none
    when ``kernels`` is empty; finite logits), logs and returns it."""
    if kernels and not all(counts[k] > 0 for k in kernels):
        raise AssertionError(f"{what}: a kernel of the path never "
                             f"launched: {counts}")
    if not kernels and any(counts.values()):
        raise AssertionError(f"{what}: launched a kernel: {counts}")
    if not torch.isfinite(run.prefill_logits).all():
        raise AssertionError(f"{what}: non-finite prefill logits")
    b, s = run.prompt.shape
    gen = run.tokens.shape[1]
    log(tag, f"{what} B={b} S={s} gen={gen}: prefill {run.prefill_ms:.1f} "
             f"ms, decode {run.decode_tok_s:.2f} tok/s ({run.decode_ms:.1f} "
             f"ms for {gen - 1} steps), peak {peak:.2f} GiB, launches "
             f"{counts}")
    return dict(prefill_ms=run.prefill_ms, decode_ms=run.decode_ms,
                decode_tok_s=run.decode_tok_s, peak_gib=peak,
                launches=counts, batch=b, seq=s)


def _generate(params, quant, prompt, cfg, policy, gen=GEN, **kw):
    """``serve.generate`` (``kw``: its ``cache_len`` / ``pos0``) with the
    launch counters zeroed just before and read just after; returns
    ``(run, counts, peak GiB)``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.generate(params, quant, prompt, cfg, policy, gen, **kw)
    torch.cuda.synchronize()
    return run, ops.launch_counts(), \
        torch.cuda.max_memory_allocated() / 2 ** 30


def sc7_serve_phase(dev, records, results):
    """Phase 20: starcoder2-7b at full width, depth cut to
    ``SC7_SERVE_LAYERS`` of its 32 layers, fused hindsight:
    ``launch.serve.main`` at batch 4 x 1024
    and ``serve.generate`` at 1 x 8192 (two windows: the int8 core's
    sliding mask masks, and decode wraps the 4096-slot ring), ``GEN_RATE``
    and 32 generated (phase 21 compares the long run's tokens), launch
    counters zeroed just before each and read just after.  Returns the run (phases 21-22 reuse its parameters)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model

    from repro_torch import configs
    cut = _register_cut(configs.get(LONG_ARCH), SC7_SERVE_LAYERS)
    argv = ["--arch", cut.name, "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN_RATE)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(argv)
    torch.cuda.synchronize()
    out = {"short": _serve_record(
        "sc7-serve", f"{run.cfg.name} {run.cfg.n_layers} layers fused",
        run, ops.launch_counts(),
        torch.cuda.max_memory_allocated() / 2 ** 30)}
    out["params_b"] = sum(p.numel() for p in run.params.parameters()) / 1e9
    cfg, policy = run.cfg, run.policy
    prompt = _prompt(cfg, 1, LONG_SEQ, dev)
    quant = model.init_quant_state(cfg, device=dev)
    long, counts, peak = _generate(run.params, quant, prompt, cfg, policy)
    out["long"] = _serve_record("sc7-serve", f"{cfg.name} fused, two "
                                f"windows", long, counts, peak)
    for r in records:
        r["sc7_serve_launches"] = counts[r["name"]]
    log("sc7-serve", f"{out['params_b']:.3f} B parameters; ring cache "
                     f"{cfg.sliding_window} slots, {LONG_SEQ + GEN - 1} "
                     f"positions written")
    results["sc7_serve"] = out
    return long


def _tokens_agree(run_a, run_b, cfg, dev) -> dict:
    """The two runs' greedy tokens: identical, or the first differing step
    is a near-tie: on the common prefix both backends' next-token logits
    (a prefill of prompt + the agreed tokens) differ by more than the
    fused run's top-2 margin there."""
    from repro_torch.models import model
    ta, tb = run_a.tokens, run_b.tokens
    same = (ta == tb).all(dim=0)
    if bool(same.all()):
        return dict(identical=True, first_diff=None)
    i = int((~same).nonzero()[0])
    inputs = dict(_inputs(run_a), tokens=torch.cat([run_a.prompt,
                                                    ta[:, :i]], dim=1))
    la, _ = model.prefill(run_a.params, model.init_quant_state(cfg,
                                                               device=dev),
                          inputs, cfg, run_a.policy)
    lb, _ = model.prefill(run_b.params, model.init_quant_state(cfg,
                                                               device=dev),
                          inputs, cfg, run_b.policy)
    top = la.topk(2, dim=-1).values
    margin = (top[:, 0] - top[:, 1]).min().item()
    d = (la - lb).abs().max().item()
    if margin > 2 * d:
        raise AssertionError(f"greedy tokens differ at step {i} with top-2 "
                             f"margin {margin:.3e} > 2 x max |d| {d:.3e}")
    return dict(identical=False, first_diff=i, margin=margin, max_abs=d)


def sc7_parity_phase(long, dev, results) -> None:
    """Phase 21: phase 20's 1 x 8192 fused run against the simulated
    backend on the same parameters and prompt: prefill logits under phase
    6's tolerance, and the 32 greedy tokens."""
    results["sc7_parity"] = long_parity(long, dev, "sc7-parity")


def _inputs(run) -> dict:
    """A serve run's prompt batch (tokens, and frames or patches)."""
    return run.inputs or {"tokens": run.prompt}


def long_parity(long, dev, tag: str, rel_max: float = 1e-2) -> dict:
    """A fused serve run (1 x ``LONG_SEQ``, or a frontend family's 4 x
    1024) against the simulated backend on the same parameters, prompt
    batch, cache length and positions: prefill logits under phase 6's
    tolerance (rel L2 <= ``rel_max``, 1e-2 by default, max |d| <= 0.1),
    and the greedy tokens (identical, or the first difference a
    near-tie)."""
    from repro_torch.models import model

    sim = long.policy.with_backend("simulated")
    run_s, counts, _ = _generate(long.params, model.init_quant_state(
        long.cfg, device=dev), _inputs(long), long.cfg, sim,
        gen=long.tokens.shape[1], cache_len=long.cache_len, pos0=long.pos0)
    if any(counts.values()):
        raise AssertionError("the simulated backend launched a kernel")
    a, b = long.prefill_logits, run_s.prefill_logits
    d_max = (a - b).abs().max().item()
    rel = ((a - b).norm() / b.norm()).item()
    shape = "x".join(map(str, long.prompt.shape))
    if not (rel <= rel_max and d_max <= 0.1 and math.isfinite(rel)):
        raise AssertionError(f"fused vs simulated at {shape}: rel L2 "
                             f"{rel:.3e}, max |d| {d_max:.3e}")
    tok = _tokens_agree(long, run_s, long.cfg, dev)
    log(tag, f"{shape} prefill logits fused vs simulated: rel L2 "
             f"{rel:.3e}, max |d| {d_max:.3e} (tolerance: rel L2 <= "
             f"{rel_max:.0e}, max |d| <= 0.1); {long.tokens.shape[1]} "
             f"greedy tokens: "
             + ("identical" if tok["identical"] else
                f"first differ at step {tok['first_diff']}, a near-tie "
                f"(top-2 margin {tok['margin']:.3e}, max |d| "
                f"{tok['max_abs']:.3e})")
             + f"; simulated prefill {run_s.prefill_ms:.1f} ms")
    return dict(rel_l2=rel, max_abs=d_max, tokens=tok,
                simulated_prefill_ms=run_s.prefill_ms)


def _hold_fp_path(spy, name: str, tag: str) -> dict:
    """Layer 0's fp path (``name``) against ``_dense_attn`` on the same
    q/k/v, in fp32.  Tolerance: 2e-5 absolute + 1e-4 relative (the paths'
    exp and products sum in other orders over up to 8192 keys)."""
    from repro_torch.models import attention

    if spy.calls[name] == 0:
        raise AssertionError(f"{name} never ran: {spy.calls}")
    q, k, v, kw = spy.first[name]
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    with torch.no_grad():
        got = spy.real[name](q, k, v, **kw)
        torch.cuda.synchronize()
        dense = attention._dense_attn(
            q, k, v, mode=kw.get("mode", "sliding"),
            window=kw.get("window"), prefix_len=kw.get("prefix_len"),
            kv_len=kw.get("kv_len"), scale=kw["scale"])
        torch.cuda.synchronize()
    err = (got - dense).abs().max().item()
    torch.testing.assert_close(got, dense, rtol=1e-4, atol=2e-5)
    log(tag, f"{name} on layer 0's q {tuple(q.shape)} vs _dense_attn: max "
             f"|d| {err:.3e} (tolerance 2e-5 + 1e-4 relative); calls "
             f"{spy.calls}")
    return dict(max_abs=err, calls=dict(spy.calls))


def sc7_fp_phase(long, dev, results) -> None:
    """Phase 22: starcoder2-7b (phase 20's cut) with the fp32 policy (``launch
    .serve --policy fp32``'s policy) at 1 x 8192 on phase 20's parameters:
    every layer's prefill attention through ``_local_attn``; layer 0's
    held against ``_dense_attn`` (a 9.7 GB score tile)."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import model

    fp = QuantPolicy.disabled()
    with _FpSpy() as spy:
        run, counts, peak = _generate(long.params, model.init_quant_state(
            long.cfg, device=dev), long.prompt, long.cfg, fp)
    out = _serve_record("sc7-fp", f"{long.cfg.name} fp32, _local_attn", run,
                        counts, peak, kernels=())
    if spy.calls["_local_attn"] != long.cfg.n_layers:
        raise AssertionError(f"_local_attn calls {spy.calls}")
    out["hold"] = _hold_fp_path(spy, "_local_attn", "sc7-fp")
    results["sc7_fp"] = out


def cmdr_phase(dev, records, results) -> None:
    """Phase 23: command-r-35b at full width (d 8192, 64/8 heads, SwiGLU,
    the tied 256000-wide vocabulary), depth cut to ``CMDR_LAYERS``
    (7.73 B parameters, 30.9 GB fp32): ``launch.serve.main --policy
    fp32`` at 1 x 8192, every layer's attention through ``_chunked_attn``
    (layer 0's held against ``_dense_attn``, a 17.2 GB score tile), then
    fused hindsight at 4 x 1024 on the same parameters, launch counters
    zeroed just before and read just after."""
    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model

    cut = _register_cut(configs.get(CMDR_ARCH), CMDR_LAYERS)
    argv = ["--arch", cut.name, "--policy", "fp32", "--batch", "1",
            "--prompt-len", str(LONG_SEQ), "--gen", str(GEN)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _FpSpy() as spy:
        run = serve.main(argv)
        torch.cuda.synchronize()
    out = {"fp32": _serve_record(
        "cmdr", f"{cut.name} fp32, _chunked_attn", run, ops.launch_counts(),
        torch.cuda.max_memory_allocated() / 2 ** 30, kernels=())}
    if spy.calls["_chunked_attn"] != cut.n_layers:
        raise AssertionError(f"_chunked_attn calls {spy.calls}")
    out["params_b"] = sum(p.numel() for p in run.params.parameters()) / 1e9
    params = run.params
    del run
    torch.cuda.empty_cache()
    out["hold"] = _hold_fp_path(spy, "_chunked_attn", "cmdr")
    del spy
    torch.cuda.empty_cache()
    fused, counts, peak = _generate(
        params, model.init_quant_state(cut, device=dev),
        _prompt(cut, BATCH, PROMPT, dev), cut,
        QuantPolicy.w8a8g8(backend="fused"), gen=GEN_RATE)
    out["fused"] = _serve_record("cmdr", f"{cut.name} fused", fused, counts,
                                 peak)
    for r in records:
        r["cmdr_serve_launches"] = counts[r["name"]]
    log("cmdr", f"{out['params_b']:.3f} B parameters (tied embeddings: no "
                f"head leaf)")
    results["cmdr"] = out


def nemotron_phase(dev, records, results) -> None:
    """Phase 24: nemotron-4-340b at full width (d 18432, 96/8 heads of hd
    192, d_ff 73728, squared ReLU, untied 256000-wide vocabulary), depth
    cut to 1 layer (12.89 B parameters, 51.6 GB fp32): ``launch.serve.main``
    fused hindsight at 1 x 1024 with a few decode steps, the launch
    counters zeroed just before and read just after; the attention kernel
    runs at hd 192 on a model path."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cut = _register_cut(configs.get(NEMO_ARCH), 1)
    argv = ["--arch", cut.name, "--batch", "1", "--prompt-len", str(PROMPT),
            "--gen", str(NEMO_GEN)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(argv)
    torch.cuda.synchronize()
    out = _serve_record("nemotron", f"{cut.name} hd={cut.head_dim} fused",
                        run, ops.launch_counts(),
                        torch.cuda.max_memory_allocated() / 2 ** 30)
    out["params_b"] = sum(p.numel() for p in run.params.parameters()) / 1e9
    out["card_gib"] = torch.cuda.get_device_properties(0).total_memory \
        / 2 ** 30
    log("nemotron", f"{out['params_b']:.3f} B parameters; peak "
                    f"{out['peak_gib']:.2f} of the card's "
                    f"{out['card_gib']:.2f} GiB")
    results["nemotron"] = out
    for r in records:
        r["nemotron_serve_launches"] = out["launches"][r["name"]]


def long_train_phase(dev, records, results) -> None:
    """Phase 25: ``launch.train.main`` on starcoder2-7b at full width, depth
    cut to ``LONG_TRAIN_LAYERS``, ``--policy current --backend simulated``
    (the paper's dynamic row; ``fused`` refuses it) at 1 x 8192: forward
    and backward through ``_local_attn``.  Then one step each under
    ``QuantPolicy.grad_only("hindsight")`` and ``act_only("hindsight")``
    through ``runtime.steps.make_train_step`` on the fused backend (the
    policies are static, so ``backend.validate`` admits it), each on a
    fresh state: the sites of the quantizers each policy turns off stay
    uninitialized."""
    from repro_torch import configs, data
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.state import INITED, tree_map_with_path
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import steps

    cut = _register_cut(configs.get(LONG_ARCH), LONG_TRAIN_LAYERS)
    argv = ["--arch", cut.name, "--policy", "current", "--backend",
            "simulated", "--seq", str(LONG_SEQ), "--batch", "1", "--steps",
            str(TRAIN_STEPS), "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _FpSpy() as spy:
        run = train.main(argv)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(counts.values()):
        raise AssertionError(f"the simulated train step launched a kernel: "
                             f"{counts}")
    if len(run.losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in run.losses):
        raise AssertionError(f"long train losses {run.losses}")
    # forward, and remat's recompute in the backward
    if spy.calls["_local_attn"] < 2 * cut.n_layers * TRAIN_STEPS:
        raise AssertionError(f"_local_attn calls {spy.calls}")
    steady = run.step_ms[1:]
    step_ms = sum(steady) / len(steady)
    log("long-train", f"{cut.name} current/simulated B=1 S={LONG_SEQ}, "
                      f"AdamW, remat: losses "
                      f"{[round(v, 4) for v in run.losses]}; step 0 "
                      f"{run.step_ms[0]:.1f} ms, steps 1-{TRAIN_STEPS - 1} "
                      f"{[round(v, 1) for v in steady]} ms, "
                      f"{LONG_SEQ / (step_ms / 1e3):.1f} tokens/s; peak "
                      f"{peak:.2f} GiB; fp path calls {spy.calls}")
    out = dict(losses=run.losses, step_ms=run.step_ms, steady_step_ms=step_ms,
               tokens_per_s=LONG_SEQ / (step_ms / 1e3), peak_gib=peak,
               fp_calls=dict(spy.calls))
    del run, spy
    torch.cuda.empty_cache()

    stream = data.for_arch(cut, seq_len=LONG_SEQ, global_batch=1, seed=0)
    batch = {k: v.to(dev) for k, v in stream.batch(0).items()}
    for ctor in ("grad_only", "act_only"):
        policy = getattr(QuantPolicy, ctor)("hindsight").with_backend(
            "fused")
        opt = adamw()
        state = steps.init_train_state(cut, opt, policy, seed=0, device=dev)
        step = steps.make_train_step(cut, policy, opt, constant(1e-4))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        flags = {}
        tree_map_with_path(lambda p, leaf: flags.__setitem__(
            "/".join(map(str, p)), float(leaf[INITED])), state["quant"])
        # (the core's p-site starts on [0, 1]; the k/v input sites are
        # never visited: q/k/v share one, on "q")
        act = {k: v for k, v in flags.items() if k.endswith("act")
               and not k.endswith(("core/p/act", "attn/k/act",
                                   "attn/v/act"))}
        grad = {k: v for k, v in flags.items() if k.endswith("grad")}
        off, on = (act, grad) if ctor == "grad_only" else (grad, act)
        if any(off.values()) or not all(on.values()):
            raise AssertionError(f"{ctor}: initialized flags off {off}, on "
                                 f"{on}")
        # grad_only: the gradient barriers; act_only: the activation sites
        # and the attention core on their static ranges
        need = (("stochastic_quantize",) if ctor == "grad_only"
                else ("fused_quantize", "int8_attention"))
        if not all(counts[k] > 0 for k in need):
            raise AssertionError(f"{ctor}: a kernel of the path never "
                                 f"launched: {counts}")
        loss = float(met["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"{ctor}: loss {loss}")
        log("long-train", f"{ctor}('hindsight') on fused, {cut.name} B=1 "
                          f"S={LONG_SEQ}: loss {loss:.4f}, step {ms:.1f} ms "
                          f"(first use), peak "
                          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
                          f" GiB; {len(off)} turned-off sites uninitialized, "
                          f"{len(on)} initialized; launches {counts}")
        out[ctor] = dict(loss=loss, step_ms=ms, launches=counts,
                         off_sites=len(off), on_sites=len(on))
        for r in records:
            r[f"{ctor}_launches"] = counts[r["name"]]
        del state, step, opt
        torch.cuda.empty_cache()
    results["long_train"] = out


# ---------------------------------------------------------------------------
# Phases 26-28: the hybrid family (recurrentgemma-9b).
# ---------------------------------------------------------------------------
class _ScanSpy:
    """Wraps ``rglru.rglru_scan`` in a ``record_function`` range (the
    profiler's scan share) and counts its calls; with ``keep``, the first
    call's operands are kept (layer 0 of a prefill)."""

    def __init__(self, keep: bool = False):
        from repro_torch.models import rglru
        self.mod, self.real, self.keep = rglru, rglru.rglru_scan, keep
        self.first = None
        self.calls = 0

    def __enter__(self):
        def wrapped(a, b, h0=None):
            self.calls += 1
            if self.keep and self.first is None:
                self.first = tuple(None if t is None else t.detach().clone()
                                   for t in (a, b, h0))
            with torch.profiler.record_function(SCAN_RANGE):
                return self.real(a, b, h0)
        self.mod.rglru_scan = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.rglru_scan = self.real


def _scan_share(prof: dict, ranges: dict, tag: str, what: str) -> float:
    share = ranges[SCAN_RANGE] / prof["busy_ms"]
    log(tag, f"{what}: rglru_scan {ranges[SCAN_RANGE]:.1f} ms of "
             f"{prof['busy_ms']:.1f} ms device time ({100 * share:.1f}%)")
    return share


def hyb_serve_phase(dev, records, results):
    """Phase 26: recurrentgemma-9b at full width, depth cut to
    ``HYB_SERVE_LAYERS`` of its 38 layers (six (rec, rec, local) units),
    fused hindsight:
    ``launch.serve.main`` at 4 x 1024 and ``serve.generate`` at 1 x 8192
    (four windows: the int8 core's sliding mask masks, each 2048-slot
    local ring wraps, the recurrent state carries through decode),
    ``GEN_RATE`` and 32 generated (phase 27 compares the long run's
    tokens), launch counters zeroed just before each and read just after; one prefill and one decode step of the long run profiled.
    Returns the long run and the first RG-LRU block's scan operands of its prefill
    (phase 27 uses both)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model

    from repro_torch import configs
    cut = _register_cut(configs.get(HYB_ARCH), HYB_SERVE_LAYERS)
    argv = ["--arch", cut.name, "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN_RATE)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(argv)
    torch.cuda.synchronize()
    cfg, policy = run.cfg, run.policy
    n_rec = sum(k == "rec" for k in (cfg.pattern * cfg.n_layers)
                [:cfg.n_layers])
    out = {"short": _serve_record(
        "hyb-serve", f"{cfg.name} {cfg.n_layers} layers fused", run,
        ops.launch_counts(), torch.cuda.max_memory_allocated() / 2 ** 30)}
    out["params_b"] = sum(p.numel() for p in run.params.parameters()) / 1e9
    params = run.params
    del run
    torch.cuda.empty_cache()
    prompt = _prompt(cfg, 1, LONG_SEQ, dev)
    quant = model.init_quant_state(cfg, device=dev)
    with _ScanSpy(keep=True) as spy:
        long, counts, peak = _generate(params, quant, prompt, cfg, policy)
    out["long"] = _serve_record("hyb-serve", f"{cfg.name} fused, four "
                                f"windows", long, counts, peak)
    # one scan per rec block in the prefill; decode's s == 1 branch has none
    if spy.calls != n_rec:
        raise AssertionError(f"rglru_scan ran {spy.calls} times in the "
                             f"prefill, expected {n_rec}")
    for r in records:
        r["hyb_serve_launches"] = counts[r["name"]]
    with _ScanSpy():       # (decode's s == 1 branch runs no scan)
        out["long"].update(serve_profiles(long, "hyb-long",
                                          prefill_ranges=(SCAN_RANGE,)))
    out["long"]["scan_share_prefill"] = _scan_share(
        out["long"]["profile_prefill"], out["long"]["ranges_prefill"],
        "hyb-long", "prefill")
    log("hyb-serve", f"{out['params_b']:.3f} B parameters; {n_rec} RG-LRU "
                     f"blocks, {cfg.n_layers - n_rec} local blocks on "
                     f"{cfg.local_window}-slot rings, {LONG_SEQ + GEN - 1} "
                     f"positions written")
    results["hyb_serve"] = out
    return long, spy.first


def hyb_parity_phase(scan_ops, dev, out: dict) -> None:
    """Phase 27, after (a) phase 26's 1 x 8192 fused run against the
    simulated backend on the same parameters (phase 21's check,
    ``long_parity``): (b) ``rglru_scan``
    against a sequential fp32 loop on the first RG-LRU block's operands
    of that prefill, ``[1, 8192, 4096]`` (the reference's
    ``test_rglru_scan_matches_loop`` at full width); (c) prefill-then-
    decode consistency at full width, depth cut to one unit, under
    ``QuantPolicy.disabled()``: decode past the local ring's wrap, each
    step's logits against a prefill of the extended prompt within the
    reference's rtol 2e-2, atol 2e-3, in fp32 compute.  (In bf16 compute
    the two paths round differently; at full width that moves logits
    past the tolerance the reference chose at its reduced width, in the
    reference as in the port, so the bf16 run is measured, not held.)"""
    from repro_torch import configs
    from repro_torch.models import model, rglru

    # (b) Tolerance: |h_scan - h_loop| <= 1e-5 max |h| + 1e-6 per element
    # (the tree and the loop round in other orders; each rounding decays
    # with a < 1).
    a, b, h0 = scan_ops
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = rglru.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        scan_ms = (time.perf_counter() - t0) * 1e3
        h = torch.zeros_like(b[:, 0]) if h0 is None else h0.clone()
        loop = torch.empty_like(b)
        for t in range(b.shape[1]):
            h = a[:, t] * h + b[:, t]
            loop[:, t] = h
        torch.cuda.synchronize()
    err = (hs - loop).abs().max().item()
    hmax = loop.abs().max().item()
    if not err <= 1e-5 * hmax + 1e-6:
        raise AssertionError(f"rglru_scan vs loop at {tuple(a.shape)}: max "
                             f"|d| {err:.3e}, max |h| {hmax:.3e}")
    log("hyb-parity", f"rglru_scan vs a sequential fp32 loop on layer 0's "
                      f"operands {tuple(a.shape)}: max |d| {err:.3e} "
                      f"(max |h| {hmax:.3e}; tolerance 1e-5 max |h| + "
                      f"1e-6); the scan {scan_ms:.2f} ms")
    out["scan_vs_loop"] = dict(shape=list(a.shape), max_abs=err,
                               max_h=hmax, scan_ms=scan_ms)
    del a, b, h0, hs, loop, scan_ops
    torch.cuda.empty_cache()

    # (c) one (rec, rec, local) unit at full width
    cut = _register_cut(configs.get(HYB_ARCH), HYB_CUT)
    params = model.init_params(cut, seed=0, device=dev)
    s = cut.local_window + 32
    out["decode_consistency"] = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cut, compute_dtype=dtype, cache_dtype=dtype)
        worst, outside = _decode_consistency(params, c, s, dev)
        held = dtype == "float32"
        if held and outside:
            raise AssertionError(f"decode vs prefill in {dtype}: max |d| "
                                 f"{worst:.3e}, {outside:.4f} of the logits "
                                 f"outside rtol 2e-2, atol 2e-3")
        log("hyb-parity", f"{cut.name} (full width, QuantPolicy.disabled()"
                          f", {dtype} compute): 4 decode steps after a "
                          f"{s}-token prefill (the {cut.local_window}-slot "
                          f"ring wrapped) against prefills of the extended "
                          f"prompt: max |d| {worst:.3e}, {outside:.4f} of "
                          f"the logits outside rtol 2e-2, atol 2e-3"
                          + (" (held)" if held else " (measured)"))
        out["decode_consistency"][dtype] = dict(
            prompt=s, steps=4, max_abs=worst, outside=outside)


def _decode_consistency(params, cfg, s: int, dev, steps: int = 4,
                        prompt=None):
    """Decode ``steps`` tokens after a prefill of ``s`` positions
    (``prompt``: a batch with frames or patches; default ``s`` tokens),
    each at its true position; after each, the logits against a prefill
    of the extended prompt.  Returns the largest |d| and the largest
    share of logits outside rtol 2e-2, atol 2e-3."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import model

    policy = QuantPolicy.disabled()
    quant = model.init_quant_state(cfg, device=dev)
    prompt = prompt or {"tokens": _prompt(cfg, 1, s, dev)}
    worst = outside = 0.0
    with torch.no_grad():
        logits, cache = model.prefill(params, quant, prompt, cfg, policy,
                                      cache_len=s + steps)
        for i in range(steps):
            tok = torch.argmax(logits, dim=-1)[:, None]
            logits, cache = model.decode_step(
                params, quant, tok, torch.full((1,), s + i, device=dev),
                cache, cfg, policy)
            prompt = dict(prompt, tokens=torch.cat([prompt["tokens"], tok],
                                                   dim=1))
            again, _ = model.prefill(params, quant, prompt, cfg, policy,
                                     cache_len=s + steps)
            d = (logits - again).abs()
            worst = max(worst, d.max().item())
            outside = max(outside, (d > 2e-3 + 2e-2 * again.abs()).float()
                          .mean().item())
    return worst, outside


def hyb_train_phase(dev, records, results) -> None:
    """Phase 28: ``launch.train.main`` on recurrentgemma-9b at full width,
    depth cut to ``HYB_CUT`` layers (one rec, rec, local unit, 1.70 B
    parameters; AdamW at 38 layers needs ~150 GB), fused hindsight W8A8G8
    at ``HYB_TRAIN_BATCH`` x ``HYB_TRAIN_SEQ`` (past the 2048 window),
    AdamW, ``TRAIN_STEPS`` steps, the launch counters zeroed just before
    and read just after; one more step profiled (families and idle share,
    then with host ranges: the scan's share)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    cut = _register_cut(configs.get(HYB_ARCH), HYB_CUT)
    bsz, seq = HYB_TRAIN_BATCH, HYB_TRAIN_SEQ
    argv = ["--arch", cut.name, "--batch", str(bsz), "--seq", str(seq),
            "--steps", str(TRAIN_STEPS), "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = train.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(counts[k] > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a kernel of the hybrid train path never "
                             f"launched: {counts}")
    if len(run.losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in run.losses):
        raise AssertionError(f"hybrid train losses {run.losses}")
    n_params = sum(p.numel() for p in run.state["params"].parameters())
    steady = run.step_ms[1:]
    step_ms = sum(steady) / len(steady)
    tok_s = bsz * seq / (step_ms / 1e3)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    log("hyb-train", f"{cut.name}: {cut.n_layers} layers d={cut.d_model}, "
                     f"{n_params / 1e9:.3f} B parameters, B={bsz} S={seq}, "
                     f"AdamW, remat: losses "
                     f"{[round(v, 4) for v in run.losses]}; step 0 "
                     f"{run.step_ms[0]:.1f} ms, steps 1-{TRAIN_STEPS - 1} "
                     f"{[round(v, 1) for v in steady]} ms, {tok_s:.1f} "
                     f"tokens/s; peak {peak:.2f} GiB; launches per step "
                     f"{per_step}")
    with _ScanSpy():
        prof = profile_step(run, "hyb-train-profile", batch=bsz, seq=seq)
        ranges = profile_step(run, "hyb-train-profile", ranges=(SCAN_RANGE,),
                              batch=bsz, seq=seq)["ranges"]
    out = dict(losses=run.losses, step_ms=run.step_ms, steady_step_ms=step_ms,
               tokens_per_s=tok_s, peak_gib=peak, launches=counts,
               launches_per_step=per_step, params_b=n_params / 1e9,
               profile=prof, ranges=ranges,
               scan_share=_scan_share(
                   prof, ranges, "hyb-train-profile",
                   "forward and remat recompute (its backward runs outside "
                   "the range)"))
    for r in records:
        r["hyb_train_launches_per_step"] = per_step[r["name"]]
    results["hyb_train"] = out


# ---------------------------------------------------------------------------
# Phases 29-31: the RWKV-6 family (rwkv6-7b).
# ---------------------------------------------------------------------------
class _WkvSpy:
    """Counts the calls of ``rwkv6.wkv_chunked``; with ``keep``, the first
    call's operands are kept (layer 0 of a prefill); with ``timed``, each
    call is bracketed by CUDA events (its span on the device's stream).
    (A ``record_function`` range around it read 3x the prefill's device
    time: the profiler attributes the decay tile's work to it several
    times over.)"""

    def __init__(self, keep: bool = False, timed: bool = False):
        from repro_torch.models import rwkv6
        self.mod, self.real = rwkv6, rwkv6.wkv_chunked
        self.keep, self.timed = keep, timed
        self.first = None
        self.calls = 0
        self.events = []

    def __enter__(self):
        def wrapped(r, k, v, logw, u, state, chunk=32):
            self.calls += 1
            if self.keep and self.first is None:
                self.first = tuple(t.detach().clone()
                                   for t in (r, k, v, logw, u, state))
            if not self.timed:
                return self.real(r, k, v, logw, u, state, chunk=chunk)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.real(r, k, v, logw, u, state, chunk=chunk)
            ev[1].record()
            self.events.append(ev)
            return out
        self.mod.wkv_chunked = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.wkv_chunked = self.real


def _wkv_share(run_once, tag: str, what: str) -> dict:
    """``run_once()`` with every ``wkv_chunked`` call bracketed by CUDA
    events: the calls' summed span against the whole run's (both on the
    device's stream, so host gaps inside either count to it)."""
    with _WkvSpy(timed=True) as spy:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        run_once()
        ev[1].record()
        torch.cuda.synchronize()
    wkv_ms = sum(s.elapsed_time(e) for s, e in spy.events)
    total_ms = ev[0].elapsed_time(ev[1])
    log(tag, f"{what}: wkv_chunked {wkv_ms:.1f} ms in {spy.calls} calls of "
             f"{total_ms:.1f} ms ({100 * wkv_ms / total_ms:.1f}%; CUDA "
             f"events)")
    return dict(wkv_ms=wkv_ms, total_ms=total_ms, calls=spy.calls,
                share=wkv_ms / total_ms)


def _rwkv_matmuls(cfg, counts, runs: int, what: str) -> None:
    """Eight int8 projections a layer (time mix r, k, v, g, o; channel mix
    k, v, r) in each of ``runs`` forwards: the int8 matmul's count."""
    want = 8 * cfg.n_layers * runs
    if counts["int8_matmul_fp"] != want:
        raise AssertionError(f"{what}: int8_matmul_fp launched "
                             f"{counts['int8_matmul_fp']} times, expected "
                             f"8 x {cfg.n_layers} x {runs} = {want}")


def rwkv_serve_phase(dev, records, results):
    """Phase 29: rwkv6-7b at full width, depth cut to
    ``RWKV_SERVE_LAYERS`` of its 32 layers, fused hindsight:
    ``launch.serve.main`` at 4 x 1024 and ``serve.generate`` at
    ``RWKV_LONG`` = 1 x 32768 (the reference's ``prefill_32k`` length, its
    batch cut to 1; the WKV state and the token-shift rows carry through
    decode), ``GEN_RATE`` generated each, launch counters zeroed just
    before each and read just after; one prefill and one decode step of
    the long run profiled (families, idle share, then the WKV's share).
    Returns the parameters and the policy (phase 30 reuses them)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model

    from repro_torch import configs
    cut = _register_cut(configs.get(RWKV_ARCH), RWKV_SERVE_LAYERS)
    argv = ["--arch", cut.name, "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN_RATE)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(argv)
    torch.cuda.synchronize()
    cfg, policy = run.cfg, run.policy
    counts = ops.launch_counts()
    _rwkv_matmuls(cfg, counts, GEN_RATE, "rwkv serve 4 x 1024")
    out = {"short": _serve_record(
        "rwkv-serve", f"{cfg.name} {cfg.n_layers} layers fused", run, counts,
        torch.cuda.max_memory_allocated() / 2 ** 30,
        kernels=RWKV_SERVE_KERNELS)}
    out["params_b"] = sum(p.numel() for p in run.params.parameters()) / 1e9
    params = run.params
    del run
    torch.cuda.empty_cache()
    prompt = _prompt(cfg, 1, RWKV_LONG, dev)
    quant = model.init_quant_state(cfg, device=dev)
    with _WkvSpy() as spy:
        long, counts, peak = _generate(params, quant, prompt, cfg, policy,
                                       gen=GEN_RATE)
    _rwkv_matmuls(cfg, counts, GEN_RATE, f"rwkv serve 1 x {RWKV_LONG}")
    out["long"] = _serve_record("rwkv-serve", f"{cfg.name} fused, 1 x "
                                f"{RWKV_LONG}", long, counts, peak,
                                kernels=RWKV_SERVE_KERNELS)
    # one chunked WKV per layer in the prefill; decode's s == 1 runs wkv_step
    if spy.calls != cfg.n_layers:
        raise AssertionError(f"wkv_chunked ran {spy.calls} times in the "
                             f"prefill, expected {cfg.n_layers}")
    for r in records:
        r["rwkv_serve_launches"] = counts[r["name"]]
    out["long"].update(serve_profiles(long, "rwkv-long"))

    def prefill_once():
        lg, _ = model.prefill(long.params, long.quant_state,
                              {"tokens": long.prompt}, cfg, policy)
        float(lg[0, 0])
    out["long"]["wkv_prefill"] = _wkv_share(prefill_once, "rwkv-long",
                                            f"1 x {RWKV_LONG} prefill")
    log("rwkv-serve", f"{out['params_b']:.3f} B parameters; {cfg.n_layers} "
                      f"WKV states of [{cfg.n_heads}, {cfg.head_dim}, "
                      f"{cfg.head_dim}] and two token-shift rows a layer, "
                      f"{RWKV_LONG + GEN_RATE - 1} positions")
    results["rwkv_serve"] = out
    del long
    return params, policy


def rwkv_parity_phase(params, policy, dev, out: dict) -> None:
    """Phase 30 on phase 29's parameters: (a) a fused 1 x ``LONG_SEQ``
    serve run against the simulated backend (prefill logits rel L2 <=
    1e-3, the 32 greedy tokens identical or a near-tie), its layer-0
    ``wkv_chunked`` operands kept; (b) ``wkv_chunked`` against
    ``wkv_step`` applied token by token on those operands ``[1, 64, 8192,
    64]``: max |d| <= 1e-4 max |y|; then, once phase 29's parameters are
    freed, (c) :func:`rwkv_decode_phase`."""
    from repro_torch import configs
    from repro_torch.models import model, rwkv6

    cfg = configs.get(f"{RWKV_ARCH}-{RWKV_SERVE_LAYERS}l")  # phase 29's
    prompt = _prompt(cfg, 1, LONG_SEQ, dev)
    with _WkvSpy(keep=True) as spy:
        long, counts, _ = _generate(params, model.init_quant_state(
            cfg, device=dev), prompt, cfg, policy)
    _rwkv_matmuls(cfg, counts, GEN, f"rwkv fused 1 x {LONG_SEQ}")
    out["fused_vs_simulated"] = long_parity(long, dev, "rwkv-parity",
                                            rel_max=1e-3)
    del long
    torch.cuda.empty_cache()

    # (b) the chunked WKV against the recurrence, token by token
    r, k, v, lw, u, s0 = spy.first
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, s = rwkv6.wkv_chunked(r, k, v, lw, u, s0, chunk=cfg.rwkv_chunk)
        torch.cuda.synchronize()
        chunked_ms = (time.perf_counter() - t0) * 1e3
        ys = torch.empty_like(y)
        st = s0
        for t in range(r.shape[2]):
            ys[:, :, t], st = rwkv6.wkv_step(r[:, :, t], k[:, :, t],
                                             v[:, :, t], lw[:, :, t], u, st)
        torch.cuda.synchronize()
    err = (y - ys).abs().max().item()
    ymax = ys.abs().max().item()
    serr = (s - st).abs().max().item()
    if not (err <= 1e-4 * ymax and math.isfinite(err)):
        raise AssertionError(f"wkv_chunked vs wkv_step at {tuple(r.shape)}: "
                             f"max |d| {err:.3e}, max |y| {ymax:.3e}")
    log("rwkv-parity", f"wkv_chunked vs wkv_step token by token on layer "
                       f"0's operands {tuple(r.shape)}: max |d| {err:.3e} "
                       f"(max |y| {ymax:.3e}; tolerance 1e-4 max |y|), "
                       f"final state max |d| {serr:.3e}; chunked "
                       f"{chunked_ms:.2f} ms")
    out["wkv_vs_step"] = dict(shape=list(r.shape), max_abs=err, max_y=ymax,
                              state_max_abs=serr, chunked_ms=chunked_ms)
    del spy, r, k, v, lw, u, s0, y, s, ys, st


class _Fp32Mixes:
    """``rwkv6._ddlerp`` with its mixes kept in fp32 (the module's
    ``torch.bfloat16`` read as float32).  A diagnostic: the model rounds
    the mixes to bf16 whatever the compute dtype, as the reference does,
    and that rounding turns the WKV's ulp-level chunked-vs-stepwise
    difference into bf16-sized differences in the next layer."""

    def __enter__(self):
        from repro_torch.models import rwkv6

        class _Torch:
            bfloat16 = torch.float32

            def __getattr__(self, name):
                return getattr(torch, name)
        self.mod = rwkv6
        rwkv6.torch = _Torch()
        return self

    def __exit__(self, *exc):
        self.mod.torch = torch


def rwkv_decode_phase(dev, out: dict) -> None:
    """Phase 30 (c): prefill-then-decode against a re-prefill at full
    width, depth cut to ``RWKV_CUT``, under ``QuantPolicy.disabled()``,
    after a prompt of 64 chunks and a ragged tail.  Held to the
    reference's rtol 2e-2, atol 2e-3 in fp32 compute with the mixes kept
    in fp32 (``_Fp32Mixes``); the model as written (bf16 mixes) in fp32
    and in bf16 compute is measured beside it: at full width its bf16
    mixes part the two paths by bf16-sized amounts, in the reference as
    in the port (``tests/test_torch_rwkv.py::
    test_bf16_mixes_set_the_fp32_decode_gap``)."""
    import contextlib

    from repro_torch import configs
    from repro_torch.models import model

    cut = _register_cut(configs.get(RWKV_ARCH), RWKV_CUT)
    params = model.init_params(cut, seed=0, device=dev)
    s = 64 * cut.rwkv_chunk + 5          # 64 chunks and a ragged tail
    out["decode_consistency"] = {}
    for dtype, mixes in (("float32", "float32"), ("float32", "bfloat16"),
                         ("bfloat16", "bfloat16")):
        c = dataclasses.replace(cut, compute_dtype=dtype, cache_dtype=dtype)
        with (_Fp32Mixes() if mixes == "float32"
              else contextlib.nullcontext()):
            worst, outside = _decode_consistency(params, c, s, dev)
        held = mixes == "float32"
        if held and outside:
            raise AssertionError(f"decode vs prefill in {dtype} with fp32 "
                                 f"mixes: max |d| {worst:.3e}, {outside:.4f} "
                                 f"of the logits outside rtol 2e-2, atol "
                                 f"2e-3")
        what = f"{dtype} compute, {mixes} mixes"
        log("rwkv-parity", f"{cut.name} (full width, QuantPolicy.disabled()"
                           f", {what}): 4 decode steps after a {s}-token "
                           f"prefill against prefills of the extended "
                           f"prompt: max |d| {worst:.3e}, {outside:.4f} of "
                           f"the logits outside rtol 2e-2, atol 2e-3"
                           + (" (held)" if held else " (measured)"))
        out["decode_consistency"][what] = dict(
            prompt=s, steps=4, max_abs=worst, outside=outside)


def rwkv_train_phase(dev, records, results) -> None:
    """Phase 31: ``launch.train.main`` on rwkv6-7b at full width, depth cut
    to ``RWKV_TRAIN_LAYERS`` (1.417 B parameters; AdamW at 32 layers needs
    ~121 GB), fused hindsight W8A8G8 at ``RWKV_TRAIN_BATCH`` x
    ``RWKV_TRAIN_SEQ``, AdamW, ``TRAIN_STEPS`` steps, the launch counters
    zeroed just before and read just after; one more step profiled
    (families and idle share, then with host ranges: the WKV's share of
    the forward and remat recompute); phase 8's fused-vs-simulated
    forward and backward at 1 layer."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    cut = _register_cut(configs.get(RWKV_ARCH), RWKV_TRAIN_LAYERS)
    bsz, seq = RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ
    argv = ["--arch", cut.name, "--batch", str(bsz), "--seq", str(seq),
            "--steps", str(TRAIN_STEPS), "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = train.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(counts[k] > 0 for k in RWKV_TRAIN_KERNELS):
        raise AssertionError(f"a kernel of the rwkv train path never "
                             f"launched: {counts}")
    if len(run.losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in run.losses):
        raise AssertionError(f"rwkv train losses {run.losses}")
    n_params = sum(p.numel() for p in run.state["params"].parameters())
    steady = run.step_ms[1:]
    step_ms = sum(steady) / len(steady)
    tok_s = bsz * seq / (step_ms / 1e3)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    log("rwkv-train", f"{cut.name}: {cut.n_layers} layers d={cut.d_model}, "
                      f"{n_params / 1e9:.3f} B parameters, B={bsz} S={seq}, "
                      f"AdamW, remat: losses "
                      f"{[round(v, 4) for v in run.losses]}; step 0 "
                      f"{run.step_ms[0]:.1f} ms, steps 1-{TRAIN_STEPS - 1} "
                      f"{[round(v, 1) for v in steady]} ms, {tok_s:.1f} "
                      f"tokens/s; peak {peak:.2f} GiB; launches per step "
                      f"{per_step}")
    prof = profile_step(run, "rwkv-train-profile", batch=bsz, seq=seq)
    out = dict(losses=run.losses, step_ms=run.step_ms, steady_step_ms=step_ms,
               tokens_per_s=tok_s, peak_gib=peak, launches=counts,
               launches_per_step=per_step, params_b=n_params / 1e9,
               profile=prof,
               wkv=_wkv_share(
                   lambda: profile_step(run, "rwkv-train-profile", batch=bsz,
                                        seq=seq, profiled=False),
                   "rwkv-train-profile",
                   "one step: the forward and remat recompute (the WKV's "
                   "backward runs outside its calls)"))
    for r in records:
        r["rwkv_train_launches_per_step"] = per_step[r["name"]]
    del run
    torch.cuda.empty_cache()
    out["parity"] = train_parity_phase(
        dataclasses.replace(cut, n_layers=RWKV_PARITY_LAYERS), dev,
        tag="rwkv-train-parity", kernels=RWKV_TRAIN_KERNELS)
    results["rwkv_train"] = out


# ---------------------------------------------------------------------------
# Phases 32-37: the enc-dec and VLM families.
# ---------------------------------------------------------------------------
def _attention_launches(counts, want: int, what: str) -> None:
    """The int8 attention core's launches in one serve run: one per
    attention layer of the prefill (decode's s == 1 paths run none)."""
    if counts["int8_attention"] != want:
        raise AssertionError(f"{what}: int8_attention launched "
                             f"{counts['int8_attention']} times, expected "
                             f"{want}")


def _family_share(prof: dict, family: str, tag: str, what: str) -> float:
    ms = prof["families"].get(family, (0.0, 0))[0]
    share = ms / prof["busy_ms"]
    log(tag, f"{what}: {family} {ms:.1f} ms of {prof['busy_ms']:.1f} ms "
             f"device time ({100 * share:.1f}%)")
    return share


def encdec_serve_phase(dev, records, results):
    """Phase 32: seamless-m4t-medium at full width and depth (12 encoder +
    12 decoder layers, 0.878 B parameters; cut: none), fused hindsight:
    ``launch.serve.main`` at 4 x 1024 with ``GEN`` generated (the
    driver's 1056 frames: the encoder runs the int8 core bidir at (1056,
    1056), the cross core at (1024, 1056), a half-padded last kv tile),
    then ``serve.generate`` at 1 x ``ENC_LONG`` frames with a 1-token
    decoder prompt and ``cache_len`` ``ENC_LONG`` (the reference's
    ``prefill_32k`` input, batch cut to 1: the encoder bidir at 32768 on
    the kernel, the decoder's cross attention at s = 1 through
    ``_chunked_attn``), ``GEN_RATE`` generated, the launch counters
    zeroed just before and read just after each; the 32768 prefill and
    one decode step profiled.  Returns the 4 x 1024 run (phase 33's)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model

    argv = ["--arch", ENC_ARCH, "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(argv)
    torch.cuda.synchronize()
    cfg, policy = run.cfg, run.policy
    counts = ops.launch_counts()
    # per prefill: the encoder's bidir, the decoder's causal and cross cores
    _attention_launches(counts, cfg.enc_layers + 2 * cfg.n_layers,
                        "encdec serve 4 x 1024")
    frames = run.inputs["frames"].shape[1]
    out = {"short": _serve_record(
        "encdec-serve", f"{cfg.name} {cfg.enc_layers} + {cfg.n_layers} "
        f"layers fused, {frames} frames", run, counts,
        torch.cuda.max_memory_allocated() / 2 ** 30)}
    out["params_b"] = sum(p.numel() for p in run.params.parameters()) / 1e9
    for r in records:
        r["encdec_serve_launches"] = counts[r["name"]]
    prompt = _prompt_batch(cfg, 1, 1, dev, stream_len=ENC_LONG)
    quant = model.init_quant_state(cfg, device=dev)
    long, counts, peak = _generate(run.params, quant, prompt, cfg, policy,
                                   gen=GEN_RATE, cache_len=ENC_LONG)
    _attention_launches(counts, cfg.enc_layers,
                        f"encdec serve 1 x {ENC_LONG} frames")
    out["long"] = _serve_record(
        "encdec-serve", f"{cfg.name} fused, {ENC_LONG} frames, a 1-token "
        f"decoder prompt", long, counts, peak)
    xkv = cfg.enc_len(long.cache_len)
    out["long"].update(serve_profiles(long, "encdec-long"))
    out["long"]["attention_share_prefill"] = _family_share(
        out["long"]["profile_prefill"], "int8_attention (ours)",
        "encdec-long", f"1 x {ENC_LONG} prefill: the encoder's bidir core")
    log("encdec-serve", f"{out['params_b']:.3f} B parameters; the cross "
                        f"caches hold {xkv} encoder positions a layer")
    results["encdec_serve"] = out
    del long
    return run


def _frontend_decode(cfg, cut_kw: dict, s: int, dev, tag: str,
                     prompt) -> dict:
    """Prefill-then-decode against a re-prefill at full width, depth cut
    (``cut_kw``), under ``QuantPolicy.disabled()``, ``prompt`` prefilling
    ``s`` positions: held to the reference's rtol 2e-2, atol 2e-3 in fp32
    compute; the bf16 run measured beside it."""
    from repro_torch.models import model

    cut = dataclasses.replace(cfg, name=f"{cfg.name}-cut", **cut_kw)
    params = model.init_params(cut, seed=0, device=dev)
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cut, compute_dtype=dtype, cache_dtype=dtype)
        worst, outside = _decode_consistency(params, c, s, dev,
                                             prompt=dict(prompt))
        held = dtype == "float32"
        if held and outside:
            raise AssertionError(f"{tag}: decode vs prefill in fp32: max "
                                 f"|d| {worst:.3e}, {outside:.4f} of the "
                                 f"logits outside rtol 2e-2, atol 2e-3")
        log(tag, f"{cfg.name} at {cut_kw} (full width, "
                 f"QuantPolicy.disabled(), {dtype} compute): 4 decode steps "
                 f"after a prefill of {s} positions against prefills of the "
                 f"extended prompt: max |d| {worst:.3e}, {outside:.4f} of "
                 f"the logits outside rtol 2e-2, atol 2e-3"
                 + (" (held)" if held else " (measured)"))
        out[dtype] = dict(positions=s, steps=4, max_abs=worst,
                          outside=outside)
    del params
    torch.cuda.empty_cache()
    return out


def encdec_parity_phase(run, dev, results) -> None:
    """Phase 33: (a) phase 32's 4 x 1024 fused run against the simulated
    backend on the same parameters, prompt batch and cache (prefill
    logits rel L2 <= 1e-3, max |d| <= 0.1; the 32 greedy tokens identical
    or the first difference a near-tie); (b) prefill-then-decode at 3 + 3
    layers after 1024 tokens and 1024 frames."""
    from repro_torch import configs

    out = {"fused_vs_simulated": long_parity(run, dev, "encdec-parity",
                                             rel_max=1e-3)}
    cfg = configs.get(ENC_ARCH)
    prompt = _prompt_batch(cfg, 1, PROMPT, dev, stream_len=PROMPT)
    out["decode_consistency"] = _frontend_decode(
        cfg, dict(n_layers=ENC_CUT, enc_layers=ENC_CUT), PROMPT, dev,
        "encdec-parity", prompt)
    results["encdec_parity"] = out


def _family_train(cut, bsz: int, seq: int, tag: str, parity_cfg,
                  dev) -> dict:
    """``launch.train.main`` on ``cut`` (a registered config) at ``bsz`` x
    ``seq``,
    fused hindsight W8A8G8, AdamW, ``TRAIN_STEPS`` steps, the launch
    counters zeroed just before and read just after; one more step
    profiled; phase 8's fused vs simulated forward and backward on
    ``parity_cfg``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    argv = ["--arch", cut.name, "--batch", str(bsz), "--seq", str(seq),
            "--steps", str(TRAIN_STEPS), "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = train.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(counts[k] > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"{tag}: a kernel of the train path never "
                             f"launched: {counts}")
    if len(run.losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in run.losses):
        raise AssertionError(f"{tag}: losses {run.losses}")
    n_params = sum(p.numel() for p in run.state["params"].parameters())
    steady = run.step_ms[1:]
    step_ms = sum(steady) / len(steady)
    tok_s = bsz * seq / (step_ms / 1e3)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    depth = f"{cut.enc_layers} + {cut.n_layers}" \
        if cut.family == "encdec" else f"{cut.n_layers}"
    log(tag, f"{cut.name}: {depth} layers "
             f"d={cut.d_model}, {n_params / 1e9:.3f} B parameters, B={bsz} "
             f"S={seq}, AdamW, remat: losses "
             f"{[round(v, 4) for v in run.losses]}; step 0 "
             f"{run.step_ms[0]:.1f} ms, steps 1-{TRAIN_STEPS - 1} "
             f"{[round(v, 1) for v in steady]} ms, {tok_s:.1f} tokens/s "
             f"(frontend rows included); peak {peak:.2f} GiB; launches per "
             f"step {per_step}")
    out = dict(losses=run.losses, step_ms=run.step_ms, steady_step_ms=step_ms,
               tokens_per_s=tok_s, peak_gib=peak, launches=counts,
               launches_per_step=per_step, params_b=n_params / 1e9,
               profile=profile_step(run, f"{tag}-profile", batch=bsz,
                                    seq=seq))
    del run
    torch.cuda.empty_cache()
    out["parity"] = train_parity_phase(parity_cfg, dev, tag=f"{tag}-parity")
    return out


def encdec_train_phase(dev, records, results) -> None:
    """Phase 34: the train step on seamless-m4t-medium at full width and
    depth (0.878 B parameters; cut: none), ``ENC_TRAIN_BATCH`` x
    ``ENC_TRAIN_SEQ`` (as many frames as tokens; the head's chunked
    int8 product at N = 256206); parity at 1 + 1 layers."""
    from repro_torch import configs

    cfg = configs.get(ENC_ARCH)
    out = _family_train(cfg, ENC_TRAIN_BATCH, ENC_TRAIN_SEQ, "encdec-train",
                        dataclasses.replace(cfg, n_layers=1, enc_layers=1),
                        dev)
    for r in records:
        r["encdec_train_launches_per_step"] = \
            out["launches_per_step"][r["name"]]
    results["encdec_train"] = out


def vlm_serve_phase(dev, records, results):
    """Phase 35: paligemma-3b at full width and depth (18 layers, 2.511 B
    parameters; cut: none), fused hindsight: ``launch.serve.main`` at 4 x
    1024 with ``GEN`` generated, as the reference's driver serves it:
    256 patches and ``PROMPT + GEN - 256`` = 800 text tokens prefilled
    (the prefix core on the wide kernel, hd 256, G = 8), decode from
    position ``PROMPT + 256`` = 1280 (the reference's position gap),
    launch counters zeroed just before and read just after; one prefill
    and one decode step profiled.  Returns the run (phase 36's)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    argv = ["--arch", VLM_ARCH, "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(argv)
    torch.cuda.synchronize()
    cfg = run.cfg
    counts = ops.launch_counts()
    _attention_launches(counts, cfg.n_layers, "vlm serve 4 x 1024")
    text = run.prompt.shape[1]
    if run.pos0 != PROMPT + cfg.n_patches or text + cfg.n_patches != \
            PROMPT + GEN:
        raise AssertionError(f"vlm serve: {text} text tokens, decode from "
                             f"{run.pos0}")
    out = {"short": _serve_record(
        "vlm-serve", f"{cfg.name} {cfg.n_layers} layers fused, "
        f"{cfg.n_patches} patches", run, counts,
        torch.cuda.max_memory_allocated() / 2 ** 30)}
    out["params_b"] = sum(p.numel() for p in run.params.parameters()) / 1e9
    out["short"].update(serve_profiles(run, "vlm"))
    for r in records:
        r["vlm_serve_launches"] = counts[r["name"]]
    log("vlm-serve", f"{out['params_b']:.3f} B parameters; prefill of "
                     f"{cfg.n_patches} patches + {text} text tokens, decode "
                     f"from position {run.pos0} (positions "
                     f"{cfg.n_patches + text}-{run.pos0 - 1} never filled, "
                     f"as in the reference's driver)")
    results["vlm_serve"] = out
    return run


def vlm_parity_phase(run, dev, results) -> None:
    """Phase 36: (a) phase 35's fused run against the simulated backend
    on the same parameters, prompt batch, cache and positions (prefill
    logits rel L2 <= 1e-3, the 32 greedy tokens); (b) prefill-then-decode
    at 3 layers after 256 patches and 768 text tokens, decode at the true
    positions from 1024."""
    from repro_torch import configs

    out = {"fused_vs_simulated": long_parity(run, dev, "vlm-parity",
                                             rel_max=1e-3)}
    cfg = configs.get(VLM_ARCH)
    prompt = _prompt_batch(cfg, 1, PROMPT - cfg.n_patches, dev,
                           stream_len=PROMPT)
    out["decode_consistency"] = _frontend_decode(
        cfg, dict(n_layers=VLM_CUT), PROMPT, dev, "vlm-parity", prompt)
    results["vlm_parity"] = out


def vlm_train_phase(dev, records, results) -> None:
    """Phase 37: the train step on paligemma-3b at full width, depth
    ``VLM_TRAIN_LAYERS``, ``VLM_TRAIN_BATCH`` x ``VLM_TRAIN_SEQ`` (256
    patches and the text; the loss over the text); parity at 1 layer."""
    from repro_torch import configs

    cfg = configs.get(VLM_ARCH)
    cut = _register_cut(cfg, VLM_TRAIN_LAYERS)
    out = _family_train(cut, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, "vlm-train",
                        dataclasses.replace(cfg, n_layers=1), dev)
    for r in records:
        r["vlm_train_launches_per_step"] = \
            out["launches_per_step"][r["name"]]
    results["vlm_train"] = out


# ---------------------------------------------------------------------------
# Phases 4-6: the serving path.
# ---------------------------------------------------------------------------
def serve_phases(cfg, dev, records, results, run_phase, clock) -> None:
    """Phase 4, serve, and the phases that reuse its run: 5 (the static
    path) and 6 (prefill parity); ``clock`` times each."""
    from repro_torch.core.state import tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    # 4. serve, full width, fused backend
    clock.start(4, "serve")
    argv_serve = ["--arch", "starcoder2-3b", "--batch", str(BATCH),
                  "--prompt-len", str(PROMPT), "--gen", str(GEN_RATE)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(argv_serve)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(counts[k] > 0 for k in SERVE_KERNELS):
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    if not torch.isfinite(run.prefill_logits).all():
        raise AssertionError("non-finite prefill logits")
    log("serve", f"{cfg.n_layers} layers d={cfg.d_model} B={BATCH} "
                 f"S={PROMPT} gen={GEN_RATE}: prefill {run.prefill_ms:.1f} ms, "
                 f"decode {run.decode_tok_s:.1f} tok/s "
                 f"({run.decode_ms:.1f} ms for {GEN_RATE - 1} steps), peak "
                 f"{peak:.2f} GiB, launches {counts}")
    results["serve"] = dict(prefill_ms=run.prefill_ms,
                            decode_ms=run.decode_ms,
                            decode_tok_s=run.decode_tok_s, peak_gib=peak,
                            launches=counts)
    for r in records:
        r["serve_launches"] = counts[r["name"]]
    _note_tiles(results, "serve")
    KEPT["serve"] = {"prompt": run.prompt.cpu(),
                     "logits": run.prefill_logits.cpu(),
                     "tokens": run.tokens.cpu(),
                     "stats": {"decoder": tree_map(
                         lambda t: t.cpu(), run.prefill_stats["decoder"])}}

    policy = run.policy
    clock.stop()
    if run_phase(5):
        with clock(5, "static path"):
            static_phase(run, policy, results)
    if run_phase(6):
        with clock(6, "parity"):
            parity_phase(run, policy, dev, results)
    del run
    torch.cuda.empty_cache()


def static_phase(run, policy, results) -> None:
    """Phase 5: one prefill's statistics folded into the quant state, then
    served again on the single-pass hindsight branch."""
    from repro_torch.core import qlinear
    from repro_torch.core.state import tree_map_with_path
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    full = {"decoder": run.prefill_stats["decoder"],
            "head": qlinear.zero_stats_like(run.quant_state["head"])}
    quant = qlinear.update_quant_state(policy, run.quant_state, full)
    visited = []
    tree_map_with_path(lambda p, leaf, st: visited.append(
        (float(leaf[2]), float(st[2]))), quant, full)
    if not all(inited == 1.0 for inited, seen in visited if seen == 1.0):
        raise AssertionError("a visited site did not initialize")
    ops.reset_launch_counts()
    run2 = serve.generate(run.params, quant, run.prompt, run.cfg, policy, 8)
    torch.cuda.synchronize()
    counts2 = ops.launch_counts()
    if not all(counts2[k] > 0 for k in SERVE_KERNELS):
        raise AssertionError(f"static path skipped a kernel: {counts2}")
    if not torch.isfinite(run2.prefill_logits).all():
        raise AssertionError("non-finite logits on the static path")
    n_init = sum(1 for inited, _ in visited if inited == 1.0)
    log("static", f"{n_init} leaves initialized; prefill "
                  f"{run2.prefill_ms:.1f} ms, decode {run2.decode_tok_s:.1f} "
                  f"tok/s, launches {counts2}")
    results["static"] = dict(prefill_ms=run2.prefill_ms,
                             decode_tok_s=run2.decode_tok_s,
                             launches=counts2)


def parity_phase(run, policy, dev, results) -> None:
    """Phase 6: fused vs simulated prefill logits, same params and prompt."""
    from repro_torch.kernels import ops
    from repro_torch.models import model

    sim = policy.with_backend("simulated")
    ops.reset_launch_counts()
    logits_sim, _ = model.prefill(run.params,
                                  model.init_quant_state(run.cfg, device=dev),
                                  {"tokens": run.prompt}, run.cfg, sim)
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        raise AssertionError("the simulated backend launched a kernel")
    a, b = run.prefill_logits, logits_sim
    d_max = (a - b).abs().max().item()
    rel = ((a - b).norm() / b.norm()).item()
    same = (a == b).float().mean().item()
    # Tolerance: both backends share every fp op outside the kernels; the
    # attention kernel's expf may differ from torch.exp by an ulp, which
    # can flip one requantized probability level and propagate.
    if not (rel <= 1e-2 and d_max <= 0.1 and math.isfinite(rel)):
        raise AssertionError(f"fused vs simulated: rel L2 {rel:.3e}, "
                             f"max |d| {d_max:.3e}")
    log("parity", f"prefill logits fused vs simulated: rel L2 {rel:.3e}, "
                  f"max |d| {d_max:.3e}, {same:.6f} identical (tolerance: "
                  f"rel L2 <= 1e-2, max |d| <= 0.1)")
    results["parity"] = dict(rel_l2=rel, max_abs=d_max, identical=same)


# ---------------------------------------------------------------------------
class Beside:
    """``fn(*args)`` in a thread beside the main process's phases, for a
    spawn: the thread only waits on its ranks, while the main process
    runs phases whose card memory fits beside theirs.  :meth:`join`
    returns its value or raises its error, and logs the wall seconds of
    the span against the thread's."""

    def __init__(self, what: str, fn, *args):
        import threading
        self.what, self.value, self.error = what, None, None
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, args=(fn, args),
                                       daemon=True)
        self.thread.start()

    def _run(self, fn, args) -> None:
        try:
            self.value = fn(*args)
        except BaseException as e:      # raised again by join
            self.error = e
        self.seconds = time.perf_counter() - self.t0

    def join(self):
        main = time.perf_counter() - self.t0
        self.thread.join()
        if self.error is not None:
            raise self.error
        log("time", f"{self.what}: {time.perf_counter() - self.t0:.1f} s "
                    f"(the main process's phases {main:.1f} s, the "
                    f"spawns' {self.seconds:.1f} s)")
        return self.value


class PhaseClock:
    """Wall seconds of each phase, logged as it ends (``[time] phase N
    name: s``) and kept in ``seconds``; a phase timed in parts sums
    them."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds: dict = {}
        self.names: dict = {}
        self._open = None

    def start(self, n: int, name: str) -> None:
        self._open = (n, name, time.perf_counter())

    def stop(self) -> None:
        n, name, t0 = self._open
        self._open = None
        self.seconds[n] = self.seconds.get(n, 0.0) + time.perf_counter() - t0
        self.names[n] = name
        log("time", f"phase {n} {name}: {self.seconds[n]:.1f} s")

    def __call__(self, n: int, name: str):
        clock = self

        class _Span:
            def __enter__(self):
                clock.start(n, name)

            def __exit__(self, *exc):
                if exc[0] is None:
                    clock.stop()
        return _Span()

    def add(self, n: int, name: str, seconds: float) -> None:
        """A phase timed elsewhere (the share of a spawn it took)."""
        self.seconds[n] = self.seconds.get(n, 0.0) + seconds
        self.names[n] = name
        log("time", f"phase {n} {name}: {self.seconds[n]:.1f} s")

    def summary(self) -> dict:
        total = time.perf_counter() - self.t0
        log("time", "phases (s): " + "; ".join(
            f"{n} {self.names[n]} {sec:.1f}"
            for n, sec in sorted(self.seconds.items()))
            + f"; phases 1-31 {self.part(1, 31):.1f}, 32-37 "
            f"{self.part(32, 37):.1f}, 38-40 {self.part(38, 40):.1f}, 41 "
            f"{self.part(41, 41):.1f}, 42-44 {self.part(42, 44):.1f}, 45-50 "
            f"{self.part(45, 50):.1f}; the whole run {total:.1f} s")
        return dict(seconds={str(n): sec for n, sec in self.seconds.items()},
                    total_s=total)

    def part(self, lo: int, hi: int) -> float:
        return sum(sec for n, sec in self.seconds.items() if lo <= n <= hi)


def tall_serve_phase(dev, records, results) -> None:
    """Phase 38: starcoder2-3b at full width and depth served on a 4 x 200
    prompt through ``launch.serve.main``: the tuner picks (256, 128), so
    every prefill attention launch runs q blocks of 200 rows on the
    kernel's tall instantiation (which raised before it existed); the
    launch counters zeroed just before and read just after (one attention
    launch a layer, decode none); then fused vs simulated on the same
    parameters (``long_parity``: prefill logits, the greedy tokens)."""
    from repro_torch import configs
    from repro_torch.kernels import ops, tuning
    from repro_torch.launch import serve

    cfg = configs.get("starcoder2-3b")
    if tuning.attention_block(TALL_SEQ, TALL_SEQ, cfg.head_dim) != (256, 128):
        raise AssertionError("the tuner does not pick (256, 128) at S = "
                             f"{TALL_SEQ}")
    argv = ["--arch", cfg.name, "--batch", str(BATCH), "--prompt-len",
            str(TALL_SEQ), "--gen", str(TALL_GEN)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    out = _serve_record("tall-serve", f"{cfg.name} {cfg.n_layers} layers "
                        f"fused, q blocks of {TALL_SEQ} rows", run, counts,
                        torch.cuda.max_memory_allocated() / 2 ** 30)
    if counts["int8_attention"] != cfg.n_layers:
        raise AssertionError(f"tall serve: {counts['int8_attention']} "
                             f"attention launches, not {cfg.n_layers}")
    for r in records:
        r["tall_serve_launches"] = counts[r["name"]]
    _note_tiles(results, "tall serve")
    out["parity"] = long_parity(run, dev, "tall-parity")
    results["tall_serve"] = out


def _layer_grad_shapes() -> dict:
    """One full-width starcoder2-3b decoder layer's parameter shapes (its
    gradients' shapes), by name."""
    from repro_torch import configs
    from repro_torch.models import model
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = dataclasses.replace(configs.get("starcoder2-3b"), n_layers=1)
    with FakeTensorMode():
        params = model.init_params(cfg, device="cpu")
        return {k: tuple(p.shape) for k, p in params.named_parameters()
                if k.startswith("decoder.")}


def _rank_grads(shapes: dict, rank: int, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1000 + rank)
    return {k: torch.randn(s, generator=gen, device=dev) * 1e-3
            for k, s in shapes.items()}


def _events_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _compress_rank(rank: int, world: int, backend: str, out: str,
                   group=None) -> None:
    """One rank of phase 39 (a spawned process; ``group``: the ranks of
    ``backend``, the default group without it)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import compress

    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    shapes = _layer_grad_shapes()
    grads = _rank_grads(shapes, rank, dev)
    every = [_rank_grads(shapes, r, dev) for r in range(world)]
    reduce_fn, update_fn, init_fn = compress.make_compressor(group)
    state = init_fn(grads)
    rec = {"leaves": len(grads), "elements": sum(g.numel()
                                                 for g in grads.values())}
    for call in range(2):       # the step-0 bootstrap, then hindsight
        ops.reset_launch_counts()
        got, st = reduce_fn(grads, state, call)
        torch.cuda.synchronize()
        n = ops.launch_counts()["stochastic_quantize"]
        if n != len(grads):
            raise AssertionError(f"{backend} rank {rank}: {n} "
                                 f"stochastic_quantize launches for "
                                 f"{len(grads)} leaves")
        want, wst = compress.emulate_all_reduce_tree(every, state, call)
        for k in want:
            if not (torch.equal(got[k], want[k])
                    and torch.equal(st[k], wst[k])):
                raise AssertionError(f"{backend} rank {rank} call {call} "
                                     f"{k}: differs from the emulation")
        state = update_fn(state, st)
        rec[f"launches_call{call}"] = n
    mean = {k: sum(g[k] for g in every) / world for k in grads}
    acc = {k: torch.zeros_like(g) for k, g in grads.items()}
    for s in range(COMP_SEEDS):
        got, _ = reduce_fn(grads, state, 2 + s)
        for k in acc:
            acc[k] += got[k] / COMP_SEEDS
    rec["bias"] = max(float((acc[k] - mean[k]).abs().max()
                            / mean[k].abs().max()) for k in acc)
    if rec["bias"] >= 0.05:
        raise AssertionError(f"{backend}: mean over {COMP_SEEDS} seeds "
                             f"{rec['bias']:.3e} off the fp32 mean")
    # the local halves apart: noise, quantize (the kernel), dequantize
    scales = {k: torch.clamp(torch.maximum(state[k][0].abs(),
                                           state[k][1].abs()) / 127.0,
                             min=1e-12) for k in grads}
    noise = {k: compress.leaf_noise(0, i, rank, g.shape, dev)
             for i, (k, g) in enumerate(grads.items())}
    images = {k: compress._quantize_leaf(g, scales[k], noise[k])[0]
              for k, g in grads.items()}
    rec["noise_ms"] = _events_ms(lambda: [compress.leaf_noise(
        0, i, rank, g.shape, dev) for i, (k, g) in enumerate(grads.items())])
    rec["quantize_ms"] = _events_ms(lambda: [compress._quantize_leaf(
        g, scales[k], noise[k]) for k, g in grads.items()])
    rec["dequantize_ms"] = _events_ms(lambda: [
        images[k].to(torch.int32).to(torch.float32) * scales[k] / world
        for k in grads])
    rec["call_ms"] = _events_ms(lambda: reduce_fn(grads, state, 0))
    rec["collective_ms"] = rec["call_ms"] - rec["noise_ms"] - \
        rec["quantize_ms"] - rec["dequantize_ms"]
    if rank == 0:
        Path(out).write_text(json.dumps(rec))


def _compress_runs(rank: int, world: int) -> None:
    """Phase 39 in phase 40's spawn of 2 gloo ranks: the compressor over
    the 2 gloo ranks, then over a 1-rank NCCL group of rank 0 (the other
    rank waits); rank 0 writes the part's seconds."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    _compress_rank(rank, world, "gloo", str(OUT_DIR / "compress_gloo.json"))
    torch.cuda.empty_cache()
    nccl = dist.new_group([0], backend="nccl")
    if rank == 0:
        _compress_rank(0, 1, "nccl", str(OUT_DIR / "compress_nccl.json"),
                       nccl)
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        (OUT_DIR / "compress_s.json").write_text(json.dumps(
            time.perf_counter() - t0))


def compress_phase(records, spawned: bool = False) -> dict:
    """Phase 39: the int8 in-hindsight gradient collective on the card
    (``spawned``: its ranks ran in phase 40's spawn)."""
    from repro_torch.launch import mesh

    out = {}
    for backend, world in (("gloo", 2), ("nccl", 1)):
        path = OUT_DIR / f"compress_{backend}.json"
        if not spawned:
            mesh.spawn_ranks(_compress_rank, world, OUT_DIR / "store",
                             backend=backend, args=(backend, str(path)))
        rec = json.loads(path.read_text())
        label = ("2 gloo ranks on one card (intra-card gloo: host copies "
                 "over loopback, not a link number)" if backend == "gloo"
                 else "a 1-rank NCCL group")
        log("compress", f"{label}: {rec['leaves']} leaves, "
                        f"{rec['elements'] / 1e6:.1f} M elements; both calls "
                        f"bit for bit the plain emulation; "
                        f"stochastic_quantize {rec['launches_call0']} + "
                        f"{rec['launches_call1']} launches; {COMP_SEEDS}-seed "
                        f"mean {rec['bias']:.3e} of the fp32 mean's largest "
                        f"element off it (< 5e-2); per tree: noise "
                        f"{rec['noise_ms']:.3f} ms, quantize "
                        f"{rec['quantize_ms']:.3f} ms, dequantize "
                        f"{rec['dequantize_ms']:.3f} ms, the whole call "
                        f"{rec['call_ms']:.3f} ms, so the collective "
                        f"{rec['collective_ms']:.3f} ms")
        out[backend] = rec
    for r in records:
        if r["name"] == "stochastic_quantize":
            r["compress_launches"] = out["gloo"]["launches_call0"]
    return out


def _grad_ratio(got: dict, want: dict) -> float:
    """The largest ``max |got - want|`` over ``2**-7`` of ``max |want|``
    over the gradient tensors: at most 1 passes.  Each rank's weight
    gradients are bf16 contractions over its rows before the fp32 sum
    (one bf16 rounding is 2**-8 of the largest element)."""
    worst = 0.0
    for k, w in want.items():
        bound = max(2.0 ** -7 * float(w.abs().max()), 1e-30)
        worst = max(worst, float((got[k] - w).abs().max()) / bound)
    return worst


def _dp_rank(rank: int, world: int, out: str, with_39: bool = False) -> None:
    """One rank of phase 40 (a spawned process): the DP step, rank 0's
    one-process step on the whole batch, warm steps of both, then the
    step with compress; first phase 39's runs where ``with_39``."""
    import torch.distributed as dist

    if with_39:
        _compress_runs(rank, world)

    from repro_torch import configs, data
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.state import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.optim import Optimizer, adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import compress, steps

    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get("starcoder2-3b"),
                              n_layers=DP_LAYERS)
    pol = QuantPolicy.w8a8g8(backend="fused")
    batch = {k: v.to(dev) for k, v in data.for_arch(
        cfg, seq_len=PROMPT, global_batch=BATCH, seed=0).batch(0).items()}
    group = dist.group.WORLD
    seen = {}

    def update(grads, state, params, lr):     # the gradients handed over
        seen["grads"] = {k: g.detach().clone() for k, g in grads.items()}
        return base.update(grads, state, params, lr)

    base = adamw()
    opt = Optimizer(init=base.init, update=update)

    def make(grp, hook=None):
        # clipping off: the optimizer is handed the reduced gradient
        st = steps.init_train_state(cfg, opt, pol, seed=0, device=dev)
        return st, steps.make_train_step(cfg, pol, opt, constant(DP_LR),
                                         clip_norm=None, compress=hook,
                                         group=grp)

    def run(ts, st):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, met = ts(st, batch)
        torch.cuda.synchronize()
        return st, float(met["loss"]), ops.launch_counts(), \
            (time.perf_counter() - t0) * 1e3

    st, ts = make(group)
    st, loss, counts, ms = run(ts, st)
    if not all(counts[k] > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"dp rank {rank}: a kernel of the path never "
                             f"launched: {counts}")
    rec = {"loss": loss, "launches": counts, "dp_step_ms": ms,
           "dp_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "dp_state_bytes": sum(t.numel() * t.element_size() for t in (
               *st["params"].parameters(), *st["opt"]["m"].values(),
               *st["opt"]["v"].values()))}
    zref = None
    if rank == 0:
        dp_grads = seen.pop("grads")
        one, ts1 = make(None)
        one, loss1, _, ms1 = run(ts1, one)
        one_grads = seen.pop("grads")
        rec.update(single_loss=loss1, single_step_ms=ms1)
        bad = [i for i, (a, b) in enumerate(zip(tree_leaves(st["quant"]),
                                                tree_leaves(one["quant"])))
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"dp: {len(bad)} quant leaves differ from "
                                 f"the one-process step")
        if abs(loss - loss1) > 1e-6 * abs(loss1):
            raise AssertionError(f"dp loss {loss} vs one process {loss1}")
        rec["grad_ratio"] = _grad_ratio(dp_grads, one_grads)
        if rec["grad_ratio"] > 1.0:
            raise AssertionError(f"dp gradients {rec['grad_ratio']:.3f} x "
                                 f"their bound off the one-process step's")
        # the check can fail: a step that averages instead of summing
        rec["grad_ratio_averaged"] = _grad_ratio(
            {k: g / world for k, g in dp_grads.items()}, one_grads)
        del dp_grads
        p1 = dict(one["params"].named_parameters())
        worst = max(float((p - p1[k]).abs().max())
                    for k, p in st["params"].named_parameters())
        if worst > 2 * DP_LR * 1.001:
            raise AssertionError(f"dp params {worst:.3e} off, above 2 lr")
        rec["param_max_abs"] = worst
        # the ZeRO-3 runs' reference, on the host (the spawn's last runs)
        zref = {"loss": loss1, "quant": one["quant"],
                "grads": {k: g.to("cpu", copy=True)
                          for k, g in one_grads.items()},
                "params": {k: p.detach().to("cpu", copy=True)
                           for k, p in p1.items()}}
        rec["quant_leaves"] = len(tree_leaves(st["quant"]))
        del p1
        rec["single_warm_ms"] = run(ts1, one)[3]
        del one
        seen.clear()
    torch.cuda.empty_cache()
    dist.barrier(group)
    rec["dp_warm_ms"] = run(ts, st)[3]
    del st
    seen.clear()
    torch.cuda.empty_cache()
    dist.barrier(group)

    class Recording(compress.Compressor):
        def __call__(self, grads, stats):     # what it was given, returned
            self.seen = {k: g.clone() for k, g in grads.items()}
            got = super().__call__(grads, stats)
            self.out = {k: g.clone() for k, g in got[0].items()}
            return got

    hook = Recording(group, seed=3)
    st, ts = make(group, hook)
    st, loss_c, counts_c, ms_c = run(ts, st)
    every = []
    for r in range(world):      # every rank's per-replica gradients
        t = {k: (g if r == rank else torch.empty_like(g))
             for k, g in hook.seen.items()}
        for g in t.values():
            dist.broadcast(g, src=r, group=group)
        every.append(t)
    want, _ = compress.emulate_all_reduce_tree(
        every, compress.init_compress_state(hook.seen), hook.seed)
    for k in want:
        if not torch.equal(hook.out[k], want[k]):
            raise AssertionError(f"dp compress rank {rank} {k}: differs "
                                 f"from the emulation")
    if rank == 0:
        # the check can fail: rank 0's own share, the all_reduce skipped
        rec["grad_ratio_unreduced"] = _grad_ratio(
            {k: g / world for k, g in hook.seen.items()}, one_grads)
        del one_grads
        for key in ("grad_ratio_averaged", "grad_ratio_unreduced"):
            if rec[key] <= 1.0:
                raise AssertionError(f"dp: the gradient check passes "
                                     f"{key[11:]} gradients "
                                     f"({rec[key]:.3f} x the bound)")
    del every, want, hook
    seen.clear()
    rec["compress_warm_ms"] = run(ts, st)[3]
    rec.update(compress_loss=loss_c, compress_launches=counts_c,
               compress_step_ms=ms_c)
    del st, ts
    torch.cuda.empty_cache()
    rec["zero3"] = _zero3_dp(rank, world, group, cfg, pol, batch, dev, zref)
    if rank == 0:
        Path(out).write_text(json.dumps(rec))


def _one_step(cfg, pol, batch, dev, clip, group=None, step=0) -> dict:
    """One AdamW step from seed 0 of the one-process program (with
    ``group``, of the data-parallel step on replicated parameters; as
    step ``step``, whose number keys the gradient sites' noise): its
    loss, quant state and, on the host, the gradients handed to the
    optimizer and the parameters after the step."""
    from repro_torch.optim import Optimizer, adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import steps

    seen, base = {}, adamw()

    def update(grads, state, params, lr):
        seen["grads"] = {k: g.detach().cpu() for k, g in grads.items()}
        return base.update(grads, state, params, lr)
    opt = Optimizer(init=base.init, update=update)
    st = steps.init_train_state(cfg, opt, pol, seed=0, device=dev)
    st["step"] = step
    st, met = steps.make_train_step(cfg, pol, opt, constant(DP_LR),
                                    clip_norm=clip, group=group)(st, batch)
    out = {"loss": float(met["loss"]), "quant": st["quant"],
           "grads": seen["grads"],
           "params": {k: p.detach().cpu()
                      for k, p in st["params"].named_parameters()}}
    del st
    torch.cuda.empty_cache()
    return out


def _zero3_step(g, cfg, pol, batch, dev, clip) -> tuple:
    """One AdamW step from seed 0 on a stored state (ZeRO-3:
    ``sharding.store_state`` on the mesh ``g``): this rank's record (its
    stored parameter and optimizer bytes beside the whole state's, the
    step's peak GiB, the gathers' and reduce-scatters' host-clock ms over
    gloo, the launches), its quant state, and on the host the gradients
    handed to the optimizer and the parameters after the step, joined
    whole over the mesh (``sharding.leaf_whole``)."""
    from repro_torch.kernels import ops
    from repro_torch.optim import Optimizer, adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import sharding, steps

    seen, base = {}, adamw()

    def update(grads, state, params, lr):
        seen["grads"] = {k: v.detach().clone() for k, v in grads.items()}
        return base.update(grads, state, params, lr)
    opt = Optimizer(init=base.init, update=update)
    st = sharding.store_state(steps.init_train_state(cfg, opt, pol, seed=0,
                                                     device=dev),
                              g.coords, g.sizes)
    torch.cuda.empty_cache()
    named = dict(st["params"].named_parameters())
    held = [*named.values(), *st["opt"]["m"].values(),
            *st["opt"]["v"].values()]
    rec = {"stored_bytes": sum(t.numel() * t.element_size() for t in held),
           "whole_bytes": sum(math.prod(sharding.stored_of(t).leaf)
                              * t.element_size() for t in held),
           "gather_ms": 0.0, "gathers": 0, "scatter_ms": 0.0, "scatters": 0}
    ts = steps.make_train_step(cfg, pol, opt, constant(DP_LR),
                               clip_norm=clip, group=g.data,
                               model_group=g.model)
    real = sharding.gather_stored, sharding.scatter_stored

    def timed(fn, key):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            rec[f"{key}_ms"] += (time.perf_counter() - t0) * 1e3
            rec[f"{key}s"] += 1
            return out
        return run
    sharding.gather_stored = timed(real[0], "gather")
    sharding.scatter_stored = timed(real[1], "scatter")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        st, met = ts(st, batch)
        torch.cuda.synchronize()
    finally:
        sharding.gather_stored, sharding.scatter_stored = real
    rec.update(step_ms=(time.perf_counter() - t0) * 1e3,
               loss=float(met["loss"]), launches=ops.launch_counts(),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    with torch.no_grad(), sharding.storage(g.data), \
            sharding.model_parallel(g.model):
        grads = {k: sharding.leaf_whole(sharding.tag_layout(
            v, sharding.stored_of(named[k]))).cpu()
            for k, v in seen.pop("grads").items()}
        params = {k: sharding.leaf_whole(p).cpu() for k, p in named.items()}
    quant = st["quant"]
    del st, named, held
    torch.cuda.empty_cache()
    return rec, quant, grads, params


def _zero3_against(rec: dict, quant, grads, params, ref: dict, what: str,
                   exact: bool) -> None:
    """A ZeRO-3 step against the one-process step ``ref``: the quant state
    bit for bit where ``exact`` (the data axis), else phase 44's bars;
    the loss within 1e-5 relative; the gradients within phase 40's bar
    (``_grad_ratio`` at most 1) and 2**-7 relative L2; the parameters
    after AdamW within 2 lr."""
    from repro_torch.core.state import tree_leaves
    if exact:
        bad = sum(not torch.equal(a, b) for a, b in zip(
            tree_leaves(quant), tree_leaves(ref["quant"])))
        if bad:
            raise AssertionError(f"{what}: {bad} quant leaves differ from "
                                 f"the one-process step's")
        rec["quant_leaves"] = len(tree_leaves(quant))
    else:
        rec.update(_quant_check(quant, ref["quant"], what))
    rec["single_loss"] = ref["loss"]
    rec["loss_rel"] = abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])
    rec["grad_ratio"] = _grad_ratio(grads, ref["grads"])
    rec["grad_rel_l2"] = _grad_rel_l2(grads, ref["grads"])[0]
    rec["param_max_abs"] = max(float((p - ref["params"][k]).abs().max())
                               for k, p in params.items())
    if rec["loss_rel"] > 1e-5:
        raise AssertionError(f"{what}: loss {rec['loss']} vs one process "
                             f"{ref['loss']}")
    if (exact and rec["grad_ratio"] > 1.0) or \
            rec["grad_rel_l2"][0] > 2 ** -7:
        raise AssertionError(f"{what}: gradients {rec['grad_ratio']:.3f} x "
                             f"phase 40's bound, {rec['grad_rel_l2']} rel L2 "
                             f"off the one-process step's")
    if rec["param_max_abs"] > 2 * DP_LR * 1.001:
        raise AssertionError(f"{what}: params {rec['param_max_abs']:.3e} "
                             f"off, above 2 lr")


def _total_rel_l2(got: dict, want: dict) -> float:
    """The relative L2 distance of the whole gradient, every tensor's
    elements together."""
    num = sum(float((got[k] - w).double().square().sum())
              for k, w in want.items())
    return math.sqrt(num / sum(float(w.double().square().sum())
                               for w in want.values()))


def _zero3_rounding(rec: dict, quant, grads, params, ref: dict,
                    other: dict) -> dict:
    """The distance of a data-parallel step (here ZeRO-3 with
    ``int8_weight_gather``, whose fp GEMMs round a rank's half batch
    otherwise than the whole) from the one-process step ``ref``.  A
    bf16 ulp off moves the 8-bit images of the elements at a rounding
    boundary by a whole level, so the gradients differ by quantization
    noise, not by rounding: the bar is ``other``, the one-process step
    under another noise draw (the gradient sites' stochastic rounding
    keyed by another step number).  Held: each quant leaf within 2**-7
    of its largest element (one bf16 ulp is 2**-8 to 2**-7 of a value),
    the whole gradient (every tensor's elements together) no farther
    from ``ref`` in relative L2 than ``other`` is, the AdamW parameters
    within 2 lr; by leaf ``_grad_ratio``, the worst relative L2 and the
    loss are reported.  The host's tensors are compared on the card."""
    from repro_torch.core.state import tree_map_with_path

    def card(d):
        return {k: t.to("cuda") for k, t in d.items()}
    grads, want, noise = card(grads), card(ref["grads"]), card(other["grads"])
    params, want_p = card(params), card(ref["params"])
    worst = {"act": 0.0, "grad": 0.0}
    n = {"leaves": 0, "differ": 0}

    def cmp(path, a, b):
        n["leaves"] += 1
        if torch.equal(a, b):
            return
        n["differ"] += 1
        kind = "grad" if "grad" in path else "act"
        d = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst[kind] = max(worst[kind], d)
    tree_map_with_path(cmp, quant, ref["quant"])
    out = {**n, "act_leaf_rel": worst["act"],
           "grad_leaf_rel": worst["grad"],
           "grad_ratio": _grad_ratio(grads, want),
           "grad_total_rel_l2": _total_rel_l2(grads, want),
           "noise_total_rel_l2": _total_rel_l2(noise, want),
           "noise_grad_ratio": _grad_ratio(noise, want),
           "grad_rel_l2": _grad_rel_l2(grads, want)[0],
           "param_max_abs": max(float((p - want_p[k]).abs().max())
                                for k, p in params.items()),
           "loss_rel": abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])}
    if max(worst.values()) > 2 ** -7 or \
            out["grad_total_rel_l2"] > out["noise_total_rel_l2"] or \
            out["param_max_abs"] > 2 * DP_LR * 1.001:
        raise AssertionError(f"zero3 on: off the one-process step by more "
                             f"than rounding: {out}")
    return out


def _zero3_save(g, cfg, pol, dev, rank) -> dict:
    """A fresh stored state saved from its shares
    (``checkpoint.save(..., groups=)``, the whole-leaf format), restored
    in one process on rank 0 into the one-process state's layout and held
    against that state leaf for leaf, bit for bit."""
    import torch.distributed as dist

    from repro_torch import checkpoint
    from repro_torch.core.state import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding, steps

    ck = OUT_DIR / "zero3_ckpt"
    if rank == 0:
        shutil.rmtree(ck, ignore_errors=True)
    dist.barrier(g.data)
    st = sharding.store_state(steps.init_train_state(cfg, adamw(), pol,
                                                     seed=0, device=dev),
                              g.coords, g.sizes)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checkpoint.save(str(ck), 0, st, groups=g)
    out = {"save_ms": (time.perf_counter() - t0) * 1e3}
    del st
    torch.cuda.empty_cache()
    if rank == 0:
        one = steps.init_train_state(cfg, adamw(), pol, seed=0, device=dev)
        t0 = time.perf_counter()
        back = checkpoint.restore(str(ck), 0, one)
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        pairs = list(zip(back["params"].parameters(),
                         one["params"].parameters()))
        pairs += [(back["opt"][m][k], t) for m in ("m", "v")
                  for k, t in one["opt"][m].items()]
        pairs += list(zip(tree_leaves(back["quant"]),
                          tree_leaves(one["quant"])))
        bad = sum(not torch.equal(a, b) for a, b in pairs)
        if bad or back["step"] != one["step"] or \
                back["opt"]["count"] != one["opt"]["count"]:
            raise AssertionError(f"zero3 save: {bad} of {len(pairs)} "
                                 f"leaves differ from the one-process "
                                 f"state")
        out["leaves"] = len(pairs)
        out["bytes"] = sum(f.stat().st_size for f in ck.rglob("*")
                           if f.is_file())
        del one, back, pairs
        shutil.rmtree(ck, ignore_errors=True)
        torch.cuda.empty_cache()
    dist.barrier(g.data)
    return out


def _zero3_dp(rank: int, world: int, group, cfg, pol, batch, dev,
              ref_off) -> dict:
    """Phase 40's ZeRO-3 runs (in its 2-rank spawn): a save from shares,
    then the stored state's step with ``int8_weight_gather`` off (the
    fused kernels), against the one-process step (``ref_off``, the
    spawn's own, on rank 0), and on.  The flag routes the products onto
    the fp path, whose GEMMs pick their algorithm by shape: a rank's
    half batch rounds otherwise than the whole batch in one process, so
    the flag's step is held against the data-parallel step on
    replicated parameters (the same shapes a rank), the layout ZeRO-3
    replaces; its distance from the one-process step with the flag is
    measured and held to a rounding bar (:func:`_zero3_rounding`)."""
    from repro_torch.launch import mesh

    g = mesh.MeshGroups(group, None, {"data": rank, "model": 0},
                        {"data": world, "model": 1})
    out = {"save": _zero3_save(g, cfg, pol, dev, rank)}
    for tag, p in (("off", pol),
                   ("on", dataclasses.replace(pol, int8_weight_gather=True))):
        ref = ref_off if tag == "off" else _one_step(cfg, p, batch, dev,
                                                     None, group)
        rec, quant, grads, params = _zero3_step(g, cfg, p, batch, dev, None)
        if rank == 0:
            _zero3_against(rec, quant, grads, params, ref, f"zero3 {tag}",
                           exact=True)
        del ref
        torch.cuda.empty_cache()
        if tag == "on" and rank == 0:
            rec["vs_one"] = _zero3_rounding(
                rec, quant, grads, params, _one_step(cfg, p, batch, dev, None),
                _one_step(cfg, p, batch, dev, None, step=1))
        del quant, grads, params
        torch.cuda.empty_cache()
        out[tag] = rec
    if not all(out["off"]["launches"][k] > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"zero3: a kernel of the path never launched: "
                             f"{out['off']['launches']}")
    return out


def _zero3_ep_rank(rank: int, world: int, out: str) -> None:
    """Phase 44's ZeRO-3 run (in its (2, 2) spawn): reduced
    qwen2-moe-a2.7b's stored state on (2, 2), expert parallelism on the
    model axis (the reference SPMD test's layout), one step against the
    one-process step on rank 0 with phase 44's bars."""
    import torch.distributed as dist

    from repro_torch import configs, data
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch import mesh

    dev = torch.device("cuda")
    g = mesh.mesh_groups(2, world // 2)
    cfg = configs.get_reduced(MOE_ARCH)
    pol = QuantPolicy.w8a8g8(backend="fused")
    batch = {k: v.to(dev) for k, v in data.for_arch(
        cfg, seq_len=32, global_batch=4, seed=0).batch(0).items()}
    rec, quant, grads, params = _zero3_step(g, cfg, pol, batch, dev, 1.0)
    rec["rank"] = rank
    if rank == 0:
        _zero3_against(rec, quant, grads, params,
                       _one_step(cfg, pol, batch, dev, 1.0), "zero3 ep",
                       exact=False)
    Path(f"{out}.r{rank}.json").write_text(json.dumps(rec))
    dist.barrier()


def _tp_reduced_rank(rank: int, world: int, *args) -> None:
    """One rank of phase 44's (2, 2) spawn: the model-axis step
    (:func:`_tp_train_rank`), then its ZeRO-3 counterpart
    (:func:`_zero3_ep_rank`)."""
    _tp_train_rank(rank, world, *args)
    _zero3_ep_rank(rank, world, f"{args[-1]}.zero3")


def _zero3_log(what: str, r: dict, dp_peak: float, dp_bytes: int) -> None:
    log("zero3", f"{what}: stored {r['stored_bytes'] / 2 ** 30:.3f} GiB of "
                 f"parameters and AdamW moments a rank ("
                 f"{r['stored_bytes'] / r['whole_bytes']:.3f} of the "
                 f"replicated rank's {dp_bytes / 2 ** 30:.3f} GiB); step peak "
                 f"{r['peak_gib']:.2f} GiB a rank (replicated DP "
                 f"{dp_peak:.2f} GiB); loss {r['loss']:.7f} vs "
                 f"{r['single_loss']:.7f}; gradients within "
                 f"{r['grad_ratio']:.4f} x phase 40's bound "
                 f"({r['grad_rel_l2'][0]:.3e} rel L2 at worst), AdamW params "
                 f"within {r['param_max_abs']:.3e} (<= 2 lr); step (host "
                 f"clock) {r['step_ms']:.1f} ms, of which {r['gathers']} "
                 f"gathers {r['gather_ms']:.1f} ms and {r['scatters']} "
                 f"reduce-scatters {r['scatter_ms']:.1f} ms (gloo, host "
                 f"copies); launches {r['launches']}")


def dp_spawn(with_39: bool = False) -> float:
    """Phase 40's ranks (first phase 39's runs where ``with_39``): one
    spawn of 2 gloo ranks on the card; returns its seconds."""
    from repro_torch.launch import mesh

    t0 = time.perf_counter()
    mesh.spawn_ranks(_dp_rank, 2, OUT_DIR / "store_dp", backend="gloo",
                     args=(str(OUT_DIR / "dp_train.json"), with_39))
    return time.perf_counter() - t0


def dp_train_phase(records) -> dict:
    """Phase 40's checks on its ranks' records (:func:`dp_spawn`): the
    data-parallel train step on 2 gloo ranks on the card against one
    process on the whole batch, then with compress, then ZeRO-3."""
    rec = json.loads((OUT_DIR / "dp_train.json").read_text())
    log("dp-train", f"starcoder2-3b full width, {DP_LAYERS} layers, "
                    f"{BATCH} x {PROMPT} over 2 gloo ranks on one card: quant "
                    f"state ({rec['quant_leaves']} leaves) bit for bit the "
                    f"one-process step's, loss {rec['loss']:.7f} vs "
                    f"{rec['single_loss']:.7f}; the reduced gradients "
                    f"within {rec['grad_ratio']:.4f} x the bound (2**-7 "
                    f"of each tensor's largest), while averaged ones are "
                    f"{rec['grad_ratio_averaged']:.1f} x and rank 0's "
                    f"unreduced share {rec['grad_ratio_unreduced']:.1f} x "
                    f"it; AdamW params within {rec['param_max_abs']:.3e} "
                    f"(<= 2 lr = {2 * DP_LR:.0e}); step (host clock) "
                    f"first {rec['dp_step_ms']:.1f} ms, warm "
                    f"{rec['dp_warm_ms']:.1f} ms (DP, rank 0) vs first "
                    f"{rec['single_step_ms']:.1f}, warm "
                    f"{rec['single_warm_ms']:.1f} ms (one process); "
                    f"launches {rec['launches']}; with compress: bit for "
                    f"bit its emulation, stochastic_quantize "
                    f"{rec['compress_launches']['stochastic_quantize']} "
                    f"launches, step first {rec['compress_step_ms']:.1f} "
                    f"ms, warm {rec['compress_warm_ms']:.1f} ms")
    z = rec["zero3"]
    log("zero3", f"save from the 2 ranks' shares: {z['save']['leaves']} "
                 f"leaves ({z['save']['bytes'] / 2 ** 30:.2f} GiB) restored "
                 f"in one process bit for bit the one-process state; save "
                 f"{z['save']['save_ms']:.0f} ms, restore "
                 f"{z['save']['restore_ms']:.0f} ms (host clock)")
    for tag, what in (("off", "int8_weight_gather off (the fused kernels; "
                              "against one process)"),
                      ("on", "int8_weight_gather on (the int8 image "
                             "gathered; against the replicated DP step)")):
        _zero3_log(f"starcoder2-3b full width, {DP_LAYERS} layers, {BATCH} "
                   f"x {PROMPT} on (2, 1), {what}; quant state "
                   f"({z[tag]['quant_leaves']} leaves) bit for bit",
                   z[tag], rec["dp_peak_gib"], rec["dp_state_bytes"])
        if tag == "on":
            v = z[tag]["vs_one"]
            log("zero3", f"int8_weight_gather on, against the one-process "
                         f"step with the flag: {v['differ']} of "
                         f"{v['leaves']} quant leaves differ, by at most "
                         f"{v['act_leaf_rel']:.3e} (activation sites) and "
                         f"{v['grad_leaf_rel']:.3e} (gradient sites) of "
                         f"the leaf's largest element (bar 2**-7); the "
                         f"whole gradient {v['grad_total_rel_l2']:.3e} rel "
                         f"L2 (bar: another noise draw of the one-process "
                         f"step, {v['noise_total_rel_l2']:.3e}), by leaf "
                         f"{v['grad_ratio']:.4f} x phase 40's bound "
                         f"(another draw {v['noise_grad_ratio']:.4f} x) "
                         f"and {v['grad_rel_l2'][0]:.3e} rel L2 at worst "
                         f"({v['grad_rel_l2'][1]}); AdamW params within "
                         f"{v['param_max_abs']:.3e} (<= 2 lr); loss "
                         f"{v['loss_rel']:.3e} relative")
        if z[tag]["peak_gib"] >= rec["dp_peak_gib"] or \
                z[tag]["stored_bytes"] >= rec["dp_state_bytes"]:
            raise AssertionError(f"zero3 {tag}: a rank holds no less than "
                                 f"the replicated DP rank")
    for r in records:
        r["dp_train_launches"] = rec["launches"][r["name"]]
        r["zero3_launches"] = z["off"]["launches"][r["name"]]
    return rec


# ---------------------------------------------------------------------------
# Phases 42-44: the attention kernel's general tiles and the model axis.
# ---------------------------------------------------------------------------
def check_offset_attention(dev, results) -> dict:
    """The attention kernel with a query offset at phase 47's shape: the
    last of 8 sequence-parallel ranks of starcoder2-3b at 4 x 1024, q
    ``[96, 128, 128]`` at ``q_start`` 896 against ``[8, 1024, 128]`` K/V
    under its sliding mask (window 4096: causal at 1024).  Held against
    the plain version's offset call (m and min/max/clip/n exact, out, l
    and err/sig within their tolerances) and bit for bit against the
    kernel's whole-sequence call's rows (out, m, l); timed beside its
    bound, its plain version and bf16 SDPA on the same rows and mask."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import int8_attention as attn
    from repro_torch.kernels import tuning

    cfg = configs.get(SEQ_ARCH)
    s, hd, nh, nkv = PROMPT, cfg.head_dim, cfg.n_heads, cfg.n_kv
    g, rows = nh // nkv, PROMPT // SEQ_SIZE
    q0 = s - rows
    bh, zb = BATCH * nh, BATCH * nkv
    bq, bkv = tuning.attention_block(s, s, hd)
    sched = attn.make_schedule(sq=s, skv=s, hd=hd, bq=bq, bkv=bkv, groups=g,
                               mode="sliding", window=cfg.sliding_window,
                               sm_scale=hd ** -0.5)
    gen = torch.Generator(device=dev).manual_seed(47)
    q = torch.randint(0, 256, (bh, s, hd), generator=gen, device=dev,
                      dtype=torch.uint8)
    k = torch.randint(-127, 128, (zb, s, hd), generator=gen, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (zb, s, hd), generator=gen, device=dev,
                      dtype=torch.int8)
    kvl = torch.tensor([s], device=dev, dtype=torch.int32)
    scale_p = 1.0 / 255.0
    regs = torch.tensor([128.0, 1e-5, scale_p, 0.0, scale_p * 0.02, 0.0, 1.0,
                         0.0], device=dev, dtype=torch.float32)
    qr = q[:, q0:].contiguous()
    ow, mlw, _ = attn.attention_cuda(q, k, v, regs, kvl, sched=sched)
    ok, mlk, psk = attn.attention_cuda(qr, k, v, regs, kvl, sched=sched,
                                       q_start=q0)
    orf, mlr, psr = attn.attention_core_reference(qr, k, v, regs, kvl,
                                                  sched=sched, q_start=q0)
    torch.cuda.synchronize()
    if not (torch.equal(ok, ow[:, q0:]) and torch.equal(mlk, mlw[:, q0:])):
        raise AssertionError("offset attention: the rows differ from the "
                             "kernel's whole-sequence call's")
    if not torch.equal(mlk[..., 0], mlr[..., 0]):
        raise AssertionError("offset attention: running max m differs")
    if not torch.equal(psk[..., :4], psr[..., :4]):
        raise AssertionError("offset attention: p-site min/max/clip/n "
                             "differ")
    err = (ok - orf).abs().max().item()
    torch.testing.assert_close(ok, orf, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mlk[..., 1], mlr[..., 1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(psk[..., 4:], psr[..., 4:], rtol=1e-4,
                               atol=1e-6)
    ms = time_ms(lambda: attn.attention_cuda(qr, k, v, regs, kvl,
                                             sched=sched, q_start=q0), 10)
    plain_ms = time_ms(lambda: attn.attention_core_reference(
        qr, k, v, regs, kvl, sched=sched, q_start=q0), 2)
    qb = torch.randn((BATCH, nh, rows, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    kb = torch.randn((BATCH, nkv, s, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vb = torch.randn((BATCH, nkv, s, hd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    pos = torch.arange(s, device=dev)
    qpos = pos[q0:, None]
    mask = (pos[None, :] <= qpos) & (qpos - pos[None, :] < cfg.sliding_window)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, enable_gqa=True), 10)
    pairs = bh * sum(min(i + 1, cfg.sliding_window) for i in range(q0, s))
    nbytes = qr.numel() + k.numel() + v.numel() + 4 * (
        ok.numel() + mlk.numel() + psk.numel())
    b_ms, b_by = bound(nbytes, 4 * pairs * hd, INT8_OPS)
    rec = dict(shape=[bh, rows, hd], kv=[zb, s, hd], q_start=q0,
               block=[bq, bkv], max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    log("general-attn", f"offset {rec['shape']} at q_start {q0} against "
                        f"{rec['kv']} ({SEQ_ARCH}'s last of {SEQ_SIZE} "
                        f"ranks, (bq, bkv) = ({bq}, {bkv})): rows bit for "
                        f"bit the whole call's; m, min/max/clip/n exact vs "
                        f"plain, out max |d| {err:.3e}; {ms:.4f} ms, bound "
                        f"{b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
                        f"SDPA {lib_ms:.4f} ms")
    results["offset_attention"] = rec
    return rec


def general_attention_phase(dev, records, results) -> None:
    """Phase 42: the attention kernel's general instantiation against its
    plain version (m and min/max/clip/n exact, out, l and err/sig within
    their tolerances) at the tiles past the mma instantiations, timed
    beside its bound, its plain version and bf16 SDPA; then the query
    offset at phase 47's shape (:func:`check_offset_attention`)."""
    from repro_torch import configs
    from repro_torch.kernels import ops

    base = configs.get("starcoder2-3b")
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "block")
    out = {}
    for tag, heads, kv, hd, block in GENERAL_TILES:
        c = dataclasses.replace(base, name=f"general-{tag}", n_heads=heads,
                                n_kv=kv, head_dim=hd)
        before = ops.tile_launch_counts()[("int8_attention", "general")]
        rec = check_attention(dev, torch.Generator(device=dev).manual_seed(
            hd + block[0] + block[1]), c, batch=1, seq=GENERAL_SEQ,
            block=block)
        runs = ops.tile_launch_counts()[("int8_attention", "general")] - \
            before
        if runs < 2:
            raise AssertionError(f"general {tag}: {runs} launches of the "
                                 f"general instantiation")
        out[tag] = {k: rec[k] for k in keys}
        lib = rec["library_ms"]
        log("general-attn", f"{tag} {rec['shape']} (bq, bkv) = {block}: "
                            f"{rec['ms']:.4f} ms, bound "
                            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                            f"plain {rec['plain_ms']:.4f} ms, SDPA "
                            + ("n/a" if lib is None else f"{lib:.4f}")
                            + " ms")
        del rec
        torch.cuda.empty_cache()
    out["offset"] = check_offset_attention(dev, results)
    results["general_attention"] = out
    for r in records:
        if r["name"] == "int8_attention":
            r["general"] = out


def _timed_collectives() -> dict:
    """Wrap this process's ``all_reduce`` / ``all_gather`` so each call is
    timed on the host clock, the card synchronized before and after (over
    gloo a collective is a copy through the host); returns the running
    totals ``{ms, calls, bytes}``."""
    import torch.distributed as dist
    acc = {"ms": 0.0, "calls": 0, "bytes": 0}
    orig = _DIST_FNS.setdefault("fns", (dist.all_reduce, dist.all_gather))

    def wrap(fn, arg):
        def timed(*a, **kw):
            t = a[arg]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            acc["ms"] += (time.perf_counter() - t0) * 1e3
            acc["calls"] += 1
            acc["bytes"] += t.numel() * t.element_size()
            return res
        return timed
    dist.all_reduce = wrap(orig[0], 0)
    dist.all_gather = wrap(orig[1], 1)
    return acc


_DIST_FNS: dict = {}    # this process's collectives before any wrap


def _tp_serve_rank(rank: int, world: int, inp: str, out: str) -> None:
    """One rank of phase 43 (a spawned process): starcoder2-3b at full
    width and depth on its (1, 2) model shard, through the step
    factories: prefill of phase 4's prompt, then greedy decode."""
    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.state import tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.models import model
    from repro_torch.runtime import sharding, steps

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = mesh.mesh_groups(1, world)
    cfg = configs.get("starcoder2-3b")
    pol = QuantPolicy.w8a8g8(backend="fused")
    full = model.init_params(cfg, seed=0, device=dev)
    params = sharding.shard_params(full, g.coords, g.sizes)
    del full
    torch.cuda.empty_cache()
    quant = model.init_quant_state(cfg, pol, device=dev)
    prompt = torch.load(inp, weights_only=False)["prompt"].to(dev)
    prefill = steps.make_prefill_step(cfg, pol, cache_len=PROMPT + GEN_RATE,
                                      model_group=g.model, return_stats=True)
    decode = steps.make_decode_step(cfg, pol, model_group=g.model)
    coll = _timed_collectives()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches, stats = prefill(params, quant, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre_coll = dict(coll)
    tok = logits.argmax(-1)[:, None]
    toks = [tok]
    t0 = time.perf_counter()
    for i in range(GEN_RATE - 1):
        pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int64, device=dev)
        lg, caches = decode(params, quant, {"token": tok, "pos": pos}, caches)
        tok = lg.argmax(-1)[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    rec = {"rank": rank, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": ops.launch_counts(),
           "prefill_collectives": pre_coll,
           "decode_collectives": {k: coll[k] - pre_coll[k] for k in coll}}
    Path(f"{out}/tp_serve_r{rank}.json").write_text(json.dumps(rec))
    if rank == 0:
        torch.save({"logits": logits.cpu(),
                    "tokens": torch.cat(toks, dim=1).cpu(),
                    "stats": tree_map(lambda t: t.cpu(), stats)},
                   f"{out}/tp_serve_r0.pt")


def tp_serve_phase(records, results) -> None:
    """Phase 43 (its ranks in the pair spawn, :func:`pair_spawn`):
    starcoder2-3b served over 2 gloo ranks on the card (model 2: each
    rank one of the 2 KV heads, half the MLP columns and of the
    vocabulary) against phase 4's one-process outputs at the same seed,
    kept: the prefill statistics bit for bit, the prefill logits within
    1e-5 relative L2, the 8 greedy tokens identical."""
    from repro_torch.core.state import tree_map_with_path

    one = KEPT["serve"]
    recs = [json.loads((OUT_DIR / f"tp_serve_r{r}.json").read_text())
            for r in range(TP_SIZE)]
    got = torch.load(OUT_DIR / "tp_serve_r0.pt", weights_only=False)
    bad = []
    tree_map_with_path(lambda p, a, b: None if torch.equal(a, b)
                       else bad.append(p), got["stats"], one["stats"])
    if bad:
        raise AssertionError(f"tp serve: {len(bad)} statistics leaves "
                             f"differ from phase 4's, e.g. {bad[:3]}")
    rel = float(torch.linalg.vector_norm(got["logits"] - one["logits"])
                / torch.linalg.vector_norm(one["logits"]))
    if rel > 1e-5:
        raise AssertionError(f"tp serve: prefill logits {rel:.3e} rel L2 "
                             f"off phase 4's")
    if not torch.equal(got["tokens"], one["tokens"]):
        raise AssertionError("tp serve: greedy tokens differ from phase 4's")
    counts = recs[0]["launches"]
    for k in TP_KERNELS:
        if not counts[k]:
            raise AssertionError(f"tp serve: {k} never launched: {counts}")
    n_stats = []
    tree_map_with_path(lambda p, a: n_stats.append(p), got["stats"])
    results["tp_serve"] = {"logits_rel_l2": rel, "stat_leaves": len(n_stats),
                           "ranks": recs}
    for r in recs:
        log("tp-serve", f"rank {r['rank']}: prefill {r['prefill_ms']:.1f} "
                        f"ms (of which gloo collectives, host copies, "
                        f"{r['prefill_collectives']['ms']:.1f} ms in "
                        f"{r['prefill_collectives']['calls']} calls, "
                        f"{r['prefill_collectives']['bytes'] / 2 ** 20:.0f}"
                        f" MiB), {GEN_RATE - 1} decode steps "
                        f"{r['decode_ms']:.1f} ms (collectives "
                        f"{r['decode_collectives']['ms']:.1f} ms), peak "
                        f"{r['peak_gib']:.2f} GiB")
    log("tp-serve", f"starcoder2-3b 30 layers d 3072 on (1, {TP_SIZE}), "
                    f"{BATCH} x {PROMPT} + {GEN_RATE - 1} decode steps: "
                    f"{len(n_stats)} statistics leaves bit for bit phase "
                    f"4's, prefill logits {rel:.3e} rel L2, {GEN_RATE} "
                    f"greedy tokens identical; launches {counts}")
    for r in records:
        r["tp_serve_launches"] = counts[r["name"]]


def _rel_l2(a, b) -> float:
    """The relative L2 distance of ``a`` from ``b``."""
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def _grad_rel_l2(got: dict, want: dict) -> list:
    """``[(relative L2 distance, name)]`` of the gradient tensors, the
    largest first."""
    return sorted(((_rel_l2(got[k].to(w.device), w), k)
                   for k, w in want.items()), reverse=True)


def _quant_check(got, want, what: str, grad_bar=1e-5) -> dict:
    """Activation leaves bit for bit, gradient leaves within ``grad_bar``
    (None: not held here) of the leaf's largest element; returns the
    worst gradient-leaf distance in those units, its leaf and the leaf
    counts."""
    from repro_torch.core.state import tree_map_with_path
    bad, worst, n = [], [0.0, None], [0, 0]

    def cmp(path, a, b):
        if "grad" in path:
            n[1] += 1
            scale = max(float(b.abs().max()), 1e-30)
            d = float((a - b).abs().max()) / scale
            if d >= worst[0]:
                worst[:] = [d, "/".join(map(str, path))]
        else:
            n[0] += 1
            if not torch.equal(a, b):
                bad.append(path)
    tree_map_with_path(cmp, got, want)
    if bad:
        raise AssertionError(f"{what}: {len(bad)} activation leaves differ "
                             f"from the one-process step's, e.g. {bad[:3]}")
    if grad_bar is not None and worst[0] > grad_bar:
        raise AssertionError(f"{what}: a gradient leaf ({worst[1]}) "
                             f"{worst[0]:.3e} of its largest element off the "
                             f"one-process step's")
    return {"grad_leaf_rel": worst[0], "grad_leaf_worst": worst[1],
            "act_leaves": n[0], "grad_leaves": n[1]}


def _tp_train_rank(rank: int, world: int, data_n: int, model_n: int,
                   arch: str, reduced: bool, layers: int, batch_n: int,
                   seq: int, out: str, floor_bars: bool = False,
                   seq_shard: bool = False) -> None:
    """One rank of phases 44-48 (a spawned process): the train step on a
    ``(data_n, model_n)`` mesh, then, on rank 0, the one-process step on
    the same parameters and batch and the comparison.  Phase 44's bars:
    gradient-site leaves within 1e-5 of their largest element, the
    clipped gradients within 2**-7 rel L2 or ``TP_FLOOR_MARGIN`` times
    the one-process step's own worst distance under another fp32
    association (its floor: the backward's dx products whole-batch, or
    for a batch of one their contraction in ``model_n`` blocks,
    ``backend.reassociate``).  ``floor_bars`` (phases 45-48): each bar is
    the larger of that fixed one and ``TP_FLOOR_MARGIN`` times the
    floor of what it holds, the leaves' worst floor and each gradient
    tensor's own (the fixed bar wherever the one-process step repeats
    itself that closely), and doubled or halved gradients must fail
    some tensor's bar.  ``seq_shard`` (phase 50): the mesh's step with
    the residual stream the rank's rows of the sequence."""
    import torch.distributed as dist

    from repro_torch import configs, data
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.models import model
    from repro_torch.optim import Optimizer, adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import sharding, steps

    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    g = mesh.mesh_groups(data_n, model_n)
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    pol = QuantPolicy.w8a8g8(backend="fused")
    seen = {}
    base = adamw()

    def update(grads, state, params, lr):     # the gradients handed over
        seen["grads"] = {k: v.detach().clone() for k, v in grads.items()}
        return base.update(grads, state, params, lr)

    opt = Optimizer(init=base.init, update=update)
    batch = {k: v.to(dev) for k, v in data.for_arch(
        cfg, seq_len=seq, global_batch=batch_n, seed=0).batch(0).items()}

    def fresh(shard: bool):
        params = model.init_params(cfg, seed=0, device=dev)
        if shard:
            params = sharding.shard_params(params, g.coords, g.sizes)
        return steps.train_state(
            params, model.init_quant_state(cfg, pol, device=dev), opt)

    st = fresh(True)
    ts = steps.make_train_step(cfg, pol, opt, constant(DP_LR), group=g.data,
                               model_group=g.model, seq_shard=seq_shard)
    layouts, layout_of = set(), sharding.attn_layout

    def spy(*a, **kw):      # the attention layouts the step ran
        layouts.add(layout_of(*a, **kw))
        return layout_of(*a, **kw)
    sharding.attn_layout = spy
    coll = _timed_collectives()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, met = ts(st, batch)
    torch.cuda.synchronize()
    sharding.attn_layout = layout_of
    met_norm = met["grad_norm"]
    rec = {"rank": rank, "step_ms": (time.perf_counter() - t0) * 1e3,
           "loss": float(met["loss"]), "collectives": dict(coll),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": ops.launch_counts(), "layouts": sorted(layouts)}
    names = list(seen["grads"])
    grads = seen.pop("grads")
    quant = st["quant"]
    coll0 = dict(coll)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = ts(st, batch)[0]      # a warm step (the first held the first use)
    torch.cuda.synchronize()
    rec["warm_step_ms"] = (time.perf_counter() - t0) * 1e3
    rec["warm_collectives"] = {k: coll[k] - coll0[k] for k in coll}
    seen.clear()
    del st, met
    torch.cuda.empty_cache()
    if 0 < rank < model_n:     # data row 0's other shards, to rank 0
        for k in names:        # (a padded head dim's shares differ)
            dist.send(torch.tensor(grads[k].shape, dtype=torch.int64), 0)
            if grads[k].numel():
                dist.send(grads[k].cpu(), 0)
    elif rank == 0:
        shards = [grads]
        for m in range(1, model_n):
            part = {}
            for k in names:
                shape = torch.empty(grads[k].dim(), dtype=torch.int64)
                dist.recv(shape, m)
                t = torch.empty(tuple(shape.tolist()), dtype=grads[k].dtype)
                if t.numel():
                    dist.recv(t, m)
                part[k] = t.to(dev)
            shards.append(part)
        one = fresh(False)
        like = dict(one["params"].named_parameters())
        whole = sharding.gather_named(shards, like)
        # a fault of the uneven split: the last rank that holds a share of
        # a padded tensor (wq, wo, bq) loses it
        uneven = [k for k in names
                  if len({tuple(s[k].shape) for s in shards}) > 1]
        cut = [dict(s) for s in shards]
        for k in uneven:
            r = max(r for r, s in enumerate(shards) if s[k].numel())
            cut[r][k] = torch.zeros_like(shards[r][k])
        dropped = sharding.gather_named(cut, {k: like[k] for k in uneven})
        del shards, grads, cut
        # held on the host through the one-process steps (the card holds
        # them and both ranks' states): compared a tensor at a time
        whole = {k: v.cpu() for k, v in whole.items()}
        dropped = {k: v.cpu() for k, v in dropped.items()}
        torch.cuda.empty_cache()
        ts1 = steps.make_train_step(cfg, pol, opt, constant(DP_LR))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one, met1 = ts1(one, batch)
        torch.cuda.synchronize()
        rec["single_step_ms"] = (time.perf_counter() - t0) * 1e3
        rec["single_loss"] = float(met1["loss"])
        one_grads, one_quant = seen.pop("grads"), one["quant"]
        rec.update(_quant_check(quant, one_quant, f"tp train {arch}",
                                grad_bar=None))
        rel = abs(rec["loss"] - rec["single_loss"]) / abs(rec["single_loss"])
        if rel > 1e-5:
            raise AssertionError(f"tp train {arch}: loss {rec['loss']} vs "
                                 f"one process {rec['single_loss']}")
        rec["loss_rel"] = rel
        rec["single_grad_norm"] = float(met1["grad_norm"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = ts1(one, batch)[0]
        torch.cuda.synchronize()
        rec["single_warm_ms"] = (time.perf_counter() - t0) * 1e3
        seen.clear()
        del one, met1
        torch.cuda.empty_cache()
        # The one-process step's own noise floor: the same step with its
        # backward's dx products run whole-batch (not one batch index at
        # a time: another fp32 association on the card), whose flips of
        # stochastically rounded gradients carry down the layers.  A batch
        # of one has no such split: its dx products' contraction runs in
        # model_n blocks instead (the model axis's own association).
        from repro_torch.core import backend
        saved = backend.SPLIT_MIN_ROWS
        if batch_n > 1:
            backend.SPLIT_MIN_ROWS = 1 << 62
        try:
            with backend.reassociate(model_n if batch_n == 1 else 1):
                two = fresh(False)
                two = steps.make_train_step(cfg, pol, opt,
                                            constant(DP_LR))(two, batch)[0]
        finally:
            backend.SPLIT_MIN_ROWS = saved
        floor = _grad_rel_l2(seen.pop("grads"), one_grads)
        leaf_floor = _quant_check(two["quant"], one_quant,
                                  f"tp train {arch} floor", grad_bar=None)
        del two
        torch.cuda.empty_cache()
        rels = _grad_rel_l2(whole, one_grads)
        bar = max(2 ** -7, TP_FLOOR_MARGIN * floor[0][0])
        rec.update(grad_rel_l2=rels[0][0], grad_worst=rels[:8],
                   floor_rel_l2=floor[0][0], floor_worst=floor[:8],
                   grad_bar=bar, grad_norm=float(met_norm),
                   grad_leaf_floor=leaf_floor["grad_leaf_rel"],
                   grad_leaf_floor_worst=leaf_floor["grad_leaf_worst"],
                   grad_leaf_bar=1e-5)
        if floor_bars:
            # each tensor against its own floor; the worst by its bar
            bars = {k: max(2 ** -7, TP_FLOOR_MARGIN * f) for f, k in floor}
            ratio = sorted(((r / bars[k], r, k) for r, k in rels),
                           reverse=True)
            rec.update(grad_bar=bars[ratio[0][2]], grad_rel_l2=ratio[0][1],
                       grad_worst_by_bar=ratio[:8],
                       grad_fixed_bars=sum(b == 2 ** -7
                                           for b in bars.values()),
                       grad_leaf_bar=max(1e-5, TP_FLOOR_MARGIN
                                         * leaf_floor["grad_leaf_rel"]))

            def worst(scaled):  # the largest rel L2 / bar of a candidate
                return max(r / bars[k] for r, k in _grad_rel_l2(
                    {k: g * scaled for k, g in whole.items()}, one_grads))
            # refused where some tensor exceeds its bar: here the
            # largest rel L2 / bar, refused above 1
            rec["grad_rel_doubled"] = worst(2.0)
            rec["grad_rel_halved"] = worst(0.5)
            if uneven:
                rec["grad_dropped_by_bar"] = sorted(
                    ((r / bars[k], r, k) for r, k in _grad_rel_l2(
                        dropped, {k: one_grads[k] for k in uneven})),
                    reverse=True)
        else:
            # the check can fail: gradients summed twice, or averaged
            rec["grad_rel_doubled"] = _grad_rel_l2(
                {k: 2 * g for k, g in whole.items()}, one_grads)[-1][0]
            rec["grad_rel_halved"] = _grad_rel_l2(
                {k: g / 2 for k, g in whole.items()}, one_grads)[-1][0]
        log("tp-train", f"{arch}: gradients rel L2 worst {rels[:8]}; the "
                        f"one-process noise floor worst {floor[:8]}; bar "
                        f"{bar:.4e}; norms {rec['grad_norm']} vs "
                        f"{rec['single_grad_norm']}; gradient-site leaves "
                        f"worst {rec['grad_leaf_rel']:.3e} "
                        f"({rec['grad_leaf_worst']}), the one-process "
                        f"floor {rec['grad_leaf_floor']:.3e} "
                        f"({rec['grad_leaf_floor_worst']}), bar "
                        f"{rec['grad_leaf_bar']:.3e}"
                        + (f"; by each tensor's bar, worst "
                           f"{rec['grad_worst_by_bar']}, "
                           f"{rec['grad_fixed_bars']} of {len(rels)} "
                           f"tensors at 2**-7" if floor_bars else ""))
        if rec["grad_leaf_rel"] > rec["grad_leaf_bar"]:
            raise AssertionError(f"tp train {arch}: a gradient leaf "
                                 f"({rec['grad_leaf_worst']}) "
                                 f"{rec['grad_leaf_rel']:.3e} of its largest "
                                 f"element off the one-process step's (its "
                                 f"own floor {rec['grad_leaf_floor']:.3e}, "
                                 f"bar {rec['grad_leaf_bar']:.3e})")
        bar = rec["grad_bar"]
        if rec["grad_rel_l2"] > bar:
            raise AssertionError(f"tp train {arch}: a gradient "
                                 f"{rec['grad_rel_l2']:.3e} rel L2 off the "
                                 f"one-process step's, above {bar:.3e}")
        for key in ("grad_rel_doubled", "grad_rel_halved"):
            if rec[key] <= (1.0 if floor_bars else bar):
                raise AssertionError(f"tp train {arch}: the gradient check "
                                     f"passes {key[9:]} gradients")
        if rec.get("grad_dropped_by_bar", [(2.0,)])[0][0] <= 1.0:
            raise AssertionError(f"tp train {arch}: the gradient check "
                                 f"passes the padded tensors with the last "
                                 f"rank's share dropped "
                                 f"({rec['grad_dropped_by_bar']})")
        del whole, one_grads, one_quant
    Path(f"{out}.r{rank}.json").write_text(json.dumps(rec))
    dist.barrier()


def tp_train_phase(records, results) -> None:
    """Phase 44: qwen2-moe-a2.7b's train step at full width, depth 1, 4 x
    1024 on (1, 2) (30 of the 60 experts a rank, 8 of the 16 KV heads,
    half the shared expert's columns and of the vocabulary; its ranks in
    the pair spawn), then the reduced config on (2, 2) (a spawn of its
    own: :func:`reduced_spawn`), gloo ranks on the card,
    each against the
    one-process step on rank 0: activation-site quant state bit for bit,
    gradient sites within 1e-5 of the largest element, the loss within
    1e-5 relative, the clipped gradients within 2**-7 relative L2."""
    results["tp_train"] = {}
    for tag, (d, m), reduced, layers, b, s in TP_TRAIN_RUNS:
        out = OUT_DIR / f"tp_train_{tag}"
        recs = [json.loads(Path(f"{out}.r{r}.json").read_text())
                for r in range(d * m)]
        r0 = recs[0]
        counts = r0["launches"]
        for k in TP_KERNELS + ("stochastic_quantize",):
            if not counts[k]:
                raise AssertionError(f"tp train {tag}: {k} never launched: "
                                     f"{counts}")
        results["tp_train"][tag] = recs
        log("tp-train", f"{MOE_ARCH} {tag} on ({d}, {m}), {b} x {s}: "
                        f"{r0['act_leaves']} activation leaves bit for bit, "
                        f"{r0['grad_leaves']} gradient leaves within "
                        f"{r0['grad_leaf_rel']:.3e} of their largest "
                        f"element, loss {r0['loss']:.7f} vs "
                        f"{r0['single_loss']:.7f} ({r0['loss_rel']:.2e} "
                        f"rel), gradients within {r0['grad_rel_l2']:.3e} "
                        f"rel L2 (the one-process noise floor "
                        f"{r0['floor_rel_l2']:.3e}, bar "
                        f"{r0['grad_bar']:.3e}; doubled "
                        f"{r0['grad_rel_doubled']:.2f}, halved "
                        f"{r0['grad_rel_halved']:.2f} refused); step (host "
                        f"clock) first {r0['step_ms']:.1f} ms, warm "
                        f"{r0['warm_step_ms']:.1f} ms sharded vs first "
                        f"{r0['single_step_ms']:.1f}, warm "
                        f"{r0['single_warm_ms']:.1f} ms one process; "
                        f"launches {counts}")
        for r in recs:
            log("tp-train", f"{tag} rank {r['rank']}: first step "
                            f"{r['step_ms']:.1f} ms, of which gloo "
                            f"collectives (host copies) "
                            f"{r['collectives']['ms']:.1f} ms in "
                            f"{r['collectives']['calls']} calls "
                            f"({r['collectives']['bytes'] / 2 ** 20:.0f} "
                            f"MiB); warm step {r['warm_step_ms']:.1f} ms, "
                            f"collectives "
                            f"{r['warm_collectives']['ms']:.1f} ms; peak "
                            f"{r['peak_gib']:.2f} GiB")
        if tag == "full":
            for rr in records:
                rr["tp_train_launches"] = counts[rr["name"]]
            continue
        zs = [json.loads(Path(f"{out}.zero3.r{r}.json").read_text())
              for r in range(d * m)]
        z0 = zs[0]
        fracs = [round(z["stored_bytes"] / z["whole_bytes"], 3) for z in zs]
        results["tp_train"]["zero3"] = zs
        log("zero3", f"{MOE_ARCH} reduced on ({d}, {m}), ZeRO-3 with expert "
                     f"parallelism, {b} x {s}: {z0['act_leaves']} activation "
                     f"leaves bit for bit, {z0['grad_leaves']} gradient "
                     f"leaves within {z0['grad_leaf_rel']:.3e}, loss "
                     f"{z0['loss_rel']:.2e} rel, clipped gradients "
                     f"{z0['grad_rel_l2'][0]:.3e} rel L2 at worst (<= "
                     f"2**-7), AdamW params within "
                     f"{z0['param_max_abs']:.3e}; stored "
                     f"{fracs} "
                     f"of the whole state a rank; {z0['gathers']} gathers "
                     f"{z0['gather_ms']:.1f} ms, {z0['scatters']} "
                     f"reduce-scatters {z0['scatter_ms']:.1f} ms (gloo); "
                     f"launches {z0['launches']}")

def _pair_rank(rank: int, world: int, jobs: tuple, out: str) -> None:
    """One rank of the pair spawn (phases 43-46, the (1, 2) runs): each
    job ``(function name, args)`` in turn in the same process; rank 0
    notes the wall clock as each ends."""
    marks = []
    for name, args in jobs:
        globals()[name](rank, world, *args)
        marks.append(time.time())
        torch.cuda.empty_cache()
    if rank == 0:
        Path(out).write_text(json.dumps(marks))


def pair_jobs(phases: tuple) -> list:
    """The pair spawn's jobs ``(phase, function name, args)`` for
    ``phases`` (of 43-46), their inputs written."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    if 43 in phases:
        inp = OUT_DIR / "tp_serve_in.pt"
        torch.save({"prompt": KEPT["serve"]["prompt"]}, inp)
        jobs.append((43, "_tp_serve_rank", (str(inp), str(OUT_DIR))))
    if 44 in phases:
        tag, _, reduced, layers, b, seq = TP_TRAIN_RUNS[0]
        jobs.append((44, "_tp_train_rank",
                     (1, TP_SIZE, MOE_ARCH, reduced, layers, b, seq,
                      str(OUT_DIR / f"tp_train_{tag}"))))
    for n, arch, layers, _ in TP_FAMILY:
        if n in phases:
            jobs.append((n, "_tp_family_rank",
                         (arch, layers, str(OUT_DIR / f"tp_{arch}"))))
    return jobs


def reduced_spawn() -> float:
    """Phase 44's reduced (2, 2) run: a spawn of 4 gloo ranks on the card
    (its own store); returns its seconds."""
    from repro_torch.launch import mesh

    t = time.time()
    for tag, (d, m), reduced, layers, b, s in TP_TRAIN_RUNS:
        if (d, m) != (1, TP_SIZE):     # (1, 2) runs in the pair spawn
            mesh.spawn_ranks(_tp_reduced_rank, d * m,
                             OUT_DIR / "store_reduced", backend="gloo",
                             args=(d, m, MOE_ARCH, reduced, layers, b, s,
                                   str(OUT_DIR / f"tp_train_{tag}")))
    return time.time() - t


def pair_spawn(jobs: list) -> dict:
    """Phases 43-46's ranks: one spawn of 2 gloo ranks on the card (the
    (1, 2) runs of ``jobs`` in turn: 43's serve, 44's full-width step,
    45's and 46's families).  Returns the seconds each phase's ranks
    took (a job's share of the spawn, the first one's with the spawn
    itself)."""
    from repro_torch.launch import mesh

    marks = OUT_DIR / "pair_marks.json"
    t0 = time.time()
    mesh.spawn_ranks(_pair_rank, TP_SIZE, OUT_DIR / "store", backend="gloo",
                     args=(tuple(j[1:] for j in jobs), str(marks)))
    ends = json.loads(marks.read_text())
    return {n: z - a for (n, _, _), a, z in
            zip(jobs, [t0] + ends[:-1], ends)}


def pair_checks(jobs: list, seconds: dict, records, results, clock) -> None:
    """Phases 43-46's checks on their ranks' records (:func:`pair_spawn`);
    each phase's seconds are its ranks' and its checks'."""
    family = {n: (arch, layers, kernels)
              for n, arch, layers, kernels in TP_FAMILY}
    for n, _, _ in jobs:
        t = time.time()
        if n == 43:
            name = "tp serve"
            tp_serve_phase(records, results)
        elif n == 44:
            name = "tp train"
            tp_train_phase(records, results)
        else:
            arch, layers, kernels = family[n]
            name = f"tp {arch}"
            tp_family_phase(n, arch, layers, kernels, records, results)
        clock.add(n, name, seconds[n] + time.time() - t)


def _host_tree(tree) -> dict:
    """``{path: tensor on the host}`` of a tree of tensors."""
    from repro_torch.core.state import tree_map_with_path
    out = {}
    tree_map_with_path(lambda p, t: out.__setitem__(p, t.detach().cpu()),
                       tree)
    return out


def _cache_slice(t, name: str, r: int, world: int):
    """Model rank ``r``'s slice of a one-process cache leaf ``name`` by
    ``sharding.cache_pspecs`` (the reference's rule): the RG-LRU's
    channels, RWKV-6's heads, the KV heads, else the cache length."""
    from repro_torch.runtime import sharding
    spec = sharding.cache_pspecs({name: t}, {"data": 1, "model": world},
                                 ("data",))[name]
    for d, ax in enumerate(spec):
        if ax == "model":
            n = t.shape[d] // world
            t = t.narrow(d, r * n, n)
    return t


def _tp_family_rank(rank: int, world: int, arch: str, layers: int,
                    out: str) -> None:
    """One rank of phases 45-46 (a spawned process): ``arch`` at full
    width, ``layers`` layers, on its (1, world) model shard, served
    through the step factories (a 4 x 1024 prefill with its statistics,
    7 greedy decode steps); then rank 0 serves the one-process program on
    the same parameters and compares; then the train step as phase 44
    runs it (:func:`_tp_train_rank`)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.models import model
    from repro_torch.runtime import sharding, steps

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = mesh.mesh_groups(1, world)
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    pol = QuantPolicy.w8a8g8(backend="fused")
    prompt = _prompt(cfg, BATCH, PROMPT, dev)
    quant = model.init_quant_state(cfg, pol, device=dev)

    def serve(params, group) -> dict:
        prefill = steps.make_prefill_step(cfg, pol,
                                          cache_len=PROMPT + GEN_RATE,
                                          model_group=group,
                                          return_stats=True)
        decode = steps.make_decode_step(cfg, pol, model_group=group)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, stats = prefill(params, quant, {"tokens": prompt})
        torch.cuda.synchronize()
        res = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
               "cache": _host_tree(caches["decoder"]),
               "logits": logits.float().cpu(), "stats": _host_tree(stats)}
        tok = logits.argmax(-1)[:, None]
        toks = [tok]
        t0 = time.perf_counter()
        for i in range(GEN_RATE - 1):
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int64,
                             device=dev)
            lg, caches = decode(params, quant, {"token": tok, "pos": pos},
                                caches)
            tok = lg.argmax(-1)[:, None]
            toks.append(tok)
        torch.cuda.synchronize()
        res.update(decode_ms=(time.perf_counter() - t0) * 1e3,
                   tokens=torch.cat(toks, dim=1).cpu(),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        return res

    full = model.init_params(cfg, seed=0, device=dev)
    params = sharding.shard_params(full, g.coords, g.sizes)
    del full
    torch.cuda.empty_cache()
    saved = dist.all_reduce, dist.all_gather
    coll = _timed_collectives()
    ops.reset_launch_counts()
    got = serve(params, g.model)
    rec = {"rank": rank, "launches": ops.launch_counts(),
           "collectives": dict(coll),
           **{k: got[k] for k in ("prefill_ms", "decode_ms", "peak_gib")}}
    dist.all_reduce, dist.all_gather = saved
    torch.save({"cache": got["cache"]}, f"{out}.serve.r{rank}.pt")
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        one = serve(model.init_params(cfg, seed=0, device=dev), None)
        torch.cuda.empty_cache()
        bad = [p for p, t in one["stats"].items()
               if not torch.equal(got["stats"][p], t)]
        if bad:
            raise AssertionError(f"tp {arch}: {len(bad)} prefill statistics "
                                 f"leaves differ from one process's, e.g. "
                                 f"{bad[:3]}")
        n_sliced = 0
        for r in range(world):
            part = torch.load(f"{out}.serve.r{r}.pt",
                              weights_only=False)["cache"]
            for p, want in one["cache"].items():
                have = part[p]
                sliced = _cache_slice(want, p[-1], r, world)
                n_sliced += sliced.shape != want.shape
                if not torch.equal(have, sliced):
                    raise AssertionError(f"tp {arch}: rank {r}'s cache "
                                         f"{p} is not the one-process "
                                         f"cache's slice")
        rel = float(torch.linalg.vector_norm(got["logits"] - one["logits"])
                    / torch.linalg.vector_norm(one["logits"]))
        if rel > 1e-5:
            raise AssertionError(f"tp {arch}: prefill logits {rel:.3e} rel "
                                 f"L2 off one process's")
        if not torch.equal(got["tokens"], one["tokens"]):
            raise AssertionError(f"tp {arch}: greedy tokens differ from one "
                                 f"process's")
        rec.update(logits_rel_l2=rel, stat_leaves=len(one["stats"]),
                   cache_slices=n_sliced,
                   single_prefill_ms=one["prefill_ms"],
                   single_decode_ms=one["decode_ms"],
                   single_peak_gib=one["peak_gib"])
        del one
    Path(f"{out}.serve.r{rank}.json").write_text(json.dumps(rec))
    del got
    torch.cuda.empty_cache()
    dist.barrier()
    _tp_train_rank(rank, world, 1, world, arch, False, layers, BATCH, PROMPT,
                   f"{out}.train", True)


def tp_family_phase(n: int, arch: str, layers: int, kernels: tuple,
                    records, results) -> None:
    """Phases 45-46: ``arch`` on (1, 2) over gloo ranks on the card (in
    the pair spawn), served and trained (:func:`_tp_family_rank`)
    against one process:
    the prefill statistics bit for bit, each rank's cache the one-process
    cache's slice, the prefill logits within 1e-5 rel L2, the 8 greedy
    tokens identical; the train step with phase 44's bars against the
    one-process floors (:func:`_tp_train_rank`'s ``floor_bars``).  Every
    kernel
    of ``kernels`` launched in the train step, every one but
    ``stochastic_quantize`` in the serve run."""
    out = OUT_DIR / f"tp_{arch}"
    serve = [json.loads(Path(f"{out}.serve.r{r}.json").read_text())
             for r in range(TP_SIZE)]
    train = [json.loads(Path(f"{out}.train.r{r}.json").read_text())
             for r in range(TP_SIZE)]
    for what, recs, want in (("serve", serve, kernels[:-1]),
                             ("train", train, kernels)):
        for k in want:
            if not recs[0]["launches"][k]:
                raise AssertionError(f"tp {arch} {what}: {k} never "
                                     f"launched: {recs[0]['launches']}")
    s0, t0 = serve[0], train[0]
    results[f"tp_{arch}"] = {"serve": serve, "train": train}
    log("tp-family", f"{arch} {layers} layers on (1, {TP_SIZE}): serve "
                     f"{BATCH} x {PROMPT} + {GEN_RATE - 1} decode steps: "
                     f"{s0['stat_leaves']} statistics leaves bit for bit, "
                     f"{s0['cache_slices']} cache leaves the one-process "
                     f"slices, prefill logits {s0['logits_rel_l2']:.3e} rel "
                     f"L2, {GEN_RATE} greedy tokens identical; prefill "
                     f"{s0['prefill_ms']:.1f} ms (collectives "
                     f"{s0['collectives']['ms']:.1f} ms in "
                     f"{s0['collectives']['calls']} calls) vs "
                     f"{s0['single_prefill_ms']:.1f} ms one process, decode "
                     f"{s0['decode_ms']:.1f} vs {s0['single_decode_ms']:.1f}"
                     f" ms, peak {s0['peak_gib']:.2f} vs "
                     f"{s0['single_peak_gib']:.2f} GiB; launches "
                     f"{s0['launches']}")
    log("tp-family", f"{arch} train {BATCH} x {PROMPT}: {t0['act_leaves']} "
                     f"activation leaves bit for bit, {t0['grad_leaves']} "
                     f"gradient leaves within {t0['grad_leaf_rel']:.3e} "
                     f"(floor {t0['grad_leaf_floor']:.3e}, bar "
                     f"{t0['grad_leaf_bar']:.3e}), loss "
                     f"{t0['loss_rel']:.2e} rel, gradients: the worst "
                     f"against its bar {t0['grad_rel_l2']:.3e} rel L2 "
                     f"(bar {t0['grad_bar']:.3e}; the worst floor "
                     f"{t0['floor_rel_l2']:.3e}, {t0['grad_fixed_bars']} "
                     f"tensors at 2**-7; doubled {t0['grad_rel_doubled']:.2f}"
                     f"x, halved {t0['grad_rel_halved']:.2f}x a tensor's "
                     f"bar, refused); first step "
                     f"{t0['step_ms']:.1f} ms, warm {t0['warm_step_ms']:.1f}"
                     f" ms vs {t0['single_step_ms']:.1f} / "
                     f"{t0['single_warm_ms']:.1f} ms one process; peak "
                     f"{max(r['peak_gib'] for r in train):.2f} GiB a rank; "
                     f"launches {t0['launches']}")
    for r in records:
        r[f"tp_{n}_launches"] = t0["launches"].get(r["name"], 0)


def _pad_serve_rank(rank: int, world: int, out: str,
                    seq_shard: bool = False) -> None:
    """One rank of phase 48's serve run (a spawned process):
    starcoder2-3b at full width, ``PAD_LAYERS`` layers, on its (1, world)
    shard, on the padded layout: a 4 x 1024 prefill with its statistics
    into a ``PROMPT + PAD_GEN``-slot cache (the length-sharded cache),
    ``PAD_GEN`` greedy decode steps, then the last step again with every
    ``wo`` doubled, and again with the last rank that holds heads
    dropping its ``o`` partial (its ``wo`` zeroed): the check must refuse
    both.  Then rank 0 serves the one-process program on the same
    parameters, and again with the decode sums over L in 8 blocks
    (``backend.reassociate``: its floor), and compares.  ``seq_shard``
    (phase 50): the same run with the residual stream the rank's rows of
    the sequence, and the refused fault rank 0's share of every
    reduce-scatter dropped (zeroed: the decode step's one row is
    rank 0's)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import backend
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.models import attention, model
    from repro_torch.runtime import sharding, steps

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = mesh.mesh_groups(1, world)
    cfg = dataclasses.replace(configs.get(SEQ_ARCH), n_layers=PAD_LAYERS)
    pol = QuantPolicy.w8a8g8(backend="fused")
    prompt = _prompt(cfg, BATCH, PROMPT, dev)
    quant = model.init_quant_state(cfg, pol, device=dev)

    def serve(params, group) -> dict:
        sp = seq_shard and group is not None
        prefill = steps.make_prefill_step(cfg, pol,
                                          cache_len=PROMPT + PAD_GEN,
                                          model_group=group,
                                          return_stats=True, seq_shard=sp)
        decode = steps.make_decode_step(cfg, pol, model_group=group,
                                        seq_shard=sp)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, stats = prefill(params, quant, {"tokens": prompt})
        torch.cuda.synchronize()
        res = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
               "cache": _host_tree(caches["decoder"]),
               "cache_bytes": sum(t.numel() * t.element_size() for t in
                                  _host_tree(caches["decoder"]).values()),
               "stats": _host_tree(stats), "logits": [logits.float().cpu()]}
        tok = logits.argmax(-1)[:, None]
        toks = [tok]
        t0 = time.perf_counter()
        for i in range(PAD_GEN):
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int64,
                             device=dev)
            lg, caches = decode(params, quant, {"token": toks[-1],
                                                "pos": pos}, caches)
            res["logits"].append(lg.float().cpu())
            toks.append(lg.argmax(-1)[:, None])
        torch.cuda.synchronize()
        res.update(decode_ms=(time.perf_counter() - t0) * 1e3,
                   tokens=torch.cat(toks, dim=1).cpu(),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches=ops.launch_counts(), collectives=dict(coll))
        # the last step again with the o projections' outputs doubled (a
        # check: not counted)
        wo = [p for n, p in params.named_parameters()
              if n.endswith(".attn.wo")]
        with torch.no_grad():
            for p in wo:
                p.mul_(2)
            lg, _ = decode(params, quant, {"token": toks[-2], "pos": pos},
                           caches)
            for p in wo:
                p.div_(2)
        res["doubled_logits"] = lg.float().cpu()
        if sp:
            # rank 0's share of every reduce-scatter dropped
            scatter = sharding.mp_scatter_now

            def dropped(x, dim):
                y = scatter(x, dim)
                return torch.zeros_like(y) if rank == 0 else y
            sharding.mp_scatter_now = dropped
            try:
                with torch.no_grad():
                    lg, _ = decode(params, quant, {"token": toks[-2],
                                                   "pos": pos}, caches)
            finally:
                sharding.mp_scatter_now = scatter
            res["dropped_logits"] = lg.float().cpu()
        elif group is not None:
            # the last rank that holds heads drops its o partial
            keep = [p.clone() for p in wo]
            with torch.no_grad():
                if rank == last:
                    for p in wo:
                        p.zero_()
                lg, _ = decode(params, quant, {"token": toks[-2],
                                               "pos": pos}, caches)
                for p, k in zip(wo, keep):
                    p.copy_(k)
            res["dropped_logits"] = lg.float().cpu()
        return res

    full = model.init_params(cfg, seed=0, device=dev)
    params = sharding.shard_params(full, g.coords, g.sizes)
    del full
    torch.cuda.empty_cache()
    with sharding.model_parallel(g.model):
        heads = attention.local_heads(cfg.n_kv, cfg.n_heads // cfg.n_kv)
    last = max(r for r in range(world) if sharding.split_range(
        cfg.n_heads // cfg.n_kv, world, r)[1])
    saved = dist.all_reduce, dist.all_gather
    coll = _timed_collectives()
    layouts, layout_of = [], sharding.attn_layout

    def spy(*a, **kw):      # the layers' attention layouts
        layouts.append(layout_of(*a, **kw))
        return layouts[-1]
    sharding.attn_layout = spy
    ops.reset_launch_counts()
    got = serve(params, g.model)
    sharding.attn_layout = layout_of
    dist.all_reduce, dist.all_gather = saved
    rec = {"rank": rank, "launches": got["launches"],
           "collectives": got["collectives"],
           "heads": list(heads[:2]), "layout": heads[2],
           "layouts": {k: layouts.count(k) for k in sorted(set(layouts))},
           **{k: got[k] for k in ("prefill_ms", "decode_ms", "peak_gib",
                                  "cache_bytes")}}
    torch.save({"cache": got["cache"]}, f"{out}.r{rank}.pt")
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        full = model.init_params(cfg, seed=0, device=dev)
        one = serve(full, None)
        with backend.reassociate(world):
            blocks = serve(full, None)
        del full
        torch.cuda.empty_cache()
        bad = [p for p, t in one["stats"].items()
               if not torch.equal(got["stats"][p], t)]
        if bad:
            raise AssertionError(f"padded serve: {len(bad)} prefill "
                                 f"statistics leaves differ from one "
                                 f"process's, e.g. {bad[:3]}")
        n_slots = []
        for r in range(world):
            part = torch.load(f"{out}.r{r}.pt", weights_only=False)["cache"]
            for p, want in one["cache"].items():
                sliced = _cache_slice(want, p[-1], r, world)
                if not torch.equal(part[p], sliced):
                    raise AssertionError(f"padded serve: rank {r}'s cache "
                                         f"{p} is not its slice of the "
                                         f"one-process cache")
                if p[-1] == "k":
                    n_slots.append(part[p].shape[1])
        rels = [_rel_l2(a, b) for a, b in zip(got["logits"], one["logits"])]
        floor = max(_rel_l2(a, b) for a, b in zip(blocks["logits"][1:],
                                                   one["logits"][1:]))
        bar = max(PAD_LOGITS_TOL, TP_FLOOR_MARGIN * floor)
        doubled = _rel_l2(got["doubled_logits"], one["logits"][-1])
        dropped = _rel_l2(got["dropped_logits"], one["logits"][-1])
        if seq_shard:
            last = 0
        rec.update(prefill_rel_l2=rels[0], decode_rel_l2=max(rels[1:]),
                   prefill_identical=torch.equal(got["logits"][0],
                                                 one["logits"][0]),
                   decode_identical=sum(torch.equal(a, b) for a, b in zip(
                       got["logits"][1:], one["logits"][1:])),
                   decode_floor=floor, decode_bar=bar,
                   doubled_rel_l2=doubled, dropped_rel_l2=dropped,
                   dropped_rank=last, slots=sorted(set(n_slots)),
                   stat_leaves=len(one["stats"]),
                   single_prefill_ms=one["prefill_ms"],
                   single_decode_ms=one["decode_ms"],
                   single_peak_gib=one["peak_gib"],
                   single_cache_bytes=one["cache_bytes"],
                   tokens=got["tokens"].tolist())
        if not rec["prefill_identical"]:
            raise AssertionError(f"padded serve: prefill logits differ "
                                 f"from one process's ({rels[0]:.3e} rel "
                                 f"L2)")
        if not torch.equal(got["tokens"], one["tokens"]):
            raise AssertionError("padded serve: greedy tokens differ from "
                                 "one process's")
        if max(rels[1:]) > bar:
            raise AssertionError(f"padded serve: decode logits "
                                 f"{max(rels[1:]):.3e} rel L2 off one "
                                 f"process's, above {bar:.3e}")
        if doubled <= bar:
            raise AssertionError(f"padded serve: the decode check passes a "
                                 f"doubled o output ({doubled:.3e})")
        if dropped <= bar:
            raise AssertionError(f"padded serve: the decode check passes "
                                 f"rank {last}'s "
                                 + ("reduce-scatter share" if seq_shard
                                    else "o partial") + " dropped "
                                 f"({dropped:.3e})")
        log("seq-shard" if seq_shard else "padded",
            f"rank 0: prefill logits {rels[0]:.3e} rel L2, decode "
            f"{max(rels[1:]):.3e} (floor {floor:.3e}, bar {bar:.3e}; wo "
            f"doubled {doubled:.3e}, rank {last}'s "
            + ("reduce-scatter share" if seq_shard else "o partial")
            + f" dropped {dropped:.3e}); tokens identical")
        del one, blocks
    Path(f"{out}.r{rank}.json").write_text(json.dumps(rec))
    del got
    torch.cuda.empty_cache()
    dist.barrier()


def _uneven_serve_rank(rank: int, world: int, out: str) -> None:
    """One rank of phase 48's uneven-expert run (in the 8-rank spawn):
    qwen2-moe-a2.7b at full width, ``UNEVEN_LAYERS`` layer(s), on (1,
    world): its 60 experts in ``split_range``'s shares (8 on ranks 0-6, 4
    on rank 7), its vocabulary even; a ``BATCH`` x ``PROMPT`` prefill
    with its statistics and ``UNEVEN_GEN`` greedy decode steps, then on
    rank 0 the one-process program on the same parameters: statistics
    bit for bit, tokens identical."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.models import model
    from repro_torch.runtime import sharding, steps

    dev = torch.device("cuda")
    g = mesh.mesh_groups(1, world)
    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=UNEVEN_LAYERS)
    pol = QuantPolicy.w8a8g8(backend="fused")
    prompt = _prompt(cfg, BATCH, PROMPT, dev)
    quant = model.init_quant_state(cfg, pol, device=dev)

    def serve(params, group) -> dict:
        prefill = steps.make_prefill_step(cfg, pol,
                                          cache_len=PROMPT + UNEVEN_GEN,
                                          model_group=group,
                                          return_stats=True)
        decode = steps.make_decode_step(cfg, pol, model_group=group)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, stats = prefill(params, quant, {"tokens": prompt})
        torch.cuda.synchronize()
        res = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
               "stats": _host_tree(stats), "logits": [logits.float().cpu()]}
        toks = [logits.argmax(-1)[:, None]]
        t0 = time.perf_counter()
        for i in range(UNEVEN_GEN):
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int64,
                             device=dev)
            lg, caches = decode(params, quant, {"token": toks[-1],
                                                "pos": pos}, caches)
            res["logits"].append(lg.float().cpu())
            toks.append(lg.argmax(-1)[:, None])
        torch.cuda.synchronize()
        res.update(decode_ms=(time.perf_counter() - t0) * 1e3,
                   tokens=torch.cat(toks, dim=1).cpu(),
                   launches=ops.launch_counts(),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        return res

    full = model.init_params(cfg, seed=0, device=dev)
    params = sharding.shard_params(full, g.coords, g.sizes)
    del full
    torch.cuda.empty_cache()
    got = serve(params, g.model)
    rec = {"rank": rank, "experts": int(params["decoder"]["layers"][0]["moe"]
                                        ["w_up"].shape[0]),
           "vocab_rows": int(params["embed"].shape[0]),
           **{k: got[k] for k in ("launches", "prefill_ms", "decode_ms",
                                  "peak_gib")}}
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        one = serve(model.init_params(cfg, seed=0, device=dev), None)
        torch.cuda.empty_cache()
        bad = [p for p, t in one["stats"].items()
               if not torch.equal(got["stats"][p], t)]
        if bad:
            raise AssertionError(f"uneven serve: {len(bad)} prefill "
                                 f"statistics leaves differ from one "
                                 f"process's, e.g. {bad[:3]}")
        if not torch.equal(got["tokens"], one["tokens"]):
            raise AssertionError("uneven serve: greedy tokens differ from "
                                 "one process's")
        rec.update(stat_leaves=len(one["stats"]),
                   logits_rel_l2=max(_rel_l2(a, b) for a, b in zip(
                       got["logits"], one["logits"])),
                   single_prefill_ms=one["prefill_ms"],
                   single_decode_ms=one["decode_ms"],
                   single_peak_gib=one["peak_gib"],
                   tokens=got["tokens"].tolist())
        del one
    Path(f"{out}.r{rank}.json").write_text(json.dumps(rec))
    del got
    torch.cuda.empty_cache()
    dist.barrier()


def _seq_pad_rank(rank: int, world: int, phases: tuple, out: str) -> None:
    """One rank of phases 47-48 and 50, one spawn: phase 47's train step
    on the sequence-parallel core, then phase 48's padded serve run
    (:func:`_pad_serve_rank`) and its 1 x 8192 train step, then phase
    50's serve run and phase 47's train step under ``seq_shard``; rank 0
    notes the wall clock where phases 47 and 48 ended."""
    if 47 in phases:
        _tp_train_rank(rank, world, 1, world, SEQ_ARCH, False, SEQ_LAYERS,
                       BATCH, PROMPT, f"{out}.seq", True)
    if rank == 0:
        Path(f"{out}.mark.json").write_text(json.dumps(time.time()))
    if 48 in phases:
        _pad_serve_rank(rank, world, f"{out}.serve")
        _tp_train_rank(rank, world, 1, world, SEQ_ARCH, False, PAD_LAYERS, 1,
                       PAD_TRAIN_SEQ, f"{out}.train", True)
        _uneven_serve_rank(rank, world, f"{out}.uneven")
    if rank == 0:
        Path(f"{out}.mark48.json").write_text(json.dumps(time.time()))
    if 50 in phases:
        _pad_serve_rank(rank, world, f"{out}.sp_serve", True)
        _tp_train_rank(rank, world, 1, world, SEQ_ARCH, False, SEQ_LAYERS,
                       BATCH, PROMPT, f"{out}.sp_train", True, True)


def _train_log(tag: str, what: str, r0: dict, recs: list) -> None:
    log(tag, f"{what}: {r0['act_leaves']} activation leaves bit for bit, "
             f"{r0['grad_leaves']} gradient leaves within "
             f"{r0['grad_leaf_rel']:.3e} (floor "
             f"{r0['grad_leaf_floor']:.3e}, bar "
             f"{r0['grad_leaf_bar']:.3e}), loss "
             f"{r0['loss_rel']:.2e} rel, gradients: the worst "
             f"against its bar {r0['grad_rel_l2']:.3e} rel L2 (bar "
             f"{r0['grad_bar']:.3e}; the worst floor "
             f"{r0['floor_rel_l2']:.3e}, {r0['grad_fixed_bars']} "
             f"tensors at 2**-7; doubled {r0['grad_rel_doubled']:.2f}"
             f"x, halved {r0['grad_rel_halved']:.2f}x a tensor's "
             f"bar, refused"
             + (f"; the padded tensors with the last rank's share "
                f"dropped, (x bar, rel L2, tensor) "
                f"{r0['grad_dropped_by_bar'][:6]}, refused"
                if "grad_dropped_by_bar" in r0 else "")
             + f"); first step "
             f"{r0['step_ms']:.1f} ms (collectives "
             f"{r0['collectives']['ms']:.1f} ms in "
             f"{r0['collectives']['calls']} calls), warm "
             f"{r0['warm_step_ms']:.1f} ms vs "
             f"{r0['single_step_ms']:.1f} / "
             f"{r0['single_warm_ms']:.1f} ms one process; peak "
             f"{max(r['peak_gib'] for r in recs):.2f} GiB a rank; "
             f"launches {r0['launches']}")


def _train_recs(out: str, layout: str, what: str) -> list:
    """A sharded train step's rank records, each rank on ``layout`` and
    every kernel of the step launched on rank 0."""
    recs = [json.loads(Path(f"{out}.r{r}.json").read_text())
            for r in range(SEQ_SIZE)]
    for r in recs:
        if r["layouts"] != [layout]:
            raise AssertionError(f"{what}: rank {r['rank']} ran the "
                                 f"layouts {r['layouts']}")
    for k in TP_KERNELS + ("stochastic_quantize",):
        if not recs[0]["launches"][k]:
            raise AssertionError(f"{what}: {k} never launched: "
                                 f"{recs[0]['launches']}")
    return recs


def seq_pad_spawn(phases: tuple) -> tuple:
    """Phases 47-48's ranks (:func:`seq_pad_checks`): one spawn of 8
    gloo ranks on the card; returns its start and end (wall clock)."""
    from repro_torch.launch import mesh

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    mesh.spawn_ranks(_seq_pad_rank, SEQ_SIZE, OUT_DIR / "store_seq",
                     backend="gloo",
                     args=(tuple(phases), str(OUT_DIR / "seq_pad")))
    return t0, time.time()


def seq_pad_checks(phases: tuple, t0: float, t1: float, records, results,
                   clock) -> None:
    """Phases 47-48's checks on their ranks' records (:func:`seq_pad_spawn`,
    one spawn of 8 gloo ranks on the card, from ``t0`` to ``t1``).

    47: starcoder2-3b's train step at full width, 2 layers, 4 x 1024 on
    (1, 8): KV 2 and G 12 do not divide 8, so every layer runs the
    sequence-parallel core (each rank its 128 rows through the offset
    kernel), held against the one-process step with phase 45's bars
    (doubled or halved gradients refused).

    48: the same model on padded heads (G 12 over 8: ranks 0-5 two
    heads, 6-7 none): the 4 x 1024 prefill on the int8 core into a
    1032-slot cache, 129 slots a rank, held bit for bit against one
    process (statistics, each rank's cache slots, the logits); 8 greedy
    decode steps over the length-sharded cache (tokens identical, logits
    within the larger of 1e-5 and 4 x the one-process decode's distance
    from itself with the sums over L in 8 blocks; the same step with
    ``wo`` doubled, and with rank 5's ``o`` partial dropped, refused);
    then one 1 x 8192 train step past the 4096 window (the sliding int8
    core on each rank's heads) with phase 45's bars, its floor the step
    with its dx products' contraction in 8 blocks, and the padded
    tensors with rank 5's share dropped refused.  A rank with no heads
    launches no attention kernel."""
    out = OUT_DIR / "seq_pad"
    mark = json.loads(Path(f"{out}.mark.json").read_text())
    mark48 = json.loads(Path(f"{out}.mark48.json").read_text())
    if 47 in phases:
        clock.add(47, "seq train", mark - t0)
        recs = _train_recs(f"{out}.seq", "seq", "seq train")
        results["seq_train"] = recs
        _train_log("seq-train", f"{SEQ_ARCH} {SEQ_LAYERS} layers on (1, "
                                f"{SEQ_SIZE}) (the seq layout), {BATCH} x "
                                f"{PROMPT}", recs[0], recs)
        for r in records:
            r["seq_train_launches"] = recs[0]["launches"].get(r["name"], 0)
    if 50 in phases:
        seq_shard_checks(str(out), mark48, t1, records, results, clock)
    if 48 not in phases:
        return
    clock.add(48, "padded", mark48 - mark)
    serve = [json.loads(Path(f"{out}.serve.r{r}.json").read_text())
             for r in range(SEQ_SIZE)]
    for r in serve:
        if set(r["layouts"]) != {"g_pad"}:
            raise AssertionError(f"padded serve: rank {r['rank']} ran the "
                                 f"layouts {r['layouts']}")
        ran = r["launches"]["int8_attention"]
        if bool(ran) != bool(r["heads"][1]):
            raise AssertionError(f"padded serve: rank {r['rank']} holds "
                                 f"{r['heads']} heads and launched "
                                 f"int8_attention {ran} times")
    s0 = serve[0]
    log("padded", f"serve launches on rank 0 (the prefill and {PAD_GEN} "
                  f"decode steps): {s0['launches']}")
    for k in TP_KERNELS:
        if not s0["launches"][k]:
            raise AssertionError(f"padded serve: {k} never launched: "
                                 f"{s0['launches']}")
    train = _train_recs(f"{out}.train", "g_pad", "padded train")
    results["padded"] = {"serve": serve, "train": train}
    log("padded", f"{SEQ_ARCH} {PAD_LAYERS} layers on (1, {SEQ_SIZE}), "
                  f"layouts {s0['layouts']}; (KV, G) heads a rank "
                  f"{[r['heads'] for r in serve]}; cache slots a rank "
                  f"{s0['slots']} of {PROMPT + PAD_GEN}; {s0['stat_leaves']} "
                  f"prefill statistics leaves and every rank's cache slots "
                  f"bit for bit; prefill logits {s0['prefill_rel_l2']:.3e} "
                  f"rel L2 (identical: {s0['prefill_identical']}); "
                  f"{PAD_GEN} decode steps: tokens identical, logits "
                  f"{s0['decode_rel_l2']:.3e} rel L2 at worst "
                  f"({s0['decode_identical']} of {PAD_GEN} identical; "
                  f"floor {s0['decode_floor']:.3e}, bar "
                  f"{s0['decode_bar']:.3e}; wo doubled "
                  f"{s0['doubled_rel_l2']:.3e}, rank {s0['dropped_rank']}'s "
                  f"o partial dropped {s0['dropped_rel_l2']:.3e}, both "
                  f"refused)")
    for r in serve:
        log("padded", f"rank {r['rank']}: {r['heads']} heads, cache "
                      f"{r['cache_bytes'] / 2 ** 20:.2f} MiB, prefill "
                      f"{r['prefill_ms']:.1f} ms, {PAD_GEN} decode steps "
                      f"{r['decode_ms']:.1f} ms (gloo collectives, host "
                      f"copies, claimed as nothing: "
                      f"{r['collectives']['ms']:.1f} ms in "
                      f"{r['collectives']['calls']} calls), peak "
                      f"{r['peak_gib']:.2f} GiB; int8_attention launches "
                      f"{r['launches']['int8_attention']}")
    log("padded", f"one process: prefill {s0['single_prefill_ms']:.1f} ms, "
                  f"decode {s0['single_decode_ms']:.1f} ms, peak "
                  f"{s0['single_peak_gib']:.2f} GiB, cache "
                  f"{s0['single_cache_bytes'] / 2 ** 20:.2f} MiB")
    _train_log("padded", f"{SEQ_ARCH} {PAD_LAYERS} layers, train 1 x "
                         f"{PAD_TRAIN_SEQ} on (1, {SEQ_SIZE}) (g_pad)",
               train[0], train)
    for r in records:
        r["pad_serve_launches"] = s0["launches"].get(r["name"], 0)
        r["pad_train_launches"] = train[0]["launches"].get(r["name"], 0)
    uneven = [json.loads(Path(f"{out}.uneven.r{r}.json").read_text())
              for r in range(SEQ_SIZE)]
    u0 = uneven[0]
    results["uneven"] = uneven
    experts = [r["experts"] for r in uneven]
    from repro_torch.runtime import sharding
    if experts != [sharding.split_range(60, SEQ_SIZE, r)[1]
                   for r in range(SEQ_SIZE)]:
        raise AssertionError(f"uneven serve: experts a rank {experts}")
    for k in SERVE_KERNELS:
        if not u0["launches"][k]:
            raise AssertionError(f"uneven serve: {k} never launched: "
                                 f"{u0['launches']}")
    log("uneven", f"{MOE_ARCH} full width, {UNEVEN_LAYERS} layer on (1, "
                  f"{SEQ_SIZE}): experts a rank {experts}, vocabulary rows "
                  f"a rank {[r['vocab_rows'] for r in uneven]}; {BATCH} x "
                  f"{PROMPT} prefill and {UNEVEN_GEN} greedy decode steps: "
                  f"{u0['stat_leaves']} prefill statistics leaves bit for "
                  f"bit, tokens identical, logits {u0['logits_rel_l2']:.3e} "
                  f"rel L2 at worst; int8_matmul_fp launches by rank "
                  f"{[r['launches']['int8_matmul_fp'] for r in uneven]}; "
                  f"prefill {u0['prefill_ms']:.1f} ms, decode "
                  f"{u0['decode_ms']:.1f} ms on rank 0 (gloo host copies "
                  f"included) vs {u0['single_prefill_ms']:.1f} / "
                  f"{u0['single_decode_ms']:.1f} ms one process; peak "
                  f"{max(r['peak_gib'] for r in uneven):.2f} GiB a rank vs "
                  f"{u0['single_peak_gib']:.2f} GiB")
    for r in records:
        r["uneven_serve_launches"] = u0["launches"].get(r["name"], 0)


def seq_shard_checks(out: str, t0: float, t1: float, records, results,
                     clock) -> None:
    """Phase 50's checks (in phases 47-48's spawn, from ``t0`` to
    ``t1``): starcoder2-3b at full width, 2 layers, on (1, 8) under
    ``seq_shard`` (the residual stream each rank's 128 rows, or decode's
    one row on rank 0): phase 48's serve run (padded heads, the
    length-sharded cache; the prefill statistics, cache slots and
    logits bit for bit, 8 decode steps within phase 48's bars, rank 0's
    share of every reduce-scatter dropped refused) and phase 47's 4 x
    1024 train step with phase 45's bars; each rank's peak GiB and gloo
    ms beside phase 47's step without ``seq_shard``."""
    clock.add(50, "seq shard", t1 - t0)
    serve = [json.loads(Path(f"{out}.sp_serve.r{r}.json").read_text())
             for r in range(SEQ_SIZE)]
    for r in serve:
        if set(r["layouts"]) != {"g_pad"}:
            raise AssertionError(f"seq-shard serve: rank {r['rank']} ran "
                                 f"the layouts {r['layouts']}")
    s0 = serve[0]
    for k in TP_KERNELS:
        if not s0["launches"][k]:
            raise AssertionError(f"seq-shard serve: {k} never launched: "
                                 f"{s0['launches']}")
    train = _train_recs(f"{out}.sp_train", "seq", "seq-shard train")
    results["seq_shard"] = {"serve": serve, "train": train}
    log("seq-shard", f"{SEQ_ARCH} {PAD_LAYERS} layers on (1, {SEQ_SIZE}) "
                     f"with the residual stream a rank's rows: "
                     f"{s0['stat_leaves']} prefill statistics leaves and "
                     f"every rank's cache slots bit for bit; prefill "
                     f"logits identical: {s0['prefill_identical']}; "
                     f"{PAD_GEN} decode steps: tokens identical, logits "
                     f"{s0['decode_rel_l2']:.3e} rel L2 at worst "
                     f"({s0['decode_identical']} of {PAD_GEN} identical; "
                     f"bar {s0['decode_bar']:.3e}; wo doubled "
                     f"{s0['doubled_rel_l2']:.3e}, rank 0's reduce-scatter "
                     f"share dropped {s0['dropped_rel_l2']:.3e}, both "
                     f"refused); launches on rank 0 {s0['launches']}")
    for r in serve:
        log("seq-shard", f"serve rank {r['rank']}: prefill "
                         f"{r['prefill_ms']:.1f} ms, {PAD_GEN} decode steps "
                         f"{r['decode_ms']:.1f} ms (gloo, host copies: "
                         f"{r['collectives']['ms']:.1f} ms in "
                         f"{r['collectives']['calls']} calls), peak "
                         f"{r['peak_gib']:.2f} GiB")
    _train_log("seq-shard", f"{SEQ_ARCH} {SEQ_LAYERS} layers, train "
                            f"{BATCH} x {PROMPT} on (1, {SEQ_SIZE}) (seq "
                            f"layout, seq_shard)", train[0], train)
    plain = results.get("seq_train")
    for r in train:
        p = plain[r["rank"]] if plain else None
        log("seq-shard", f"train rank {r['rank']}: peak "
                         f"{r['peak_gib']:.3f} GiB with seq_shard"
                         + (f", {p['peak_gib']:.3f} without (phase 47)"
                            if p else "")
                         + f"; gloo {r['collectives']['ms']:.1f} ms in "
                         f"{r['collectives']['calls']} calls"
                         + (f" ({p['collectives']['ms']:.1f} ms in "
                            f"{p['collectives']['calls']} without)"
                            if p else ""))
    for r in records:
        r["sp_serve_launches"] = s0["launches"].get(r["name"], 0)
        r["sp_train_launches"] = train[0]["launches"].get(r["name"], 0)


def _cell_window(cfg) -> int:
    """The window a decode cell prefills: the sliding or local ring's
    length; rwkv's state has no ring (``RWKV_CELL_WINDOW`` tokens)."""
    return cfg.sliding_window or cfg.local_window or RWKV_CELL_WINDOW


def rebase_caches(caches: dict, delta: int, theta) -> None:
    """Re-base a prefilled cache by ``delta`` positions, in place: every
    ring's ``pos`` entries shifted by ``delta``, its K rotated by
    ``delta`` with the port's ``apply_rope`` (RoPE is relative, so this
    stands in for a prompt that really reached there), and the slots
    rolled by ``delta % L`` so each position sits at its slot ``pos %
    L``.  Recurrent states (RG-LRU, WKV) carry no position."""
    from repro_torch.models.layers import apply_rope

    for layer in caches["decoder"]["layers"]:
        kv = layer.get("kv")
        if kv is None:
            continue
        b, length = kv["pos"].shape
        roll = delta % length
        shift = torch.full((b, length), delta, dtype=torch.int32,
                           device=kv["pos"].device)
        pos = torch.where(kv["pos"] >= 0, kv["pos"] + delta, kv["pos"])
        kv["pos"] = pos.roll(roll, 1)
        kv["k"] = apply_rope(kv["k"], shift, theta).roll(roll, 1)
        kv["v"] = kv["v"].roll(roll, 1)


def _map_caches(caches: dict, fn) -> dict:
    """A decoder cache with ``fn`` applied to every tensor."""
    return {"decoder": {"layers": [
        {k: ({kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else fn(v)) for k, v in layer.items()}
        for layer in caches["decoder"]["layers"]]}}


def _tile_caches(caches: dict, reps: int) -> dict:
    """Each batch row of the cache repeated ``reps`` times (rows r, r + B,
    r + 2B, ... share row r's cache; an int8 cache's scales stay)."""
    return _map_caches(caches, lambda t: t if t.dim() == 1 else t.repeat(
        (reps,) + (1,) * (t.dim() - 1)))


def _decode_run(step, params, quant, caches, first, pos0: int, steps: int,
                forced=None):
    """``steps`` decode steps from ``caches`` (updated in place) at
    positions ``pos0..``: greedy from ``first``, or fed ``forced`` (a list
    of ``[B, 1]`` tokens).  Returns (logits per step, the tokens fed after
    ``first``, ms per step: host clock around each synchronized step)."""
    b = first.shape[0]
    tok, logits, fed, ms = first, [], [], []
    for i in range(steps):
        batch = {"token": tok, "pos": torch.full(
            (b,), pos0 + i, dtype=torch.int32, device=first.device)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = step(params, quant, batch, caches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg.float())
        greedy = lg.argmax(-1, keepdim=True).to(torch.int32)
        tok = forced[i] if forced is not None else greedy
        fed.append(greedy)
    return logits, fed, ms


def _cell(shape_name: str, arch: str, dev, records, results) -> dict:
    """One decode cell at full width and depth, hindsight W8A8G8: prefill
    a window through ``make_prefill_step`` (cache_len the shape's
    seq_len), re-base the cache to end at ``seq_len - 2``, then
    ``CELL_STEPS`` decode steps through ``make_decode_step`` from position
    ``seq_len - 1`` (past the ring's wrap) on inputs shaped by
    ``input_specs``.  The simulated backend runs first, greedy, on a copy
    of the cache; the fused backend is fed its tokens, with the launch
    counters zeroed just before and read just after: its ms a step and
    peak GiB (the parameters, the cache and one step) are the cell's.
    Held each step: logits rel L2 <= 1e-2 and max |d| <= 0.1 (phase 6's
    tolerance), the fused greedy token the simulated one or a near-tie
    (the fused top-2 margin within 2 max |d|).  Reported: the re-basing
    gap, the first step's logits against a decode at the window's own
    next position on the un-rebased cache; one more fused step profiled
    (device time by family, the idle share)."""
    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.runtime import steps

    cfg, shape = configs.get(arch), configs.SHAPES[shape_name]
    ok, why = cfg.supports(shape_name)
    if not ok:
        raise AssertionError(f"{arch} refuses {shape_name}: {why}")
    spec = configs.input_specs(cfg, shape)
    b, last = spec["token"].shape[0], shape.seq_len - 1
    w = _cell_window(cfg)
    rows = min(b, CELL_PREFILL_ROWS)
    tag = f"cell {shape_name} {arch}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy = QuantPolicy.w8a8g8(backend="fused")
    params = model.init_params(cfg, seed=0, device=dev)
    quant = model.init_quant_state(cfg, device=dev)
    prefill = steps.make_prefill_step(cfg, policy, cache_len=shape.seq_len)
    decode = steps.make_decode_step(cfg, policy)
    prompt = _prompt(cfg, rows, w, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, caches = prefill(params, quant, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    g = torch.Generator(device=dev).manual_seed(7)
    first = torch.randint(0, cfg.vocab, tuple(spec["token"].shape),
                          generator=g, device=dev, dtype=spec["token"].dtype)
    prefill_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the re-basing gap: the un-rebased cache decoded at its own next
    # position w, against the re-based one's first step (rows 0..rows-1)
    plain, _, _ = _decode_run(decode, params, quant,
                              _map_caches(caches, torch.clone), first[:rows],
                              w, 1)
    rebase_caches(caches, last - w, cfg.rope_theta)
    if b > rows:
        caches = _tile_caches(caches, b // rows)
    # the simulated backend first, greedy, on a copy of the same cache
    sim = steps.make_decode_step(cfg, policy.with_backend("simulated"))
    sim_caches = _map_caches(caches, torch.clone)
    ops.reset_launch_counts()
    s_logits, s_tokens, _ = _decode_run(sim, params, quant, sim_caches,
                                        first, last, CELL_STEPS)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"{tag}: the simulated backend launched a "
                             f"kernel")
    del sim_caches
    torch.cuda.empty_cache()
    # then the fused path, fed the same tokens
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits, greedy, ms = _decode_run(decode, params, quant, caches, first,
                                     last, CELL_STEPS, forced=s_tokens)
    counts, tiles = ops.launch_counts(), ops.tile_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(counts[k] > 0 for k in DECODE_KERNELS):
        raise AssertionError(f"{tag}: a kernel of the decode path never "
                             f"launched: {counts}")
    want_tile = mm_row_tile(cfg, b)
    if tiles[("int8_matmul_fp", want_tile)] != counts["int8_matmul_fp"]:
        raise AssertionError(f"{tag}: M = {b} did not run every product on "
                             f"the {want_tile}-row tile: {tiles}")
    for lg in logits:
        if lg.shape != (b, cfg.vocab) or not torch.isfinite(lg).all():
            raise AssertionError(f"{tag}: logits {tuple(lg.shape)} not "
                                 f"finite or not [{b}, {cfg.vocab}]")
    # the ring wrapped: slot (last + 1) % L holds position last + 1
    for layer in caches["decoder"]["layers"]:
        kv = layer.get("kv")
        if kv is not None:
            slot = (last + 1) % kv["pos"].shape[1]
            if not bool((kv["pos"][:, slot] == last + 1).all()):
                raise AssertionError(f"{tag}: the ring did not wrap")
    # one more fused step under torch.profiler: device time by family and
    # the card's idle share of the step

    def one_step():
        lg, _ = decode(params, quant, {"token": greedy[-1], "pos": torch.full(
            (b,), last + CELL_STEPS, dtype=torch.int32, device=dev)}, caches)
        float(lg[0, 0])
    prof = profile_device(one_step, f"cells {shape_name}/{arch}")
    gap = ((logits[0][:rows] - plain[0]).norm() / plain[0].norm()).item()
    worst_rel, worst_abs, ties = 0.0, 0.0, []
    for i, (a, c) in enumerate(zip(logits, s_logits)):
        d = (a - c).abs().max().item()
        rel = ((a - c).norm() / c.norm()).item()
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, d)
        if not (rel <= 1e-2 and d <= 0.1 and math.isfinite(rel)):
            raise AssertionError(f"{tag} step {i}: fused vs simulated rel "
                                 f"L2 {rel:.3e}, max |d| {d:.3e}")
        differ = (greedy[i] != s_tokens[i]).flatten().nonzero().flatten()
        if len(differ):
            top = a[differ].topk(2, dim=-1).values
            margin = (top[:, 0] - top[:, 1]).max().item()
            if margin > 2 * d:
                raise AssertionError(f"{tag} step {i}: greedy tokens differ "
                                     f"with top-2 margin {margin:.3e} > 2 "
                                     f"max |d| {d:.3e}")
            ties.append((i, len(differ)))
    del caches, params
    torch.cuda.empty_cache()
    steady = sum(ms[1:]) / len(ms[1:])
    rec = dict(arch=arch, shape=shape_name, batch=b, position=last,
               window=w, prefill_rows=rows, prefill_ms=prefill_ms,
               first_step_ms=ms[0], ms_per_step=steady, peak_gib=peak,
               prefill_peak_gib=prefill_peak,
               launches=counts, tile=want_tile, rel_l2=worst_rel,
               max_abs=worst_abs, near_ties=ties, rebase_gap_rel_l2=gap,
               profile=dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                            idle_share=prof["idle_share"],
                            families=prof["families"]),
               seconds=time.perf_counter() - t0)
    ring = ("no ring: the WKV state" if cfg.family == "rwkv" else
            f"the ring of {w} wraps at step 2")
    log("cells", f"{tag}: B {b} from position {last} ({CELL_STEPS} steps, "
                 f"{ring}): {steady:.2f} ms a "
                 f"decode step (first {ms[0]:.2f}), peak {peak:.2f} GiB "
                 f"(the prefill's {prefill_peak:.2f}); prefill of {rows} x "
                 f"{w} {prefill_ms:.1f} ms; every "
                 f"int8 product on the {want_tile}-row tile; fused vs "
                 f"simulated on the same cache: worst rel L2 "
                 f"{worst_rel:.3e}, max |d| {worst_abs:.3e}, greedy tokens "
                 + ("identical" if not ties else f"near-ties at {ties}")
                 + f"; re-basing gap (rel L2 against position {w}) "
                 f"{gap:.3e}; launches {counts}")
    for r in records:
        r.setdefault("cell_launches", {})[f"{shape_name}/{arch}"] = \
            counts[r["name"]]
    results.setdefault("tile_launches", {})[f"cell {shape_name}/{arch}"] = \
        {f"{k}:{bm}": n for (k, bm), n in tiles.items()}
    return rec


def mm_row_tile(cfg, m: int) -> int:
    """The row tile the tuner and the clamp give a decode product of ``m``
    rows against ``cfg``'s widths."""
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import tuning

    block = tuning.matmul_block(m, cfg.d_ff, cfg.d_model, dtype="uint8")
    return mm.row_tile(block[0], m)


def cells_phase(dev, records, results) -> None:
    """Phase 41: the shape matrix.  ``configs.cells()`` over the ten
    configs (earlier phases may have registered depth cuts beside them)
    admits long_500k for exactly the four sub-quadratic archs and refuses
    it for the six others with the reference's reason; then the five
    decode cells (``DECODE_CELLS``, one model on the card at a time)."""
    from repro_torch import configs

    archs = LONG_500K_ARCHS | LONG_500K_REFUSED
    cells = [c for c in configs.cells() if c.arch in archs]
    admitted = {c.arch for c in cells if c.shape == "long_500k"
                and c.runnable}
    refused = {c.arch: c.skip_reason for c in cells if not c.runnable}
    if admitted != LONG_500K_ARCHS or set(refused) != LONG_500K_REFUSED \
            or set(refused.values()) != {CELL_REFUSAL} \
            or len(cells) != len(archs) * len(configs.SHAPES) \
            or any(c.shape != "long_500k" for c in cells if not c.runnable):
        raise AssertionError(f"the shape matrix: admitted {admitted}, "
                             f"refused {refused}")
    log("cells", f"{len(cells)} cells; long_500k admitted for "
                 f"{sorted(admitted)}, refused for {sorted(refused)} "
                 f"({CELL_REFUSAL!r})")
    out = {"refused": sorted(refused)}
    for shape_name, arch in DECODE_CELLS:
        out[f"{shape_name}/{arch}"] = _cell(shape_name, arch, dev, records,
                                            results)
    results["cells"] = out


def _dryrun_cmd(out: Path, *extra) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", DRYRUN_ARCH, "--shape", "train_4k", "--out", str(out),
            "--device", "cuda", *extra]


class DryrunRuns:
    """Phase 49's subprocesses, started after phase 3 (the dry run needs
    no kernel, only host time and the card's device type): the train
    cell on both production meshes (``DRYRUN_LAYERS``), again on 16 x 16
    with ``--seq-shard``, and phase 40's configuration on ``(2, 1)``,
    each with its own fake process group.
    A timer kills what still runs ``DRYRUN_TIMEOUT`` seconds after the
    start; :meth:`stop` kills what still runs (at exit too)."""

    OUT = OUT_DIR / "dryrun"

    def __init__(self):
        import atexit
        import threading
        shutil.rmtree(self.OUT, ignore_errors=True)
        cut = ["--layers", str(DRYRUN_LAYERS)]
        runs = {"16x16": _dryrun_cmd(self.OUT, *cut),
                "2x16x16": _dryrun_cmd(self.OUT, *cut, "--multipod"),
                "16x16-seq": _dryrun_cmd(self.OUT, *cut, "--seq-shard"),
                "phase40": _dryrun_cmd(self.OUT, "--mesh", "2x1", "--layers",
                                       str(DP_LAYERS), "--batch", str(BATCH),
                                       "--seq", str(PROMPT), "--grad-accum",
                                       "1", "--tag", "phase40")}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        self.procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT)
                      for k, cmd in runs.items()}
        self.expired: list = []
        self.timer = threading.Timer(DRYRUN_TIMEOUT, self._expire)
        self.timer.daemon = True
        self.timer.start()
        atexit.register(self.stop)

    def _expire(self) -> None:
        self.expired = [k for k, p in self.procs.items() if p.poll() is None]
        self.stop()

    def wait(self) -> None:
        """Raises if a run failed or the timer killed it."""
        try:
            logs = {k: p.communicate()[0] for k, p in self.procs.items()}
        finally:
            self.stop()
        if self.expired:
            raise AssertionError(f"dryrun {self.expired}: killed "
                                 f"{DRYRUN_TIMEOUT} s after the start")
        for k, p in self.procs.items():
            if p.returncode != 0:
                raise AssertionError(f"dryrun {k}: exit {p.returncode}\n"
                                     f"{logs[k][-3000:]}")

    def stop(self) -> None:
        self.timer.cancel()
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def dryrun_phase(runs: DryrunRuns, dp: dict) -> dict:
    """Phase 49: the dry run's records (:class:`DryrunRuns`): status ok
    on both meshes, rank 0's counts printed, the ``--seq-shard`` trace's
    per-device bytes beside the unsharded trace's (below them, with more
    reduce-scatters: the row-parallel exits), and phase 40's
    configuration's stored parameters and moments equal to phase 40's
    rank 0's bytes on the card."""
    from repro_torch import configs
    runs.wait()
    recs = {}
    for k, name in (("16x16", "16_16"), ("2x16x16", "2_16_16"),
                    ("16x16-seq", "16_16__seq_shard"),
                    ("phase40", "2_1__phase40")):
        rec = json.loads((runs.OUT / f"{DRYRUN_ARCH}__train_4k__{name}.json")
                         .read_text())
        if rec["status"] != "ok" or rec["device"] != "cuda":
            raise AssertionError(f"dryrun {k}: {rec['status']} on "
                                 f"{rec['device']}")
        recs[k] = rec
    r = recs["16x16"]
    log("dryrun", f"{DRYRUN_ARCH} train_4k cut to {r['layers']} of "
                  f"{configs.get(DRYRUN_ARCH).n_layers} layers (the only "
                  f"cut: the cell's global batch {r['global_batch']} x "
                  f"{r['seq_len']}, its microbatches); cuda fake tensors, "
                  f"rank 0; the three runs started after phase 3, beside "
                  f"phases 4-48 (trace seconds below; phase 40's "
                  f"configuration {recs['phase40']['trace_s']} s)")
    for k in ("16x16", "2x16x16", "16x16-seq"):
        r = recs[k]
        coll = ", ".join(f"{kind} {v['ops']} ops {v['operand_bytes']} B"
                         for kind, v in r["collectives"].items()
                         if isinstance(v, dict) and v["ops"])
        log("dryrun", f"{k} ({r['world']} ranks): {r['cost']['flops']:.6e} "
                      f"FLOPs, {r['cost']['bytes_accessed']:.6e} bytes, "
                      f"{r['n_ops']} ops; collectives {coll}; "
                      f"per_device_bytes_est "
                      f"{r['memory']['per_device_bytes_est']} "
                      f"({r['memory']['per_device_bytes_est'] / 2 ** 30:.2f} "
                      f"GiB), trace {r['trace_s']} s")
    plain, sp = recs["16x16"], recs["16x16-seq"]
    est = [r["memory"]["per_device_bytes_est"] for r in (sp, plain)]
    rs = [r["collectives"]["reduce-scatter"]["ops"] for r in (sp, plain)]
    log("dryrun", f"16x16 with --seq-shard: per_device_bytes_est {est[0]} "
                  f"({est[0] / 2 ** 30:.2f} GiB) against {est[1]} "
                  f"({est[1] / 2 ** 30:.2f} GiB) without; reduce-scatter "
                  f"ops {rs[0]} against {rs[1]}")
    if not sp["seq_shard"] or est[0] >= est[1] or rs[0] <= rs[1]:
        raise AssertionError(f"dryrun --seq-shard: seq_shard "
                             f"{sp['seq_shard']}, per-device bytes {est}, "
                             f"reduce-scatter ops {rs}")
    want = dp["zero3"]["off"]["stored_bytes"]
    got = recs["phase40"]["memory"]["stored_state_bytes"]
    log("dryrun", f"phase 40's configuration on (2, 1): stored parameters "
                  f"and moments {got} B (dry run) against {want} B (phase "
                  f"40's rank 0 on the card)")
    if got != want:
        raise AssertionError(f"dryrun: stored_state_bytes {got} != phase "
                             f"40's {want}")
    return {"records": recs, "phase40_stored_bytes": want}


def parse_phases(spec: str) -> set:
    """``"1-3,9"`` -> ``{1, 2, 3, 9}``; phase 1 always, 4 with 5, 6 or 43,
    17 with 18, 20 with 21 or 22, 26 with 27, 29 with 30, 32 with 33, 35
    with 36, 40 with 49."""
    phases = {1}
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        phases.update(range(int(lo), int(hi or lo) + 1))
    if not phases <= set(range(1, N_PHASES + 1)):
        raise argparse.ArgumentTypeError(
            f"phases are 1-{N_PHASES}, got {spec!r}")
    if phases & {5, 6}:
        phases.add(4)
    if 18 in phases:
        phases.add(17)
    if phases & {21, 22}:
        phases.add(20)
    if 27 in phases:
        phases.add(26)
    if 30 in phases:
        phases.add(29)
    if 33 in phases:
        phases.add(32)
    if 36 in phases:
        phases.add(35)
    if 43 in phases:
        phases.add(4)
    if 49 in phases:
        phases.add(40)
    return phases


def imma_count(lib: Path):
    """The count of IMMA (integer tensor-core MMA) instructions in a built
    library's SASS, or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return sum(1 for ln in sass.splitlines() if "IMMA" in ln)


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="",
                    help="also write the detailed results as JSON here")
    ap.add_argument("--phases", type=parse_phases, default=f"1-{N_PHASES}",
                    help="phases to run, e.g. 1-3 or 1,2,3,9 (default all)")
    args = ap.parse_args(argv)
    run_phase = args.phases.__contains__
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from repro_torch import configs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    results: dict = {}

    # 1. device
    clock = PhaseClock()
    clock.start(1, "device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    log("device", f"{kind} x{count}; torch {torch.__version__} "
                  f"cuda {torch.version.cuda}")
    results["device"] = dict(kind=kind, count=count, smi=smi)
    clock.stop()

    def cnn_phases(which: tuple) -> None:
        # 10. the CNN train path, MobileNetV2-tiny at full width; 11. CNN
        # parity: fused vs simulated, TF32 on globally; 13. its telemetry
        for n, name, key, fn in (
                (10, "cnn train", "cnn_train", lambda: cnn_train_phase(dev)),
                (11, "cnn parity", "cnn_parity",
                 lambda: cnn_parity_phase(dev)),
                (13, "tele cnn", "tele_cnn",
                 lambda: tele_cnn_phase(dev, OUT_DIR))):
            if n in which:
                with clock(n, name):
                    results[key] = fn()
                torch.cuda.empty_cache()

    # 2. build.  The attention source's nvcc takes most of it: the CNN
    # phases (10, 11, 13), which launch no attention kernel, run beside
    # it once the other sources are built.
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    early = tuple(n for n in (10, 11, 13) if run_phase(n))
    if run_phase(2):
        clock.start(2, "build")
        t0 = time.perf_counter()
        attn = Beside(f"phases {', '.join(map(str, early))} beside the "
                      f"attention source's nvcc", build.build_all,
                      ("int8_attention",)) if early else None
        results["build"] = {}

        def note(built: dict) -> None:
            for name, (path, secs, out) in built.items():
                regs = [ln.strip() for ln in out.splitlines()
                        if "registers" in ln or "spill" in ln]
                log("build", f"{name}: {secs:.1f} s; "
                             f"{' | '.join(regs) or out}")
                imma = imma_count(path)
                log("build", f"{name}: "
                             + ("no cuobjdump in the toolkit" if imma is None
                                else f"{imma} IMMA instructions in the SASS"))
                results["build"][name] = dict(seconds=secs, ptxas=regs,
                                              imma=imma)
                if name in TENSOR_CORE_SOURCES and imma == 0:
                    raise AssertionError(f"{name}: no IMMA instruction in "
                                         f"the SASS: its products are not "
                                         f"on the tensor cores")

        note(build.build_all(tuple(n for n in build.SOURCES
                                   if attn is None or n != "int8_attention")))
        if attn is not None:
            clock.stop()
            try:
                cnn_phases(early)
            finally:
                clock.start(2, "build")
                built = attn.join()
            note(built)
        log("build", f"all kernels built in {time.perf_counter() - t0:.1f} s"
                     + (f" (phases {', '.join(map(str, early))} beside the "
                        f"attention source's nvcc)" if early else ""))
        clock.stop()
    else:
        early = ()

    # 3. kernels at the slice's shapes
    cfg = configs.get("starcoder2-3b")
    mcfg = configs.get(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []
    if run_phase(3):
        clock.start(3, "kernels")
        records = [check_fused_quantize(dev, gen, cfg),
                   check_stochastic_quantize(dev, gen, cfg),
                   check_int8_transpose(dev, gen, cfg),
                   check_int8_matmul(dev, gen, cfg),
                   check_int8_matmul_fused(dev, gen, cfg),
                   check_attention(dev, gen, cfg),
                   check_int8_matmul_int32(dev, gen, cfg),
                   check_int8_matmul_epilogue(dev, gen, cfg)]
        results["conv"] = check_int8_conv(dev, gen)
        # the MoE family's new operand regimes: the experts on the int8
        # matmul's batch dimension, and MHA attention (G = 1)
        by_name = {r["name"]: r for r in records}
        by_name["int8_matmul_fp"]["moe"] = check_moe_matmul(dev, gen, mcfg)
        keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")
        moe_attn = check_attention(dev, gen, mcfg)
        by_name["int8_attention"]["moe"] = {k: moe_attn[k] for k in keys}
        # head dims above 128: nemotron-4-340b's prefill layout (hd 192,
        # G = 12, batch 1) and hd 256 at G = 8; the hybrid's MQA (G = 16)
        # at hd 256 under its local window, at 4 x 1024 (nothing masked
        # beyond causal) and 1 x 8192 (~17 kv blocks a q block); the
        # enc-dec family's bidir and cross cores at hd 64 (1056 frames:
        # a half-padded last kv tile of 64) and its encoder at 1 x 32768;
        # the VLM's prefix core at hd 256, G = 8, on 256 patches
        ncfg, hcfg = configs.get(NEMO_ARCH), configs.get(HYB_ARCH)
        ecfg, vcfg = configs.get(ENC_ARCH), configs.get(VLM_ARCH)
        hw, nf = hcfg.local_window, PROMPT + GEN
        for tag, c, b, sq, kw in (
                ("hd192", ncfg, 1, PROMPT, {}),
                ("hd256", dataclasses.replace(
                    ncfg, name="hd256-g8", n_heads=64, head_dim=256), 1,
                 PROMPT, {}),
                # hd off the multiples of 16: the wrapper pads it to 208
                ("hd200", dataclasses.replace(
                    ncfg, name="hd200-g8", n_heads=64, head_dim=200), 1,
                 PROMPT, {}),
                ("hyb1024", hcfg, BATCH, PROMPT, dict(window=hw)),
                ("hyb8192", hcfg, 1, LONG_SEQ, dict(window=hw)),
                ("encdec_bidir", ecfg, BATCH, nf, dict(mode="bidir")),
                ("encdec_cross", ecfg, BATCH, PROMPT,
                 dict(mode="cross", skv=nf)),
                ("encdec_bidir32k", ecfg, 1, ENC_LONG,
                 dict(mode="bidir", light=True)),
                ("vlm_prefix", vcfg, BATCH, nf,
                 dict(mode="prefix", prefix_len=vcfg.n_patches)),
                # q blocks past 128 rows: the tuner's own (256, 128) at S =
                # 200 (starcoder2-3b's causal prefill, hd 128, G = 12) and
                # S = 132 (hd 256, prefix, G = 8): the tall instantiation
                ("tall200", cfg, BATCH, TALL_SEQ, dict(mode="causal")),
                ("tall132", vcfg, BATCH, 132,
                 dict(mode="prefix", prefix_len=64))):
            wide = check_attention(dev, gen, c, batch=b, seq=sq, **kw)
            if tag.startswith("tall") and wide["block"] != [256, 128]:
                raise AssertionError(f"{tag}: the tuner picked "
                                     f"{wide['block']}, not (256, 128)")
            by_name["int8_attention"][tag] = {
                k: wide[k] for k in keys + ("groups", "mode", "window",
                                            "prefix_len", "block")}
            lib = wide["library_ms"]
            log("kernels", f"int8_attention {tag} {wide['shape']}: "
                           f"{wide['ms']:.4f} ms, bound "
                           f"{wide['bound_ms']:.4f} ms ({wide['bound_by']}), "
                           f"plain {wide['plain_ms']:.4f} ms, library "
                           + ("n/a" if lib is None else f"{lib:.4f}")
                           + " ms")
            del wide
            torch.cuda.empty_cache()
        # the hybrid's projections: the RG-LRU's 4096 x 4096 and the
        # GeGLU's 4096 x 12288 at 4 x 1024 tokens
        mmrec = by_name["int8_matmul_fp"]
        mmrec["rglru"] = check_matmul_shape(
            dev, gen, "RG-LRU w_a", BATCH * PROMPT, hcfg.lru_width,
            hcfg.lru_width)
        mmrec["geglu"] = check_matmul_shape(
            dev, gen, "GeGLU up", BATCH * PROMPT, hcfg.d_model, hcfg.d_ff)
        # rwkv6-7b's channel mix at 4 x 1024 tokens: key (d -> d_ff) and
        # value (d_ff -> d); its time mix's 4096 x 4096 is the RG-LRU's
        rcfg = configs.get(RWKV_ARCH)
        mmrec["rwkv_key"] = check_matmul_shape(
            dev, gen, "channel-mix key", BATCH * PROMPT, rcfg.d_model,
            rcfg.d_ff)
        mmrec["rwkv_value"] = check_matmul_shape(
            dev, gen, "channel-mix value", BATCH * PROMPT, rcfg.d_ff,
            rcfg.d_model)
        # the frontends' projections and seamless's head: enc_in over the
        # train step's 2 x 4096 frames (K = 160), patch_proj over 4 x 256
        # patches (K = 1152), and one head chunk of the train step (2 x
        # 512 rows against the 256206-wide vocabulary)
        mmrec["enc_in"] = check_matmul_shape(
            dev, gen, "enc_in", ENC_TRAIN_BATCH * ENC_TRAIN_SEQ,
            ecfg.frontend_dim, ecfg.d_model)
        mmrec["patch_proj"] = check_matmul_shape(
            dev, gen, "patch_proj", BATCH * vcfg.n_patches,
            vcfg.frontend_dim, vcfg.d_model)
        mmrec["encdec_head"] = check_matmul_shape(
            dev, gen, "seamless head chunk",
            ENC_TRAIN_BATCH * ecfg.loss_chunk, ecfg.d_model, ecfg.vocab)
        torch.cuda.empty_cache()
        # every tile of the int8 matmul at decode, decode_32k's B 128, the
        # MoE prefill and the prefill, and one conv
        results["tiles"] = check_matmul_tiles(dev, gen, cfg, mcfg)
        mmrec["tiles"], by_name["int8_matmul_fused"]["tiles"] = \
            tile_records(results["tiles"])
        clock.stop()
    # phase 49's dry runs need host time only: they run beside phases
    # 4-48 (after phase 3's timings)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    dryrun_runs = DryrunRuns() if run_phase(49) else None
    for r in records:
        r["launches"] = None        # set by the path phases that run
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log("kernels", f"{r['name']} {r['shape']}: {r['ms']:.4f} ms, bound "
                       f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                       f"{r['plain_ms']:.4f} ms, library {lib} ms")
    torch.cuda.empty_cache()
    if run_phase(4):
        serve_phases(cfg, dev, records, results, run_phase, clock)
    if run_phase(7):
        # 7. train, full width and depth, fused backend
        with clock(7, "train"):
            results["train"] = train_phase(cfg)
        for r in records:
            r["launches"] = r["train_launches"] = \
                results["train"]["launches"][r["name"]]
        torch.cuda.empty_cache()
    if run_phase(8):
        # 8. fused vs simulated forward + backward, same params/batch/noise
        with clock(8, "train parity"):
            results["train_parity"] = train_parity_phase(
                dataclasses.replace(cfg, n_layers=PARITY_LAYERS), dev)
        torch.cuda.empty_cache()
    if run_phase(9):
        # 9. the fused layer path: its kernel's launches are this run's
        with clock(9, "fused layers"):
            results["fused_layers"] = fused_layer_phase(cfg, dev)
        _note_tiles(results, "fused layers")
        for r in records:   # the fused kernel is on this path alone
            if r["name"] in LAYER_KERNELS and not r["launches"]:
                r["launches"] = results["fused_layers"]["launches"][r["name"]]
        torch.cuda.empty_cache()
    cnn_phases(tuple(n for n in (10, 11) if run_phase(n) and n not in early))
    if run_phase(10):
        for r in records:
            r["cnn_train_launches"] = \
                results["cnn_train"]["launches"][r["name"]]
            if r["launches"] is None and r["name"] in CNN_KERNELS:
                r["launches"] = r["cnn_train_launches"]
    if run_phase(12):
        # 12. LM train with telemetry and the guard, full width and depth
        with clock(12, "tele train"):
            results["tele_train"] = tele_train_phase(cfg, dev, OUT_DIR)
        for r in records:
            r["tele_train_launches"] = \
                results["tele_train"]["launches"][r["name"]]
        torch.cuda.empty_cache()
    cnn_phases((13,) if run_phase(13) and 13 not in early else ())
    for n, name, key, fn in (
            (14, "tele serve", "tele_serve",
             lambda: tele_serve_phase(cfg, OUT_DIR)),
            (15, "guard parity", "guard_parity",
             lambda: guard_parity_phase(cfg, dev))):
        if run_phase(n):
            with clock(n, name):
                results[key] = fn()
            torch.cuda.empty_cache()
    # 47-48 and 50's 8 ranks (~39 GiB of the card) beside 16 (~15 GiB):
    # Beside
    seq_pad = tuple(n for n in (47, 48, 50) if run_phase(n))
    beside = Beside("phase 16 beside 47-48 and 50's ranks", seq_pad_spawn,
                    seq_pad) if seq_pad else None
    if run_phase(16):
        with clock(16, "checkpoint"):
            results["ckpt"] = ckpt_phase(cfg, OUT_DIR)
        torch.cuda.empty_cache()
    if seq_pad:
        seq_pad_checks(seq_pad, *beside.join(), records, results, clock)
    if run_phase(17):
        # 17. MoE serve at full width and depth; 18. its prefill parity
        with clock(17, "moe serve"):
            run, layer0 = moe_serve_phase(mcfg, records, results)
        if run_phase(18):
            with clock(18, "moe parity"):
                moe_parity_phase(run, layer0, dev, results)
        del run, layer0
        torch.cuda.empty_cache()
        for r in records:
            if r["launches"] is None and r["name"] in SERVE_KERNELS:
                r["launches"] = r["moe_serve_launches"]
    if run_phase(19):
        # 19. the MoE train step, full width, depth cut
        with clock(19, "moe train"):
            results["moe_train"] = moe_train_phase(mcfg, dev, records)
        torch.cuda.empty_cache()
        for r in records:
            if r["launches"] is None and r["name"] in TRAIN_KERNELS:
                r["launches"] = results["moe_train"]["launches"][r["name"]]
    if run_phase(20):
        # 20. starcoder2-7b at full size past its window; 21. its parity;
        # 22. its fp32 path through _local_attn
        with clock(20, "sc7 serve"):
            long = sc7_serve_phase(dev, records, results)
        for n, name, fn in ((21, "sc7 parity", sc7_parity_phase),
                            (22, "sc7 fp32", sc7_fp_phase)):
            if run_phase(n):
                with clock(n, name):
                    fn(long, dev, results)
        del long
        torch.cuda.empty_cache()
    for n, name, fn in ((23, "command-r", cmdr_phase),
                        (24, "nemotron", nemotron_phase),
                        (25, "long train", long_train_phase)):
        if run_phase(n):
            with clock(n, name):
                fn(dev, records, results)
            torch.cuda.empty_cache()
    if run_phase(26):
        # 26. recurrentgemma-9b at full size past its window; 27. its
        # parity checks (the fused-vs-simulated one on phase 26's
        # parameters, the others after they are freed)
        with clock(26, "hybrid serve"):
            long, scan_ops = hyb_serve_phase(dev, records, results)
        if run_phase(27):
            with clock(27, "hybrid parity"):
                results["hyb_parity"] = {"fused_vs_simulated": long_parity(
                    long, dev, "hyb-parity")}
        del long
        torch.cuda.empty_cache()
        if run_phase(27):
            with clock(27, "hybrid parity"):
                hyb_parity_phase(scan_ops, dev, results["hyb_parity"])
        del scan_ops
        torch.cuda.empty_cache()
    if run_phase(28):
        with clock(28, "hybrid train"):
            hyb_train_phase(dev, records, results)
        torch.cuda.empty_cache()
    if run_phase(29):
        # 29. rwkv6-7b at full size, 4 x 1024 and 1 x 32768; 30. its
        # parity checks (fused vs simulated and the WKV on phase 29's
        # parameters, decode vs prefill after they are freed)
        with clock(29, "rwkv serve"):
            params, policy = rwkv_serve_phase(dev, records, results)
        if run_phase(30):
            with clock(30, "rwkv parity"):
                results["rwkv_parity"] = {}
                rwkv_parity_phase(params, policy, dev, results["rwkv_parity"])
        del params
        torch.cuda.empty_cache()
        if run_phase(30):
            with clock(30, "rwkv parity"):
                rwkv_decode_phase(dev, results["rwkv_parity"])
            torch.cuda.empty_cache()
    if run_phase(31):
        with clock(31, "rwkv train"):
            rwkv_train_phase(dev, records, results)
        torch.cuda.empty_cache()
    # 39-40's ranks beside 32-36 and 38, 44's (2, 2) ranks beside 37
    # (Beside): the main process's phases there hold at most ~20 GiB of
    # the card, 40's ranks ~35 GiB; 43-46's ranks (~77 GiB: rank 0 runs
    # the one-process steps), 41 (~41 GiB) and 42 (which times kernels)
    # run alone
    beside = Beside("phases 32-36 and 38 beside 39-40's ranks", dp_spawn,
                    run_phase(39)) if run_phase(40) else None
    for first, second, serve_fn, parity_fn, names in (
            (32, 33, encdec_serve_phase, encdec_parity_phase,
             ("encdec serve", "encdec parity")),
            (35, 36, vlm_serve_phase, vlm_parity_phase,
             ("vlm serve", "vlm parity"))):
        # 32 / 35. the enc-dec / VLM family served at full width and depth;
        # 33 / 36. its parity checks on the served run's parameters
        if run_phase(first):
            with clock(first, names[0]):
                run = serve_fn(dev, records, results)
            if run_phase(second):
                with clock(second, names[1]):
                    parity_fn(run, dev, results)
            del run
            torch.cuda.empty_cache()
        # 34. the enc-dec train step at full width (37's comes later)
        if first == 32 and run_phase(34):
            with clock(34, "encdec train"):
                encdec_train_phase(dev, records, results)
            torch.cuda.empty_cache()
    if run_phase(38):
        with clock(38, "tall serve"):
            tall_serve_phase(dev, records, results)
        torch.cuda.empty_cache()
    if run_phase(40):
        # 39's ranks ran in 40's spawn: its seconds are their part's
        seconds = beside.join()
        t0 = time.perf_counter()
        results["dp_train"] = dp_train_phase(records)
        seconds += time.perf_counter() - t0
        if run_phase(39):
            part = json.loads((OUT_DIR / "compress_s.json").read_text())
            results["compress"] = compress_phase(records, spawned=True)
            clock.add(39, "compress", part)
            seconds -= part
        clock.add(40, "dp train", seconds)
    elif run_phase(39):
        with clock(39, "compress"):
            results["compress"] = compress_phase(records)
        torch.cuda.empty_cache()
    pair = tuple(n for n in (43, 44, 45, 46) if run_phase(n))
    beside = Beside("phase 37 beside 44's (2, 2) ranks", reduced_spawn) \
        if 44 in pair else None
    if run_phase(37):
        # 37. the VLM train step at full width
        with clock(37, "vlm train"):
            vlm_train_phase(dev, records, results)
        torch.cuda.empty_cache()
    if pair:
        reduced_s = beside.join() if beside else 0.0
        jobs = pair_jobs(pair)
        seconds = pair_spawn(jobs)
        if 44 in seconds:
            seconds[44] += reduced_s
        pair_checks(jobs, seconds, records, results, clock)
        torch.cuda.empty_cache()
    if run_phase(41):
        with clock(41, "decode cells"):
            cells_phase(dev, records, results)
        torch.cuda.empty_cache()
    if run_phase(42):
        with clock(42, "general attention"):
            general_attention_phase(dev, records, results)
        torch.cuda.empty_cache()
    if run_phase(49):
        with clock(49, "dryrun"):
            results["dryrun"] = dryrun_phase(dryrun_runs, results["dp_train"])
    for r in records:       # the kernels' launches where no earlier path ran
        for key in ("sc7_serve_launches", "cmdr_serve_launches",
                    "nemotron_serve_launches", "grad_only_launches",
                    "act_only_launches", "hyb_serve_launches",
                    "hyb_train_launches_per_step", "rwkv_serve_launches",
                    "rwkv_train_launches_per_step", "encdec_serve_launches",
                    "encdec_train_launches_per_step", "vlm_serve_launches",
                    "vlm_train_launches_per_step", "tall_serve_launches",
                    "dp_train_launches", "tp_serve_launches",
                    "tp_train_launches", "tp_45_launches",
                    "tp_46_launches", "seq_train_launches",
                    "pad_serve_launches", "pad_train_launches",
                    "sp_serve_launches", "sp_train_launches"):
            if not r["launches"] and r.get(key):
                r["launches"] = r[key]
        if not r["launches"]:       # the decode cells alone (phase 41)
            r["launches"] = next((n for n in r.get("cell_launches",
                                                   {}).values() if n),
                                 r["launches"])

    for r in records:       # each tile: its launches in the first path run
        for t in r.get("tiles", ()):
            key = f"{r['name']}:{t['tile'][0]}"
            runs = {what: c[key] for what, c in
                    results.get("tile_launches", {}).items()}
            t["launches"] = next((n for n in runs.values() if n), 0)
            t["launches_by_run"] = runs
    kernels = [{k: r[k] for k in ("name", "route", "source", "replaces",
                                  "launches", "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "tiles") if k in r}
               for r in records]
    results["kernels"] = records
    results["time"] = clock.summary()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
