#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA
Hopper card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, none of whose failures is caught:
  (a) print the card's name and power limit; build the CUDA kernels
      from `ray_tpu_torch/csrc/`;
  (b) hold each kernel against its plain PyTorch version on the card
      (bf16, q/k/v = randn * 0.5), at the slice's shape and at shapes
      that hit the edges of the kernels' 128-row tiles (t 192, t 64,
      tq 128 / tk 384, kv_len 200 inside a tile, bh 1), at the shape
      sp4_long of `--cards 4` gives each rank (bh 8 x t 16384, causal,
      the plain version a head at a time), and the public
      `flash_attention` against `mha_reference` computed in f32 on the
      same inputs. The backward op is its three launches (delta and
      dq's accumulator zeroed, the fused kernel, dq's scale and cast)
      against its one plain version. Every
      output is held to its reference relatively: max abs error at
      most REL_TOL * max|ref| and L2 error at most REL_TOL * ||ref||.
      The backward runs under two upstream gradients: a random one
      (randn * 0.5), which makes every row of `do` matter, and the
      verify recipe's (loss sum(out * 0.01)), which is also held to its
      absolute bars (`out` 0.05, each gradient 0.01); lse is held to
      1e-3. Two negative controls show the bars catch a backward that
      writes no dq or reads `do` at the wrong rows. Then time each op
      (the backward's three launches together and each alone), its
      plain version and `scaled_dot_product_attention` (a yardstick
      only: the port never calls it). Then the same for the "any" and
      "wide" kernels (`csrc/flash_fwd_any.cu`, `csrc/flash_bwd_any.cu`:
      every dtype and head_dim the wgmma pair does not take, the "wide"
      ones above 256) at ANY_CASES (16-bit and f32 at d 16 to 704, and
      their tiles' edges), f32 held at F32_REL_TOL (1e-5: the f32
      forward's three-term TF32 product is held there alone first, S at
      d 256, where one TF32 term and the plain version with TF32 or bf16
      products must fall outside it, at f32 d 128 and 512 as well), the
      "wide" pairs' chunks equal bit for bit on inputs of equal 256-column
      chunks (d 512 and 608, in f32, bf16 and f16), with the two negative
      controls at
      bf16 d 256 and 512, the public op against `mha_reference` in f32 at
      ANY_OP_CASES, and their times at ANY_TIMED beside SDPA (in f32 also
      SDPA's own error, printed) and their bounds (f32's the lesser of the
      CUDA cores' 67 TFLOP/s and three TF32 terms at 495); at Gemma's
      bf16 shape also under two sharp softmaxes (q not scaled by
      1/sqrt(d), and 8 times that, where P underflows),
      in turns with the op's own scaling, to show whether the time
      depends on the data;
  (c) the slice: Llama-2-7B width (dim 4096, 32 heads, head_dim 128,
      intermediate 11008, vocab 32000, bf16, flash attention, full
      remat) cut to 4 layers (`--layers`), batch 2 x seq 4096, 8 steps
      of `make_train_step` with `default_optimizer(3e-4,
      total_steps=20)` on one fixed batch. The loss must stay finite
      and fall, and the launch counters must show 2 forward (one under
      remat) and 1 backward op (each of its 3 launches once) per layer
      per step.
  (h1) the runtime on the card: `ray_tpu_torch.init(num_cpus=2,
      num_gpus=1)` before (c)'s steps, and (c)'s initial weights and
      batch `put` into the object store (CUDA tensors, staged to the
      host). After (c) has freed its model, a `num_gpus=1` actor gets
      them (they arrive on the card, bit for bit by a weighted byte sum)
      and runs RUNTIME_STEPS steps of (c)'s step: step 1's loss must
      equal (c)'s to the bit, step 2's within RUNTIME_STEP2_REL; a CPU
      task must see no card; a 1 GiB bf16 CPU tensor goes through
      `put`/`get` in one out-of-band buffer, equal. The runtime is shut
      down after.
  (h2) Gemma-2B (`LlamaConfig.gemma_2b()`, all 18 layers, head_dim 256,
      vocab 256000, bf16, remat "full"), random weights from a seed,
      batch 1 x 4096, 3 steps of `make_train_step`: the loss must be
      finite and fall, and every flash launch must go to the "any"
      kernels (2 forward and one backward op per layer per step).
  (h3) the "wide" kernels' path: Gemma-2B's geometry with head_dim 512
      (`WIDE_HEAD_DIM`; no preset has a head_dim above 256), 2 layers,
      batch 1 x 1024, 3 steps under remat "full", in bf16 and again in
      f32 (the f32 "wide" pair's path, WIDE_F32_STEPS steps): the loss
      must be finite and fall, and every flash launch must go to the
      "wide" kernels.
  (h4) the f32 "any" kernels' path: (h3)'s model at Gemma-2B's own
      head_dim 256 in f32, WIDE_F32_STEPS steps: the loss must be finite
      and fall, and every flash launch must go to the "any" kernels.
  (f) after (c) has freed its memory: (f1) the slice's model (same
      width and depth, batch 2 x 4096, bf16, flash) from one set of
      weights and one batch, 4 steps under each remat policy ("full",
      "dots", "dots_flash"). The step-1 losses must agree to
      REMAT_LOSS_REL and grad norms to REMAT_GNORM_REL, every step's
      loss to "full"'s to MESH_LOSS_REL, the loss must
      fall under each, and the counters must show 2 forward launches
      per layer per step under "full" and "dots", 1 under "dots_flash",
      and one backward op (3 launches) per layer per step under all
      three. (f2) `bench.py`'s mesh path: a NCCL world of one rank made
      by the port's backend, `MeshSpec(fsdp=1).build("cuda")`, and
      `make_train_step(loss, optimizer, mesh, param_annotations(cfg))`
      with `shard_batch` under "dots_flash" on the same weights and
      batch, 4 steps: the weights must be DTensors on the CUDA mesh (the
      norms, which the rules replicate, whole tensors on the card),
      the backend nccl, and the losses (f1)'s "dots_flash" ones to
      MESH_LOSS_REL; `prefetch_to_device` puts 3 host batches on the
      mesh through pinned memory and a side stream, unchanged. (f3) a `TorchTrainer` fit (`num_workers=1`) at the
      small width of (c)'s small model saves an async checkpoint every 2
      of 6 steps keeping 2: both kept directories hold `metadata.json`
      after the fit, and the newest restores bit for bit; three more
      saves, each after the last one's write, time the snapshot with
      the writer idle.
  (g) after (f) has freed its memory, on a NCCL world of one rank made
      by the port's backend and `pipeline_mesh(1, 1, 1)`: (g1)
      `make_pp_train_step` (2 microbatches) on (f1)'s model, weights and
      batch under remat "full", 4 steps: the loss must be finite and
      fall, step 1's must lie within MESH_LOSS_REL of (f1)'s "full"
      step 1, and the counters must show 2 forward launches and one
      backward op per layer per microbatch per step. (g2) the same step
      on `llama2_7b(n_layers=2, moe_experts=8, moe_top_k=2)` (JAX's
      dense path: every token through all 8 experts), random weights
      from a seeded generator, 3 steps: the loss must be finite and
      fall (its MFU counts the active experts only, so it reads low by
      design). (g3) `moe_ffn_ep` over the mesh's ep group of one against
      `moe_ffn_dense` at 8192 tokens x 4096, 8 experts of 4096 x 11008,
      top-2, bf16, capacity factor E/k (nothing drops): outputs held at
      REL_TOL, aux within AUX_TOL.
  (g4) after (g3), the MPMD pipeline (`MPMDPipeline`, device "cuda"):
      `ray_tpu_torch.init(num_cpus=4, num_gpus=1)`, and 2 stage actors
      that share the card (num_gpus 0.5 each, fresh GPU workers). (g4a)
      at (e1)'s small width in f32, batch 4 x 64 in 2 microbatches, one
      SGD step at lr 0.1: the loss within MPMD_LOSS_ABS of one card's
      `loss_fn` on the same weights and batch, and `collect_params()`
      within MPMD_PARAM_RTOL / MPMD_PARAM_ATOL of params - 0.1 * grad
      from one card's autograd; held to the same computed on targets
      shifted by one position, they must fail. (g4b) the Llama-2-7B width
      at MPMD_LAYERS layers, bf16, remat "full", weights and a batch of
      MPMD_MICROBATCHES x 4096 from phase (c)'s seed; one card's loss
      under `torch.no_grad()` and (c)'s step at the same batch (the
      yardstick), freed before the stages start; then MPMD_STEPS steps
      of `default_optimizer` in microbatches of 1 under each schedule:
      1F1B (2 stages of one chunk) and interleaved (2 stages of 2
      chunks). Step 1's loss must lie within MESH_LOSS_REL of one
      card's, the loss must be finite and fall, the stash peaks within
      `stash_bound`, and the flash launch counts read in each stage's
      process (zeroed just before the steps) must equal
      `mpmd_expected_launches`: per microbatch, a layer of a chunk
      other than the last runs the forward kernel in its F op and, under
      remat "full", twice in its B op (the chunk's recompute and the
      layer's own), a layer of the last chunk twice in its B op, and
      every layer one backward op.
  (e) serving, after (c) has freed its model and optimizer. First the
      paged decode kernel alone at the serving cell's shape (32 rows, 8
      KV heads of 128, groups of 4, tables of 96 blocks of 16, bf16, row
      lengths from `gpubench.traffic`'s serving mix), held to its plain
      version by the bars of (b), then timed beside its bound (the live
      K/V bytes at the HBM rate), the plain version and SDPA over the
      rows gathered contiguous: the kernels line's `paged_decode` entry.
      (e1) at a small width in f32 (vocab 512, dim 256, 2 layers, 4 heads on 2 KV
      heads), 6 greedy requests through the engine (slots 4, max_len
      256, prefill_chunk 32, prefix cache on; two share a prefix, one
      arrives while another decodes) must equal `generate` token for
      token. (e2) Llama-2-7B (`LlamaConfig.llama2_7b()`, 32 layers by
      `--serve-layers`, bf16, random init from the seeded generator),
      2 prompts of 1024 tokens: `prefill` and 16 `decode_step`s on the
      contiguous cache, and `paged_prefill` in 256-token chunks and 16
      `paged_decode_step`s on a scrambled block pool, each step one
      paged decode kernel launch a layer. Each step's logits are held
      to teacher-forced logits at the same positions of the f32
      `llama.forward` of the same weights: max abs and relative
      L2 error each at most NOISE_RATIO x those of the bf16
      `llama.forward`. Held to the next position's, they must fall
      outside. (e3) the server on
      the same model: `EngineConfig(slots=8, max_len=2048,
      prefill_chunk=256, prefix_cache=True)`, 16 requests of a shared
      512-token system prefix and a seeded random tail of 64-1024
      tokens, 64 new tokens each, greedy, all submitted at once and each
      stream consumed on its own thread. Every request must end with
      "length", the prefix cache must hit, the flash launch counters
      must not move while the engine serves, and the paged decode
      kernel must launch once a layer a decode step. Greedy
      consistency: each served token's teacher-forced (bf16) logit is
      within delta (3x the largest error of (e2)'s logits against the
      bf16 forward) of its row's maximum; held to the next position's
      logits (the control) not every token may be.
  (e4) the LLM app on the card, after (e3) has freed its model:
      `ray_tpu_torch.init(num_cpus=4, num_gpus=1)`, the Serve controller
      and HTTP proxy, and `build_llm_app` (one `num_gpus=1` replica,
      (e3)'s engine config) over two families: (e3)'s Llama-2-7B config
      in bf16, weights drawn from APP_SEED, and (e1)'s small width in
      f32. One request through the handle pays the replica's model
      build, untimed. Then (e3)'s 16 prompts go over HTTP, 16 concurrent
      clients reading the chunked streams off the socket (SLO admission
      off: the router's default threshold of 1024 outstanding tokens
      sheds such a burst). Every stream must hold 64 chunks of one
      decimal id each; every token must lie within (e3)'s delta of its
      row's maximum in the teacher-forced logits of the same spec built
      in the driver, and the one-position-shift control must fail. A
      client drops a stream of APP_CANCEL_BUDGET tokens after its first
      chunk: the replica's engine must free the slot within
      APP_CANCEL_S, before the budget is spent, and a later request is
      served. At the small width in f32 the app's tokens over the handle
      and over HTTP, through the engine and through the kill switch (an
      app of its own, `engine_enabled=False`), must equal `generate`.
      `serve.shutdown()` and `ray_tpu_torch.shutdown()` run however the
      phase ends.
  (i) the RL slice (`ray_tpu_torch.rl`), after (e4). No kernel of the
      port runs on its path but (i4)'s teacher (the policy is an MLP in
      plain torch, as the JAX package's is plain `jnp`). (i1)
      `TorchLearner` on the card and on the CPU from the same seeded
      weights takes one PPO update of a seeded CartPole-shaped batch
      (RL_ROWS rows, obs 4, 2 actions, hidden 64 x 64, minibatch
      RL_MINIBATCH, RL_EPOCHS epochs, lr RL_LR): the parameters must
      agree to RL_PARAM_TOL (rtol and atol); `DQNLearner` the same over
      RL_DQN_UPDATES TD updates of a seeded replay ring; each control,
      the CPU learner one optimizer step short, must fall outside. A
      second update of each is timed. (i2) `ray_tpu_torch.init(
      num_cpus=6, num_gpus=1)`; synchronous PPO at `PPOConfig()`'s
      defaults (2 runners x 16 envs x 128 steps, the runners actors on
      the host, the learner on the card) must reach a mean return of
      RL_RETURN_BAR within RL_MAX_ITERATIONS iterations (the
      reference's bar); the learner's update is timed. (i3) decoupled
      PPO in engine mode (`PolicyEngineActor` in a GPU worker, the
      learner on the card, RL_ENGINE_RUNNERS runners): RL_ENGINE_UPDATES
      updates, each weight version pushed to the engine; fragments must
      flow, some engine forward must serve more than one runner's rows,
      and the return must rise; then one runner is killed and
      RL_UPDATES_AFTER_KILL more updates must land, the slot respawned.
      (i4) the RLHF push at the Llama-2-7B width (RL_PUSH_LAYERS layers,
      bf16): `ray_tpu_torch.init` with an object store of
      RL_PUSH_STORE_BYTES; an `InferenceEngine` in a `num_gpus=1` actor
      (`EngineHost`) over weights A drawn from a seed (equal to the
      driver's A by a weighted byte sum) decodes RL_PUSH_STREAMS greedy
      streams of RL_PUSH_PROMPT-token prompts; once each has given
      RL_PUSH_TAKE tokens, `push_weights` sends weights B's state dict
      through the store; at its install A must still be pinned
      (weight_gens 2, no stream ended); RL_PUSH_STREAMS streams admitted
      after it decode RL_PUSH_NEW tokens each, then the old streams are
      cancelled and weight_gens must fall back to 1. Each old stream's
      tokens must lie within (e3)'s delta of their row's maximum in A's
      teacher-forced logits, each new one's in B's; the new streams held
      to A's (the control) must not.
  (j) the compile watch (`_private/compile_watch.py`) on the card, after
      (i). (j1) flash_fwd built anew (a fresh build directory under
      `build/`, the loaded library set aside and restored after) inside
      an instrumented call: exactly one `kernel.flash_fwd` record with
      nvcc's wall time, the call's program billed the build's time as
      `compile_ms` once, the build's time less nvcc's under 100 ms.
      (j2) the registry is reset before (c)'s steps, (e3)'s engine,
      (i2) and (i3), and read after them; each program must hold one
      record per distinct signature: `train.step` [1, 1] after step 1
      and after step 8, (e3)'s `stats()["compiles"]` prefill and decode
      {1, 1}, (i3)'s policy engine's policy program compiles equal to
      its distinct shapes; each (g4b) stage program's counts, read in
      its stage's process, must equal the signatures it has seen (one,
      or one per chunk for `acc`); every other training run of the
      script (`train_steps`: (f), (g1), (g2), (h), and each run of
      `--cards 4` on every rank) must record its step program
      (`train.step` or `train.pp_step`) [1, 1]. (j3) a prefill loop whose length
      drifts (WATCH_DRIFT_CALLS lengths from WATCH_DRIFT_FROM by
      WATCH_DRIFT_STEP) through `generate.prefill` at (e1)'s width in
      f32 must be the one storm `detect_storms` names, with "dim 1
      drifting"; the same calls at one length no storm; `static_hint`
      names the wrap site. (j4) the watch's hot path (digest and
      seen-set lookup on a hit; an instrumented no-op less the no-op,
      best of 3 x WATCH_REPS calls) on the real arguments of (c)'s
      `train.step`, (e3)'s paged decode step and (i2)'s PPO minibatch
      update must be under WATCH_SHARE of each one's step ((c)'s
      steady step, (e3)'s decode step at batch 8, the minibatch update
      timed 20 times after (i2)).
  (k) data and tune (`ray_tpu_torch.data`, `ray_tpu_torch.tune`) on the
      card, after (j): `ray_tpu_torch.init(num_cpus=4, num_gpus=1)`.
      (k1) DATA_ROWS rows of SEQ + 1 int32 tokens below DATA_VOCAB, drawn
      from MPMD_SEED (phase (c)'s), written as DATA_FILES .npy files into
      a temporary directory and read by `data.read_numpy(...,
      column="tokens")`; a `map_batches` splits each row into `tokens`
      and `targets` and adds its `row` id, then `random_shuffle(seed=
      DATA_SHUFFLE_SEED)`. `TorchTrainer(data_loop, ScalingConfig(
      num_workers=1, use_gpu=True), datasets={"train": ds})`: the loop
      builds (c)'s model (the 7B width at `--layers`, bf16, flash, remat
      "full") from MPMD_SEED, the `MeshSpec(fsdp=1)` step of (f2) on a
      NCCL world of one rank, and reads `get_device_batches("train",
      mesh=..., batch_size=BATCH, prefetch_batches=2, buffer_size=2)`,
      DATA_ROWS / BATCH steps. Every batch tensor must be on the card,
      every row read once (count and sum), every loss finite and the
      last 4 below the first 4 on average, step 1's loss within
      MESH_LOSS_REL of a direct `make_train_step` on the same weights
      and the fit's first batch, and the launch counters (zeroed just
      before the fit) 2 forward launches and one backward op per layer
      per step. Prints the median step, each step's `data_wait_ms` and
      `h2d_ms` from step telemetry, and (f2)'s median step. (k2) a
      `Tuner` over `TorchTrainer(data_loop)` at TUNE_LAYERS layers and
      TUNE_STEPS steps on (k1)'s dataset, `param_space={"lr":
      grid_search(TUNE_LRS)}`, `TuneConfig(metric="loss", mode="min",
      resources_per_trial={"num_gpus": 1}, max_concurrent_trials=1)`: 3
      trials with no error, each reporting the card's name and a pid
      other than the driver's, their step-1 losses within MESH_LOSS_REL
      of each other, `get_best_result()` the lowest loss; then one trial
      of the same trainer with `resources_per_trial={"num_cpus": 1}`
      must end with the error that no CUDA device is visible.
  (l) the cluster surface (the CLI, jobs, dashboard, workflow, util APIs
      and autoscaler), after (k), against (k1)'s record (`--only-cluster`
      runs (k1) first). (l1) `python -m ray_tpu_torch start --head
      --num-gpus 1` in a subprocess: `status` and `state ls nodes` must
      show GPU 1.0. `submit --no-wait` of an entrypoint (`cluster_job`)
      that must see the card itself (the job manager gives it the host's
      CUDA_VISIBLE_DEVICES; no card fails the job), draws (k1)'s rows on
      it, connects through RT_ADDRESS and runs (k1)'s `TorchTrainer(
      datasets=...)` in a `num_gpus=1` actor (`ClusterFit`: a driver has
      no profile endpoint). After its first step the rank waits until
      `profile --duration-s 2 --out ...` starts (`hold_for_profiler`);
      the rank's `device_trace` must name the flash forward and backward
      kernels. `jobs` must read SUCCEEDED, and `logs` give 32 losses
      within MESH_LOSS_REL of (k1)'s, every row once, the launch counts
      of (k1). The dashboard (`dashboard --port 0`): `/api/resources`
      GPU 1.0 total and available, `/api/steps` the job's steps, and
      `/metrics` its rank's compile series. `stop` must leave no process
      of the head and give the card's free memory back within
      CLUSTER_MEM_SLACK. (l2) under `init(num_cpus=4, num_gpus=1)`: a
      workflow of two `num_gpus=1` steps, A one step of (k1)'s model on
      its first batch (loss and gradient norm as tensors on the card),
      B failing on its first run; `workflow.resume` in a driver
      subprocess with CUDA_VISIBLE_DEVICES="" must not run A again (no
      flash launch), load A's saved tensors on the CPU, and finish; A's
      loss within MESH_LOSS_REL of (k1)'s direct step. (l4) two
      `num_gpus=0.5` actors map CLUSTER_POOL_CALLS flash forwards at
      CLUSTER_FLASH_SHAPE (half through `ActorPool.map`, half through
      `map_unordered`), each call's seed taken from a `util.Queue`; every
      output within REL_TOL of the plain version. (l3) an
      `AutoscalingCluster` with a card-less head and one node type
      {"CPU": 2, "GPU": 1}, max 1: a `num_gpus=1` flash forward at
      CLUSTER_FLASH_SHAPE must launch exactly that node, run on the card
      within REL_TOL of the plain version, and the node be terminated
      after CLUSTER_IDLE_S idle; prints the seconds from demand to
      running.

Prints `{"kernels": [...]}` (with each kernel's launches under each
remat policy, in the mesh step and in (k1); the paged decode kernel's
in (e2) and (e3)), then `{"slice": {...}}`, then
`{"serve": {...}}` (the card, TTFT and inter-token gap p50/p99, decode
tokens/s and step ms at a full batch beside its bound, prefill
tokens/s, prefix hits and tokens saved, pool bytes, peak memory of
phase (e)), then `{"serve_app": {...}}` ((e4): the card, HTTP TTFT and
gap p50/p99 beside (e3)'s, the replica's decode step at batch 8, prefix
hits, the seconds of the controller and proxy, the replica and its
model build, the replica's peak memory, the consistency counts, the
dropped stream's time to a free slot, each step's seconds), then
`{"train_sharded": {...}}` (the card; step ms,
tokens/s, MFU, peak memory, losses and launches of each (f1) policy
and of (f2); (f3)'s checkpoints and `ckpt_block_ms`), then
`{"train_pp": {...}}` (step ms, tokens/s, MFU, peak memory, losses and
launches per step of (g1) and (g2); (g3)'s errors and times), then
`{"train_mpmd": {...}}` ((g4): per schedule the losses, step ms,
tokens/s, each stage's busy, wall and optimizer ms, edge waits and
bytes and peak memory, the bubble bound, the build's ms, the launches;
(c)'s step at the same batch; (g4a)'s errors and its control), then
`{"runtime": {...}}` ((h1)), `{"gemma": {...}}` ((h2)), `{"wide":
{...}}` ((h3), the f32 run under "f32"), `{"f32_any": {...}}` ((h4)) and
`{"rl": {...}}` ((i): the card; (i1)'s errors, controls and update
ms; (i2)'s iterations, returns and update ms; (i3)'s returns, versions,
engine forwards and requests per forward, the counts before and after
the kill; (i4)'s push bytes and ms, the store's size, the state at the
push, the streams' lengths and the consistency counts), then
`{"compile_watch": {...}}` ((j): each window's counts, the hot path's
us and share of each step, (j1)'s nvcc and billed ms, (j3)'s storm and
hint; each kernel's entry in the kernels line carries its library's
nvcc ms from (a), None when cached), `{"data": {...}}` ((k): the card;
(k1)'s losses, step ms, per-step `data_wait_ms` and `h2d_ms`, rows,
launches, the direct step's loss, (f2)'s median step; (k2)'s trials,
best lr and the card-less trial's error), `{"cluster": {...}}` ((l):
each part's seconds, (l1)'s step ms and losses beside (k1)'s, the
profile and the trace's kernels, the dashboard's reads, the stop and
the card's free memory; (l2)'s runs and reloaded value; (l3)'s demand
to running s, launches and idle to termination s; (l4)'s seeds and
errors), then the
card's name and power limit, and as the last
line `{"ok": true, "device": {...}}`. Exits non-zero with no
result line when there is no CUDA card or the port is not beside it.

`--cards 4` (never part of the plain run) builds the kernels and runs
only the four-card phase, in a NCCL gang of 4 local processes, one card
each, on the Llama-2-7B width at `--layers` and a batch of 4 x 4096,
each run against the same weights and batch on one card (a gang of one
run first; every mesh spans its gang's whole group):
`make_pp_train_step` at pp 2 x sp 2 with ring attention, and at pp 2 x
ep 2 with 8 experts; `make_train_step` under "dots_flash" over
`MeshSpec(fsdp=4)`, `MeshSpec(fsdp=2, tp=2)`, `MeshSpec(fsdp=2, sp=2)`
and `MeshSpec(sp=2, tp=2)` (Ulysses over the flash kernels), over
`MeshSpec(sp=4)` at 1 x CARDS4_LONG_SEQ (against one card at that
length), and the 2-layer 8-expert MoE over `MeshSpec(fsdp=2, tp=2)`
(the experts' products split on their mlp dim; against one card's
`make_train_step`); then
`TorchTrainer(num_workers=4)` on a gang of the runtime's `num_gpus=1`
actors (NCCL, `MeshSpec(fsdp=4)`), held to the local gang's fsdp4 run;
then `MPMDPipeline` in 4 stages, one per card, at CARDS4_MPMD_LAYERS
layers and CARDS4_MPMD_MICROBATCHES x 4096 in microbatches of 1, held
to one card's loss on the same weights and batch (and (g4b)'s other
bars), then (k3): `TorchTrainer(num_workers=4, datasets=...)` on a gang
of the runtime's `num_gpus=1` actors at `MeshSpec(fsdp=4)`, (k1)'s rows
unshuffled (one file a rank), each rank reading its `get_device_batches`
shard (BATCH rows a rank, the global batch 4 x BATCH): every rank must
read as many rows, every row be read once over the ranks, and every
rank report the same losses. Each run's loss must fall and its step 1
lie within CARDS4_LOSS_REL of one card's, and each `make_train_step` run's flash
launches on every rank equal one per layer and step, forward and each
backward launch (the ring run's none); it prints `{"four_cards": {...}}`
(step ms, tokens/s, peak per card). With `--profile` it traces one more
step of each `make_train_step` run (device time by group, NCCL's
apart). It fails on a machine with fewer than 4 cards.

`--only-mpmd` builds the kernels and runs only phase (g4) (with
`--cards 4`, only the four-card MPMD run), then the last two lines.
`--only-data` builds the kernels and runs only phase (k) ((k1)-(k2);
with `--cards 4`, only (k3)), then the last two lines.
`--only-cluster` builds the kernels and runs only phase (l), (k1) first
as its reference, then the last two lines.
`--only-serve` builds the paged decode kernel and runs only phase (e)'s
kernel timing and (e1)-(e3), then `{"serve": {...}}` (the timing under
`paged_decode`) and the last two lines.
`--only-rl` builds the kernels and runs only phase (i), with (i4)'s
delta measured as (e2) measures it on (i4)'s weights A (paged logits
against the teacher-forced bf16 forward, x 3), then the last two
lines.

`--profile` traces one more step with torch.profiler after the slice
and prints `{"profile": ...}`: device time by kernel, and idle share.
It traces one more step of each (f1) policy, of (f2), (g1) and (g2)
too, into their records, and records the allocator's history over
each one's timed steps (which then run slower) for the allocations
alive at their peak, by the line of the port that made them.
It also traces one paged decode step at the full batch and one prefill
chunk of the serving model, into the `{"serve": ...}` record's
"profile".

`--against ROOT` adds phase (d), a comparison with another checkout of
the repo at ROOT (for example `git archive <commit>` unpacked into a
gitignored directory). Its `ray_tpu_torch` is imported beside this one
and builds its kernels from its own sources. At the slice's shape its
forward kernel and its backward op (every launch its autograd backward
makes), and at AGAINST_TIMED (Gemma-2B's bf16 d 256, f32 d 128 and
256, bf16 d 512 and f32 d 512) its "any" and "wide" forward and
backward op, are held to this tree's plain versions and timed in turns
ROOT, this, this, ROOT. Then each tree, ROOT first, trains two steps of the
slice from the same seed with the allocator's history recorded: the
peak of device memory and the largest allocations alive at it, by the
innermost line of the port that made them. Prints `{"against": ...}`.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

#: Dense bf16 tensor-core peak and HBM rate of an H100 SXM at 700 W
#: (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def train_flops_per_token(cfg, seq_len: int) -> float:
    """Training FLOPs a token, forward and backward: 6 x the multiplied
    parameters (the input embedding is a lookup, not a product; for MoE
    only the experts a token activates) plus causal attention's
    12 x layers x heads x head_dim x seq / 2."""
    n = cfg.num_params() - cfg.vocab_size * cfg.dim
    if cfg.moe_experts:
        inactive = (cfg.moe_experts - cfg.moe_top_k) * 2 * (
            cfg.dim * cfg.intermediate)
        n -= cfg.n_layers * max(inactive, 0)
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq_len
    return 6.0 * n + attn / 2

#: Relative bar on every kernel output: a correct bf16 kernel reads
#: about 0.4% of max|ref|; an output left at zero or computed from the
#: wrong rows reads order 100%.
REL_TOL = 1e-2
#: The same bars for f32 inputs, which the f32 kernels multiply in
#: three-term TF32 on the tensor cores: their f32 outputs read about 1e-7
#: to 1e-6 of the plain f32 version's, while the plain
#: version with one-term TF32 or bf16 products reads order 1e-4 or more
#: (the controls of phase (b)).
F32_REL_TOL = 1e-5
#: The verify recipe's absolute bars, for its upstream gradient only.
OUT_TOL = 0.05
GRAD_TOL = 0.01
LSE_TOL = 1e-3
LOGITS_TOL = 0.1  # bf16 model, flash vs reference attention, 2 layers
#: Bar of the serving phase's bf16 logits, against the f32 forward of
#: the same weights: at most this many times the error of the bf16
#: `llama.forward` itself. A flat REL_TOL does not fit bf16 logits: the
#: bf16 forward itself lies about 1% (relative L2) from the f32 one, and
#: the serving path's bf16 arithmetic as far.
NOISE_RATIO = 2.0

#: Device-side names of every launch of the attention ops: the wgmma
#: pair's, the "any" pair's (`flash_fwd_wgmma_kernel`,
#: `flash_fwd_tf32_kernel`, `flash_bwd_any_pre_kernel`, ...) and the
#: "wide" pair's (16-bit `flash_fwd_wide_wgmma_kernel` and
#: `flash_bwd_wide_wgmma_kernel`, f32 `flash_fwd_wide_tf32_kernel`);
#: `flash_bwd_wide_tf32_kernel` is the f32 backward's main kernel at
#: every head_dim.
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_pre_kernel",
                 "flash_bwd_kernel", "flash_bwd_dq_kernel",
                 "flash_fwd_wgmma_kernel", "flash_fwd_tf32_kernel",
                 "flash_bwd_any_pre_kernel", "flash_bwd_wgmma_kernel",
                 "flash_bwd_any_dq_kernel",
                 "flash_bwd_any_dq_ordered_kernel",
                 "flash_fwd_wide_wgmma_kernel", "flash_fwd_wide_tf32_kernel",
                 "flash_bwd_wide_wgmma_kernel", "flash_bwd_wide_tf32_kernel")
#: The backward op's launches, by launch counter.
BWD_LAUNCHES = ("flash_bwd_pre", "flash_bwd", "flash_bwd_dq")

TRAIN_STEPS = 8
N_LAYERS = 4
#: Phase (f): steps per remat policy, and the policies.
REMAT_STEPS = 4
REMAT_POLICIES = ("full", "dots", "dots_flash")
#: (f1) The three policies run one forward on the same weights and
#: batch, so their step-1 losses agree to the bit; the bar only absorbs
#: printing. Their backward differs in what it recomputes, and the
#: flash backward's dq sums in f32 in no fixed order, so a few bf16
#: gradient elements may round the other way: the step-1 grad norms
#: read within 4e-6 of each other (PERF.md), and the bar leaves 12x.
REMAT_LOSS_REL = 1e-6
REMAT_GNORM_REL = 5e-5
#: (f1) every step's loss under "dots" and "dots_flash" against "full",
#: and (f2) the mesh step's against (f1)'s dots_flash: step 1 is the same
#: computation on the same inputs (FSDP2 over one rank gathers and
#: reduces nothing); from step 2 on, updates of at most 3e-4 per element
#: (lr under warmup) may differ where a gradient rounds the other way,
#: which moved the step-4 loss by at most 3.0e-4 relative (PERF.md). A
#: wrong gradient in one layer moves that layer's whole update, and the
#: loss falls by 40% over these steps.
MESH_LOSS_REL = 1e-3
SERVE_LAYERS = 32
BATCH, SEQ = 2, 4096
#: Phase (g): microbatches of the pipeline step, and the MoE model's
#: steps, depth and experts.
PP_MICROBATCHES = 2
PP_MOE_STEPS = 3
PP_MOE_LAYERS, PP_MOE_EXPERTS, PP_MOE_TOP_K = 2, 8, 2
#: (g3) `moe_ffn_ep` over an ep group of one against `moe_ffn_dense`: the
#: same products in another order; its aux loss reads the same routing.
MOE_TOKENS = 8192
AUX_TOL = 1e-3
#: `--cards 4`: the four-card runs' step-1 losses against one card's on
#: the same weights and batch. Ring attention is plain f32 products where
#: one card runs the bf16 flash kernels, expert parallelism sums the
#: experts' products in another order and averages the aux loss over
#: each rank's own tokens, and bf16 GEMMs of other shapes round
#: otherwise: each moves a bf16 loss by about 1e-4 relative; a wrong
#: shard or a missing gradient sum moves it by far more than 1e-2.
CARDS4_LOSS_REL = 1e-2
#: `--cards 4`: rows of the batch (ep 2 x 2 microbatches).
CARDS4_BATCH = 4
#: `--cards 4`: sp4_long's batch, 1 x CARDS4_LONG_SEQ, the length
#: sequence parallelism exists for: over sp 4 each rank runs the flash
#: kernels on 8 of the 32 heads over all 16384 positions.
CARDS4_LONG_SEQ = 16384
#: Phase (g4), the MPMD pipeline. (g4a) at (e1)'s small width in f32,
#: one SGD step, 2 stages of one chunk, 2 microbatches, held to one
#: card's autograd at the bars of the reference's own parity test
#: (`tests/test_pipeline_mpmd.py`): the loss absolutely, the parameters
#: after the step relatively.
MPMD_SMALL = {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4,
              "n_kv_heads": 2, "intermediate": 512, "max_seq_len": 256}
MPMD_SMALL_BATCH, MPMD_SMALL_SEQ, MPMD_SMALL_LR = 4, 64, 0.1
MPMD_LOSS_ABS = 2e-5
MPMD_PARAM_RTOL, MPMD_PARAM_ATOL = 2e-4, 2e-5
#: (g4b) the Llama-2-7B width at MPMD_LAYERS, bf16, remat "full", phase
#: (c)'s seed, MPMD_STEPS steps of `default_optimizer` on a batch of
#: MPMD_MICROBATCHES x SEQ in microbatches of 1, under each schedule:
#: (label, chunks per stage) over 2 stages that share the card.
MPMD_SEED = 0
MPMD_LAYERS = 4
MPMD_STEPS = 3
MPMD_MICROBATCHES = 4
MPMD_SCHEDULES = (("1f1b", 1), ("interleaved", 2))
#: `--cards 4`: 4 stages, one per card, at the 7B width on
#: CARDS4_MPMD_LAYERS layers, CARDS4_MPMD_MICROBATCHES x SEQ in
#: microbatches of 1, against one card's loss (CARDS4_LOSS_REL).
CARDS4_MPMD_LAYERS = 8
CARDS4_MPMD_MICROBATCHES = 8
#: Phase (k): DATA_ROWS rows of SEQ + 1 tokens in DATA_FILES .npy files,
#: read in batches of BATCH, so (k1) runs DATA_ROWS / BATCH steps and
#: reads each row once. The tokens lie below DATA_VOCAB: which ids occur
#: is what one batch teaches the next, so the loss falls over rows it has
#: not seen (over the whole vocabulary, distinct random rows teach
#: nothing that carries to the next row).
DATA_ROWS, DATA_FILES = 64, 4
DATA_VOCAB = 512
DATA_SHUFFLE_SEED = 17
#: (k2): the Tuner's trials, (k1)'s loop at TUNE_LAYERS layers and
#: TUNE_STEPS steps, one trial a learning rate.
TUNE_LAYERS, TUNE_STEPS = 2, 4
TUNE_LRS = (1e-4, 3e-4, 1e-3)
#: Phase (l), the cluster surface, on one card (see the module's doc).
#: CLUSTER_MEM_SLACK: how far the card's free memory after `stop` may lie
#: below its value before `start` (a process left holding a CUDA context
#: costs about 500 MiB). CLUSTER_IDLE_S: (l3)'s idle timeout.
#: CLUSTER_FLASH_SHAPE: (l3)'s flash forward, 32 heads of 128 over SEQ
#: tokens (the Llama-2-7B width); (l4) maps CLUSTER_POOL_CALLS of them.
#: CLUSTER_TIMEOUT_S: the most any of (l)'s waits takes.
CLUSTER_MEM_SLACK = 256 << 20
CLUSTER_IDLE_S = 3.0
CLUSTER_FLASH_SHAPE = (1, 32, SEQ, 128)
CLUSTER_POOL_CALLS = 8
CLUSTER_TIMEOUT_S = 600.0
#: Dense f32 peak of an H100 SXM outside the tensor cores, and its dense
#: TF32 tensor-core peak (NVIDIA data sheet). An f32 kernel's operations
#: bound is the lesser of its products at 67 TFLOP/s and the same
#: products as three TF32 terms at 495 TFLOP/s (`f32_ops_ms`): the least
#: time the card could take for f32 work, whichever route a kernel takes.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_TERMS = 3
#: The "any" and "wide" kernels' checks (phase (b)): (label, dtype, bh,
#: t, tk, d, causal, q_len, kv_len). bf16 and f16 at d 256 (Gemma), f32
#: at d 128 and 256, f16 at d 128, bf16 at d 192, d 96 (Phi-3) and d 16
#: (`LlamaConfig.tiny`), whose last 64-column box overhangs the row; d
#: 320 and 512 in every dtype (the "wide" kernels), 352 in bf16 and f16
#: (the wide wgmma kernel's last box overhangs the row, its last chunk 2
#: boxes; at 320 1 box), 608 and 704 (Q no longer resident: its boxes
#: come through the ring; three chunks, the last of 2 and 3 boxes); and
#: the edges of the 16-bit kernels' 128-row q and 64-row KV tiles and of
#: the f32 kernel's (q tiles of two 64-row consumers up to d 192, of one
#: above; KV tiles of 64 rows up to d 128, 32 above; a 32-column last
#: chunk of O at d 32, 96, 160 and 224): t 64 (half a q tile) and 192,
#: kv_len inside a tile, causal t_q != t_k (against the plain version,
#: whose mask is the kernels' top-left one), and q rows past q_len; and
#: the f32 "wide" pair's (64-row q tiles and 32-row KV tiles of the
#: forward, 32-row KV tiles and 64-row q tiles of the backward): d 352 (a
#: 32-column last K box, a 96-column last chunk), 608 and 704 (Q2 read
#: from global memory; three chunks, the last of 96 and 192 columns), t
#: 64, kv_len 170 inside a KV tile, ragged q_len, causal t_q != t_k; the
#: 16-bit "wide" backward's (64-row KV and q tiles, boxes through a ring)
#: at t 64, kv_len inside a tile, ragged q_len and causal t_q != t_k both
#: ways, and the f32 backward's up to 256 (8 to 32 columns a warp) at t
#: 64, kv_len inside a 32-row KV tile, ragged q_len and t_q != t_k.
ANY_CASES = (
    ("bf16_d256", "bfloat16", 16, 1024, 1024, 256, True, 1024, 1024),
    ("f32_d128", "float32", 16, 512, 512, 128, True, 512, 512),
    ("f32_d256", "float32", 8, 512, 512, 256, True, 512, 512),
    ("f16_d128", "float16", 16, 512, 512, 128, True, 512, 512),
    ("bf16_d96", "bfloat16", 8, 512, 512, 96, True, 512, 512),
    ("bf16_d16", "bfloat16", 8, 512, 512, 16, True, 512, 512),
    ("t64_d256", "bfloat16", 8, 64, 64, 256, True, 64, 64),
    ("t192_f32_d128", "float32", 8, 192, 192, 128, True, 192, 192),
    ("kvlen200_d256", "bfloat16", 8, 256, 256, 256, False, 256, 200),
    ("q128k384_causal_f32_d256", "float32", 8, 128, 384, 256, True, 128,
     384),
    ("ragged_f16_d96", "float16", 8, 320, 320, 96, True, 300, 300),
    ("f16_d256", "float16", 16, 1024, 1024, 256, True, 1024, 1024),
    ("bf16_d192", "bfloat16", 8, 512, 512, 192, True, 512, 512),
    ("t192_d256", "bfloat16", 8, 192, 192, 256, True, 192, 192),
    ("t64_f16_d192", "float16", 8, 64, 64, 192, True, 64, 64),
    ("kvlen40_d192", "bfloat16", 8, 128, 128, 192, False, 128, 40),
    ("kvlen100_f16_d256", "float16", 8, 256, 256, 256, False, 256, 100),
    ("ragged_d256", "bfloat16", 8, 320, 320, 256, True, 300, 300),
    ("q128k384_causal_d256", "bfloat16", 8, 128, 384, 256, True, 128, 384),
    ("q384k128_causal_f16_d160", "float16", 8, 384, 128, 160, True, 384,
     128),
    ("bf16_d320", "bfloat16", 8, 512, 512, 320, True, 512, 512),
    ("f16_d320", "float16", 8, 256, 256, 320, True, 256, 256),
    ("f32_d320", "float32", 8, 256, 256, 320, True, 256, 256),
    ("bf16_d512", "bfloat16", 8, 512, 512, 512, True, 512, 512),
    ("ragged_f16_d512", "float16", 4, 320, 320, 512, True, 300, 280),
    ("f32_d512", "float32", 4, 256, 256, 512, False, 256, 200),
    ("t64_f32_d256", "float32", 8, 64, 64, 256, True, 64, 64),
    ("kvlen72_f32_d192", "float32", 8, 128, 128, 192, False, 128, 72),
    ("ragged_f32_d224", "float32", 8, 320, 320, 224, True, 300, 270),
    ("q384k128_causal_f32_d64", "float32", 8, 384, 128, 64, True, 384,
     128),
    ("t64_f32_d128", "float32", 8, 64, 64, 128, True, 64, 64),
    ("kvlen40_f32_d96", "float32", 8, 192, 192, 96, False, 192, 40),
    ("ragged_f32_d32", "float32", 8, 320, 320, 32, True, 300, 290),
    ("bf16_d352", "bfloat16", 8, 512, 512, 352, True, 512, 512),
    ("kvlen200_f16_d352", "float16", 8, 256, 256, 352, False, 256, 200),
    ("bf16_d704", "bfloat16", 4, 320, 320, 704, True, 300, 300),
    ("f16_d608", "float16", 4, 256, 256, 608, True, 256, 256),
    ("f32_d352", "float32", 8, 256, 256, 352, True, 256, 256),
    ("f32_d608", "float32", 4, 256, 256, 608, True, 256, 256),
    ("ragged_f32_d704", "float32", 4, 320, 320, 704, True, 300, 290),
    ("t64_f32_d512", "float32", 8, 64, 64, 512, True, 64, 64),
    ("kvlen170_f32_d512", "float32", 4, 256, 256, 512, False, 256, 170),
    ("ragged_f32_d512", "float32", 4, 320, 320, 512, True, 250, 320),
    ("q128k384_causal_f32_d512", "float32", 4, 128, 384, 512, True, 128,
     384),
    ("t64_bf16_d352", "bfloat16", 8, 64, 64, 352, True, 64, 64),
    ("kvlen100_f16_d608", "float16", 4, 256, 256, 608, False, 256, 100),
    ("ragged_bf16_d704", "bfloat16", 4, 320, 320, 704, True, 300, 300),
    ("q128k384_causal_f16_d512", "float16", 4, 128, 384, 512, True, 128,
     384),
    ("q384k128_causal_bf16_d352", "bfloat16", 4, 384, 128, 352, True, 384,
     128),
    ("t64_f32_d32", "float32", 8, 64, 64, 32, True, 64, 64),
    ("kvlen100_f32_d96", "float32", 8, 256, 256, 96, False, 256, 100),
    ("ragged_f32_d256", "float32", 8, 192, 192, 256, True, 170, 192),
    ("q384k128_causal_f32_d96", "float32", 8, 384, 128, 96, True, 384, 128),
)
#: The public op against `mha_reference` in f32 on the same inputs, for
#: the "any" and "wide" kernels: (dtype, head_dim) at b 1 x h 2 x t 512,
#: causal.
ANY_OP_CASES = (("bfloat16", 256), ("float32", 128), ("float32", 256),
                ("float16", 128), ("bfloat16", 96), ("bfloat16", 16),
                ("float16", 256), ("bfloat16", 192),
                ("bfloat16", 320), ("float16", 320), ("float32", 320),
                ("bfloat16", 512), ("float16", 512), ("float32", 512),
                ("bfloat16", 352), ("float32", 64))
#: The "any" and "wide" kernels' timing shapes, by label: Gemma-2B's
#: attention (b 2 x 8 heads, 4096, d 256, causal, bf16), f32 ones with
#: the f32 forward's two consumers (bh 64 x 1024 x 128) and its one (bh 16
#: x 2048 x 256), causal, a "wide" one (bh 16 x 1024 x 512, causal) in
#: bf16, f16 and f32, and the presets' small head_dims at bh 64 x 1024,
#: causal: f32 d 32 (`LlamaConfig.tiny()`'s 16, padded), f32 d 64, bf16
#: d 96 (Phi-3's, run at 128).
ANY_TIMED = (("bf16_d256", "bfloat16", 16, 4096, 256),
             ("f32_d128", "float32", 64, 1024, 128),
             ("f32_d256", "float32", 16, 2048, 256),
             ("bf16_d512", "bfloat16", 16, 1024, 512),
             ("f16_d512", "float16", 16, 1024, 512),
             ("f32_d512", "float32", 16, 1024, 512),
             ("f32_d32", "float32", 64, 1024, 32),
             ("f32_d64", "float32", 64, 1024, 64),
             ("bf16_d96", "bfloat16", 64, 1024, 96))
#: `--against`: the ANY_TIMED shapes at which both trees' "any" and
#: "wide" kernels are timed in turns.
AGAINST_TIMED = ("bf16_d256", "f32_d128", "f32_d256", "bf16_d512",
                 "f32_d512")
#: (h1) the runtime phase: steps in the actor, and the bar of its step 2
#: against the driver's (the backward's dq sums in f32 atomics, in no
#: fixed order; step 1 is the forward alone and must be equal).
RUNTIME_STEPS = 2
RUNTIME_STEP2_REL = 1e-3
#: (h1) the 1 GiB bf16 CPU tensor put and got through the object store.
RUNTIME_PUT_BYTES = 1 << 30
#: (h2) Gemma-2B at full width: steps, batch and sequence.
GEMMA_STEPS = 3
GEMMA_BATCH, GEMMA_SEQ = 1, 4096
#: (h3) the "wide" kernels' path: Gemma-2B's geometry at this head_dim,
#: depth, sequence (batch 1) and steps.
WIDE_HEAD_DIM = 512
WIDE_LAYERS, WIDE_SEQ, WIDE_STEPS = 2, 1024, 3
#: (h3) again in f32 (the f32 "wide" kernels' training path): steps; and
#: (h4), the same steps in f32 at Gemma-2B's own head_dim (the f32 "any"
#: kernels' training path).
WIDE_F32_STEPS = 3
F32_ANY_HEAD_DIM = 256


def cuda_ms(torch, fn, reps):
    """Mean time of `fn` over `reps` runs after one warm-up, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def held(name, got, ref, abs_tol=None, rel_tol=REL_TOL):
    """Print `got`'s error against `ref` and return (within the bars,
    max abs error). Bars: max abs error <= rel_tol * max|ref|, L2 error
    <= rel_tol * ||ref||, and max abs error <= `abs_tol` if given."""
    err, ref_max, rel_l2 = rel_errors(got, ref)
    ok = err <= rel_tol * ref_max and rel_l2 <= rel_tol
    if abs_tol is not None:
        ok = ok and err <= abs_tol
    print(f"  {name}: max err {err:.3g} (max|ref| {ref_max:.3g}), "
          f"rel L2 {rel_l2:.3g}{'' if ok else ' -- outside the bars'}")
    return ok, err


def grads_held(got, ref, q_len, kv_len, abs_tol=None, rel_tol=REL_TOL):
    """`held` over (dq, dk, dv) on their unpadded rows: (all within the
    bars, max abs error of each)."""
    rows = (q_len, kv_len, kv_len)
    checks = [held(name, g[:, :n], r[:, :n], abs_tol, rel_tol)
              for name, g, r, n in zip(("dq", "dk", "dv"), got, ref, rows)]
    return all(ok for ok, _ in checks), [err for _, err in checks]


def valid_pairs(causal, q_len, kv_len):
    """Unmasked (q, kv) pairs of one head: the work this data needs."""
    if not causal:
        return q_len * kv_len
    return sum(min(r + 1, kv_len) for r in range(q_len))


def f32_ops_ms(flops):
    """The least time of `flops` f32 operations: on the CUDA cores, or as
    three TF32 terms on the tensor cores, whichever is less."""
    return min(flops / PEAK_F32_FLOPS,
               TF32_TERMS * flops / PEAK_TF32_FLOPS) * 1e3


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(least time in ms, "operations" or "bytes"): the larger of `flops`
    at `peak` (None: f32 work, `f32_ops_ms`) and `nbytes` at the HBM
    rate."""
    ops_ms = f32_ops_ms(flops) if peak is None else flops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def print_ptxas(reports, prefix=""):
    """ptxas's report of each kernel: its name (demangled where c++filt
    is at hand), registers, spills and wgmma advisories."""
    for name, report in reports.items():
        for line in report.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1] if "'" in line else line
                try:
                    line = subprocess.run(
                        ["c++filt", mangled], capture_output=True, text=True,
                        timeout=30, check=True).stdout.strip()
                except (OSError, subprocess.SubprocessError):
                    line = mangled
                print(f"  {prefix}{name}: {line[:160]}")
            # C75xx: ptxas's wgmma advisories (a serialised pipeline).
            elif "registers" in line or "spill" in line or "C75" in line:
                print(f"  {prefix}{name}: {line.strip()}")


def load_port(root):
    """The `ray_tpu_torch` package of the checkout at `root`, imported
    beside this one as `against_ray_tpu_torch`."""
    pkg = os.path.join(os.path.abspath(root), "ray_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "against_ray_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    port = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = port
    spec.loader.exec_module(port)
    return port


def alloc_site(frames):
    """The innermost line of the port among an allocation's Python frames
    (innermost first), else the innermost line at all."""
    for f in frames:
        path = f["filename"]
        if "ray_tpu_torch" in path:
            return f"{path[path.rindex('ray_tpu_torch'):]}:{f['line']} {f['name']}"
    if frames:
        f = frames[0]
        return f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"
    return "(no Python frame)"


def peak_allocations(trace, top=8):
    """(bytes allocated at the peak above the recording's start, the
    largest allocations alive at the peak grouped by `alloc_site`), from
    the allocator's recorded history of one device."""
    def replay(stop):
        live, now, best, best_at = {}, 0, 0, -1
        for i, e in enumerate(trace[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                now += e["size"]
            elif e["action"] == "free_requested":
                live.pop(e["addr"], None)
                now -= e["size"]
            if now > best:
                best, best_at = now, i
        return live, best, best_at

    _, best, best_at = replay(len(trace))
    live = replay(best_at + 1)[0]
    sites = collections.Counter()
    for e in live.values():
        sites[alloc_site(e.get("frames", []))] += e["size"]
    return best, [{"site": s, "bytes": b} for s, b in sites.most_common(top)]


def step_memory(torch, port, n_layers, steps=2):
    """Peak device memory of `steps` steps of the slice trained by
    `port` (a `ray_tpu_torch` package) from seed 0, and what is alive at
    the peak."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    llama = port.models.llama
    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
    model = llama.init_params(cfg, gen, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=gen,
                          device=dev)
    init_fn, step_fn = port.train.make_train_step(
        llama.loss_fn,
        port.train.default_optimizer(learning_rate=3e-4, total_steps=20),
        device=dev)
    state = init_fn(model)
    del model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    for _ in range(steps):
        state, _ = step_fn(state, batch[:, :-1], batch[:, 1:])
    torch.cuda.synchronize()
    trace = torch.cuda.memory._snapshot()["device_traces"][dev.index or 0]
    torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()
    above, sites = peak_allocations(trace)
    del state, batch, trace
    torch.cuda.empty_cache()
    return {"max_memory_allocated": peak, "at_start": start,
            "peak_from_history": start + above, "alive_at_peak": sites}


def against(torch, attn, root, randn, n_layers, reps=20):
    """Phase (d): this tree's attention ops against those of the checkout
    at `root`, then each tree's step memory (see the module's doc)."""
    other = load_port(root)
    reports = other.ops._build.build()
    print(f"against {root}: built {', '.join(reports) or 'cached'}")
    print_ptxas(reports, "against ")
    trees = {"against": other.ops.attention, "this": attn}
    bh, t, d = BATCH * 32, SEQ, 128
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = (randn(bh, t, d) for _ in range(4))
    q2 = attn.prescale(q, scale)
    ref_out, ref_lse = attn.flash_forward_plain(q2, k, v, True, t)
    ref_grads = attn.flash_backward_plain(q2, k, v, ref_out, do, ref_lse,
                                          scale, True, t, t)
    fwd, bwd, errors = {}, {}, {}
    for name, tree in trees.items():
        fwd[name] = lambda tree=tree: tree.flash_forward(q2, k, v, True, t)
        out, lse = fwd[name]()
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        # Trees before the op's `torch.library` registration carry it
        # as an autograd Function.
        op = getattr(tree, "flash_attention_bhsd", None) or (
            tree.FlashAttentionFunction.apply)
        o = op(*leaves, scale, True, t, t)
        bwd[name] = lambda o=o, leaves=leaves: torch.autograd.grad(
            o, leaves, do, retain_graph=True)
        print(f"against, {name} tree, held to this tree's plain versions:")
        checks = [held("out", out, ref_out)] + [
            held(n, g, r)
            for n, g, r in zip(("dq", "dk", "dv"), bwd[name](), ref_grads)]
        errors[name] = {"out": checks[0][1], "lse": max_err(lse, ref_lse),
                        "grads": [e for _, e in checks[1:]],
                        "within_bars": all(ok for ok, _ in checks)}
        del out, lse, o, op, leaves
    assert errors["this"]["within_bars"], errors
    del ref_out, ref_lse, ref_grads
    times = {}
    for op, fns, n in (("fwd", fwd, reps), ("bwd_op", bwd, reps // 2)):
        ms = [cuda_ms(torch, fns[name], n)
              for name in ("against", "this", "this", "against")]
        times[op] = {"against_ms": ms[::3], "this_ms": ms[1:3]}
        print(f"against, {op}: {root} {ms[0]:.3f} / {ms[3]:.3f} ms, "
              f"this {ms[1]:.3f} / {ms[2]:.3f} ms")
    del fwd, bwd, fns, q, k, v, do, q2
    torch.cuda.empty_cache()
    any_times = any_against(torch, trees, reps)
    this_port = sys.modules["ray_tpu_torch"]
    memory = {name: step_memory(torch, port, n_layers)
              for name, port in (("against", other), ("this", this_port))}
    for name, m in memory.items():
        print(f"against, {name} tree: peak {m['max_memory_allocated']} B "
              f"(from history {m['peak_from_history']}), alive at the peak:")
        for row in m["alive_at_peak"]:
            print(f"    {row['bytes']:>12} {row['site']}")
    return {"root": root, "shape": [bh, t, d], "causal": True,
            "errors": errors, "times": times, "layers": n_layers,
            "memory": memory, "any": any_times}


def any_against(torch, trees, reps):
    """Phase (d) for the "any" and "wide" pairs: each tree's forward
    kernel and backward op (its `flash_forward` and `flash_backward`) at
    each AGAINST_TIMED shape of ANY_TIMED (Gemma-2B's bf16 d 256, f32 d
    128 and 256, bf16 d 512, f32 d 512), held to this tree's plain
    versions and timed in turns ROOT, this, this, ROOT. Returns {label:
    record}."""
    attn = trees["this"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    timed = {row[0]: row[1:] for row in ANY_TIMED}
    records = {}
    for label in AGAINST_TIMED:
        dt, bh, t, d = timed[label]
        dtype = getattr(torch, dt)
        tol = F32_REL_TOL if dtype == torch.float32 else REL_TOL
        scale = 1.0 / math.sqrt(d)
        q, k, v, do = ((torch.randn(bh, t, d, generator=gen, device=dev)
                        * 0.5).to(dtype) for _ in range(4))
        q2 = attn.prescale(q, scale)
        ref_out, ref_lse = attn.flash_forward_plain(q2, k, v, True, t)
        ref_grads = attn.flash_backward_plain(q2, k, v, ref_out, do, ref_lse,
                                              scale, True, t, t)
        errors, fwd, bwd = {}, {}, {}
        for name, tree in trees.items():
            out, lse = tree.flash_forward(q2, k, v, True, t)
            args = (q2, k, v, out, do, lse, scale, True, t, t)
            print(f"against, {name} tree's {attn._kernel_for(dtype, d)!r} "
                  f"pair ({dt}, {(bh, t, d)}), held to this tree's plain "
                  "versions:")
            checks = [held("out", out, ref_out, rel_tol=tol)] + [
                held(n, g, r, rel_tol=tol) for n, g, r in zip(
                    ("dq", "dk", "dv"), tree.flash_backward(*args),
                    ref_grads)]
            errors[name] = {"out": checks[0][1],
                            "lse": max_err(lse, ref_lse),
                            "grads": [e for _, e in checks[1:]],
                            "within_bars": all(ok for ok, _ in checks)}
            fwd[name] = lambda tree=tree: tree.flash_forward(q2, k, v, True,
                                                             t)
            bwd[name] = lambda tree=tree, args=args: tree.flash_backward(
                *args)
        assert errors["this"]["within_bars"], (label, errors)
        del ref_out, ref_lse, ref_grads
        times = {}
        for op, fns, n in (("fwd", fwd, reps), ("bwd_op", bwd, reps // 2)):
            ms = [cuda_ms(torch, fns[name], n)
                  for name in ("against", "this", "this", "against")]
            times[op] = {"against_ms": ms[::3], "this_ms": ms[1:3]}
            print(f"against, {label} {op}: other {ms[0]:.4f} / {ms[3]:.4f} "
                  f"ms, this {ms[1]:.4f} / {ms[2]:.4f} ms")
        del fwd, bwd, q, k, v, do, q2
        torch.cuda.empty_cache()
        records[label] = {"shape": [bh, t, d], "dtype": dt, "causal": True,
                          "errors": errors, "times": times}
    return records


def rel_errors(got, ref):
    """(max abs error, max|ref|, relative L2 error) of `got` against
    `ref`, in f32."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    return (diff.abs().max().item(), ref.abs().max().item(),
            (diff.norm() / ref.norm()).item())


def percentile(xs, q):
    """The q-th percentile (0-100) of `xs`, nearest rank."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


def held_steps(name, got, teacher, truth):
    """Hold each step of `got` [b, steps, vocab] (bf16 serving logits) to
    `truth`, the f32 forward of the same weights at the same positions:
    its max abs error and relative L2 error must each be at most
    NOISE_RATIO times the bf16 `teacher`'s own over all the steps. As a
    control that must fail, each step but the last is held to `truth`
    one position later. Returns the max abs error against `teacher`."""
    steps = got.shape[1]
    floor_err, _, floor_l2 = rel_errors(teacher, truth)

    def ok(e):
        return e[0] <= NOISE_RATIO * floor_err and e[2] <= NOISE_RATIO * floor_l2

    errors = [rel_errors(got[:, i], truth[:, i]) for i in range(steps)]
    shifted = [rel_errors(got[:, i], truth[:, i + 1]) for i in range(steps - 1)]
    to_teacher = rel_errors(got, teacher)
    print(f"  {name}, {steps} steps against the f32 forward: max err up to "
          f"{max(e[0] for e in errors):.4g} (max|ref| "
          f"{max(e[1] for e in errors):.4g}), rel L2 up to "
          f"{max(e[2] for e in errors):.4g}; bf16 forward's own: max err "
          f"{floor_err:.4g}, rel L2 {floor_l2:.4g}; against the bf16 forward: "
          f"max err {to_teacher[0]:.4g}, rel L2 {to_teacher[2]:.4g}; shifted "
          f"one position (must be outside the bars): rel L2 from "
          f"{min(e[2] for e in shifted):.4g}")
    assert all(ok(e) for e in errors), (name, errors, floor_err, floor_l2)
    assert not any(ok(e) for e in shifted), (name, "control", shifted)
    return to_teacher[0]


def greedy_counts(torch, teacher, requests, outs, delta, dev):
    """Count the served tokens of `outs` (one list per prompt of
    `requests`) that lie within `delta` of their row's maximum in the
    teacher-forced logits `teacher(seq)`, and (the control) those within
    delta of the next position's row."""
    n = exact = consistent = control = 0
    worst_gap = 0.0
    for p, out in zip(requests, outs):
        seq = torch.tensor([p + out[:-1]], device=dev)
        ref = teacher(seq)[0, len(p) - 1:]  # the logits each token came from
        toks = torch.tensor(out, device=dev)
        top = ref.max(dim=-1).values
        gap = top - ref.gather(1, toks[:, None])[:, 0]
        shifted = top[1:] - ref[1:].gather(1, toks[:-1, None])[:, 0]
        n += len(out)
        exact += int((ref.argmax(-1) == toks).sum())
        consistent += int((gap <= delta).sum())
        control += int((shifted <= delta).sum())
        worst_gap = max(worst_gap, gap.max().item())
        del seq, ref
    return {"tokens": n, "consistent": consistent, "exact_argmax": exact,
            "control_within_delta": control, "largest_gap": worst_gap,
            "delta": delta}


def greedy_consistency(torch, teacher, requests, outs, delta, dev, label):
    """Hold each served token of `outs` within `delta` of its row's
    maximum in the teacher-forced logits (`greedy_counts`); as a control
    that must fail, hold each token to the next position's logits.
    Prints the counts; returns them."""
    counts = greedy_counts(torch, teacher, requests, outs, delta, dev)
    n, consistent = counts["tokens"], counts["consistent"]
    control, worst_gap = counts["control_within_delta"], counts["largest_gap"]
    print(f"{label}: greedy consistency, delta {delta:.4g}: {consistent} "
          f"of {n} tokens within delta of their row's maximum (largest gap "
          f"{worst_gap:.4g}), exact argmax {counts['exact_argmax']} of {n} (no "
          f"bar); control, tokens against the next position's logits: "
          f"{control} of {n - len(requests)} within delta (must not be all)")
    assert consistent == n, (label, consistent, n, worst_gap, delta)
    assert control < n - len(requests), (label, control)
    return counts


def paged_run(torch, model, cfg, tokens, steps, chunk, tables, bl, dev):
    """`paged_prefill` of `tokens` [b, t] in `chunk`-token chunks, then
    `steps` greedy `paged_decode_step`s, on a pool of `bl`-token pages
    laid out by `tables`: (each step's logits [b, steps + 1, vocab], the
    sequence with its decoded tokens)."""
    from ray_tpu_torch.models import generate as gen

    b, t = tokens.shape
    pool = gen.init_block_pool(cfg, tables.numel() + 1, bl, device=dev)
    for off in range(0, t, chunk):
        logits, pool = gen.paged_prefill(model, cfg, tokens[:, off:off + chunk],
                                         pool, tables, off, off + chunk)
    got, seq = [logits[:, -1]], tokens
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    for i in range(steps):
        tok, pool, last = gen.paged_decode_step(
            model, cfg, pool, tables, got[-1],
            torch.full((b,), t + i, device=dev), alive)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        got.append(last)
    return torch.stack(got, 1), seq


#: The serving cell's decode shape (gpubench's qwen3-8b-serve-chat): 32
#: rows, 8 KV heads of 128, groups of 4, tables of 96 blocks of 16, bf16.
PAGED_SHAPE = {"rows": 32, "kv_heads": 8, "group": 4, "head_dim": 128,
               "block_len": 16, "table_blocks": 96}
PAGED_REPS = 200


def paged_lengths(rows):
    """Row lengths of a decode batch of the serving mix: the first `rows`
    requests of `gpubench.traffic.serve_requests` (gpubench/mixes/
    serve-chat.json; lengths at evenly spaced quantiles, as the cell
    sends them), each row that far into its output: request i at the
    (i + 0.5) / rows share of its output tokens."""
    from gpubench import traffic

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gpubench", "mixes", "serve-chat.json")
    with open(path) as f:
        mix = json.load(f)
    reqs = traffic.serve_requests(mix, 0, rows / mix["rate_per_s"], 2)
    return [len(r.prompt) + math.ceil(r.output_tokens * (i + 0.5) / rows)
            for i, r in enumerate(reqs)]


def paged_decode_times(torch, reps=PAGED_REPS):
    """The paged decode kernel alone at PAGED_SHAPE, lengths from
    `paged_lengths`, held to its plain version once, then timed beside
    its bound (the live rows' K/V, q and the output once at the HBM
    rate), the plain version and `scaled_dot_product_attention` over the
    same rows gathered contiguous and masked to their lengths (a
    yardstick only: the port never calls it). One pool: its live K/V
    (about 128 MB) exceeds the 50 MB L2, so the reads come from HBM.

    The kernel and SDPA are timed by their device time under
    torch.profiler (`ms`, `library_ms`): back to back, a call of the
    wrapper can take the host longer than the kernel takes the card, and
    CUDA events would then time the host. `launch_ms` is that events'
    time of back-to-back wrapper calls, host included."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import paged_attention as pa

    s, dev = PAGED_SHAPE, torch.device("cuda")
    rows, kvh, d = s["rows"], s["kv_heads"], s["head_dim"]
    bl, nb = s["block_len"], s["table_blocks"]
    g = torch.Generator(device=dev).manual_seed(7)
    lengths = paged_lengths(rows)

    def randn(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)

    tables = (torch.randperm(rows * nb, generator=g, device=dev) + 1).view(
        rows, nb)
    pos = torch.tensor([n - 1 for n in lengths], device=dev)
    q = randn(rows, kvh * s["group"], 1, d)
    k, v = randn(rows, kvh, 1, d), randn(rows, kvh, 1, d)
    pools = [randn(rows * nb + 1, kvh, bl, d) for _ in range(2)]
    args = (q, k, v, *pools, tables, pos[:, None], pos + 1)
    pa.reset_launch_counts()
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(q, k, v, pools[0].clone(),
                                   pools[1].clone(), *args[5:])
    print(f"paged decode {s}, lengths mean {statistics.fmean(lengths):.1f} "
          f"(min {min(lengths)}, max {max(lengths)}):")
    ok, err = held("out", out, ref)
    assert ok and pa.LAUNCHES == {"paged_decode": 1}, (err, pa.LAUNCHES)

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        traced = profile_step(torch, lambda: [fn() for _ in range(reps)])
        return traced["device_busy_ms"] / reps

    def kernel():
        return pa.paged_decode_attention(*args)

    kernel_ms = device_ms(kernel)
    launch_ms = cuda_ms(torch, kernel, reps)
    plain_ms = cuda_ms(torch, lambda: pa.paged_attention_plain(*args),
                       max(reps // 20, 3))
    width = max(lengths)
    kc, vc = (x[tables].transpose(1, 2).reshape(rows, kvh, nb * bl, d)
              [:, :, :width].contiguous() for x in pools)
    mask = (torch.arange(width, device=dev)[None, :]
            < torch.tensor(lengths, device=dev)[:, None])[:, None, None]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, kc, vc, attn_mask=mask, enable_gqa=True))
    live = sum(lengths) * kvh * d * 2 * 2 + 2 * nbytes(q)
    bound = live / HBM_BYTES_PER_S * 1e3
    rec = {"shape": s, "dtype": "bf16",
           "lengths_mean": statistics.fmean(lengths), "live_bytes": live,
           "ms": kernel_ms, "launch_ms": launch_ms, "bound_ms": bound,
           "bound_by": "bytes", "bound_share": bound / kernel_ms,
           "plain_ms": plain_ms,
           "library_ms": library_ms, "vs_library": kernel_ms / library_ms,
           "max_abs_err": err}
    print(f"  kernel {kernel_ms:.4f} ms on the device, bound {bound:.4f} ms "
          f"by bytes ({100 * bound / kernel_ms:.1f}%, "
          f"{live / kernel_ms / 1e9:.3f} TB/s); back-to-back wrapper calls "
          f"{launch_ms:.4f} ms; plain {plain_ms:.3f} ms; SDPA "
          f"{library_ms:.4f} ms on the device")
    return rec


def serve_phase(torch, llama, attn, card, n_layers, dev, profile=False):
    """Phase (e), the serving slice (see the module's doc), on device
    `dev`. Returns the `{"serve": ...}` record and (e3)'s requests."""
    import threading

    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import generate as gen
    from ray_tpu_torch.ops import paged_attention

    # The paged decode kernel alone at the serving cell's shape, first,
    # so that its pools stay out of the phase's peak.
    paged = paged_decode_times(torch) if dev.type == "cuda" else None
    g = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats()

    def prompt(n):
        return torch.randint(0, 512, (n,), generator=g, device=dev).tolist()

    # (e1) f32 at a small width: the engine equals `generate` exactly.
    small = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                              n_heads=4, n_kv_heads=2, intermediate=512,
                              max_seq_len=256, dtype=torch.float32,
                              remat=False)
    m_small = llama.init_params(small, g, device=dev)
    shared = prompt(64)
    prompts = [shared + prompt(23), shared + prompt(50), prompt(20),
               prompt(97), prompt(41), prompt(130)]
    eng = InferenceEngine(m_small, small, EngineConfig(
        slots=4, max_len=256, prefill_chunk=32, prefix_cache=True,
        max_new_tokens=24))
    try:
        streams = [eng.submit(p) for p in prompts[:5]]
        first = next(streams[0])  # request 0 decodes ...
        streams.append(eng.submit(prompts[5]))  # ... when this one arrives
        outs = [[first] + list(streams[0])] + [list(s) for s in streams[1:]]
        small_stats = eng.stats()
    finally:
        eng.close()
    for p, out in zip(prompts, outs):
        want, _ = gen.generate(m_small, torch.tensor([p], device=dev),
                               torch.tensor([len(p)], device=dev), small,
                               max_new_tokens=24)
        assert out == want[0].tolist(), (len(p), out, want[0].tolist())
    assert small_stats["prefix_hits"] >= 1, small_stats
    print(f"serve (e1), f32 small width: 6 requests through the engine equal "
          f"generate token for token; prefix hits "
          f"{small_stats['prefix_hits']}")
    del m_small, eng

    # (e2) full width, bf16: cached and paged logits against
    # teacher-forced `llama.forward`.
    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, remat=False)
    model = llama.init_params(cfg, g, device=dev)
    b, t, steps, chunk, bl = 2, 1024, 16, 256, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev)

    # The f32 model of the same weights gives the truth both bf16 paths
    # are held to.
    m32 = llama.Llama(dataclasses.replace(cfg, dtype=torch.float32,
                                          attention="reference"), device=dev)
    m32.load_state_dict(model.state_dict())

    def teacher(seq, m=model):
        with torch.no_grad():
            return llama.forward(m, seq)

    def forced(seq):
        """(bf16, f32) teacher-forced logits of the last steps + 1."""
        return (teacher(seq)[:, t - 1:], teacher(seq, m32)[:, t - 1:])

    cache = gen.init_kv_cache(cfg, b, t + steps, device=dev)
    logits, cache = gen.prefill(model, cfg, tokens, cache, 0, t)
    got, seq = [logits[:, -1]], tokens
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    for i in range(steps):
        tok, cache, last = gen.decode_step(model, cfg, cache, got[-1], t + i,
                                           alive)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        got.append(last)
    del cache, logits
    print(f"serve (e2), {cfg.n_layers} layers bf16, batch {b} x {t} + {steps} "
          "steps, against teacher-forced llama.forward:")
    err_cached = held_steps("prefill + decode_step", torch.stack(got, 1),
                            *forced(seq))
    nb = (t + steps) // bl
    order = torch.randperm(b * nb, generator=g, device=dev) + 1
    paged_attention.reset_launch_counts()
    got, seq = paged_run(torch, model, cfg, tokens, steps, chunk,
                         order.view(b, nb), bl, dev)
    e2_launches = paged_attention.LAUNCHES["paged_decode"] / steps
    print(f"  paged decode kernel launches a decode step: {e2_launches} "
          f"({cfg.n_layers} layers)")
    assert e2_launches == cfg.n_layers, paged_attention.LAUNCHES
    err_paged = held_steps("paged_prefill + paged_decode_step", got,
                           *forced(seq))
    del got, seq, tokens, m32
    torch.cuda.empty_cache()
    # A served token's teacher-forced logit is at most 2 x this error
    # below its row's maximum (each of the two logits moves by at most
    # the error); x1.5 for the server's longer sequences.
    delta = 3.0 * max(err_cached, err_paged)

    # (e3) the server: 16 requests sharing a 512-token system prefix.
    ec = EngineConfig(slots=8, max_len=2048, prefill_chunk=256,
                      prefix_cache=True, max_new_tokens=64)
    system = torch.randint(0, cfg.vocab_size, (512,), generator=g,
                           device=dev).tolist()
    tails = torch.randint(64, 1025, (16,), generator=g, device=dev).tolist()
    requests = [system + torch.randint(0, cfg.vocab_size, (n,), generator=g,
                                       device=dev).tolist() for n in tails]
    from ray_tpu_torch._private import compile_watch

    compile_watch.reset()  # (j2)'s window: (e3)'s engine
    eng = InferenceEngine(model, cfg, ec, family="llama2_7b")
    outs = [[] for _ in requests]
    arrivals = [[] for _ in requests]
    try:
        attn.reset_launch_counts()
        paged_attention.reset_launch_counts()
        t0 = time.perf_counter()
        streams = [eng.submit(p) for p in requests]

        def consume(i):
            for tok in streams[i]:
                arrivals[i].append(time.perf_counter())
                outs[i].append(tok)

        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(len(streams))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall_s = time.perf_counter() - t0
        serve_launches = dict(attn.LAUNCHES)
        paged_launches = paged_attention.LAUNCHES["paged_decode"]
        stats = eng.stats()
    finally:
        eng.close()
    watch = {"engine_compiles": stats["compiles"],
             "counts": watch_counts(["engine.", "generate."])}
    reasons = [s.finish_reason for s in streams]
    assert reasons == ["length"] * len(streams), reasons
    assert all(len(o) == ec.max_new_tokens for o in outs)
    assert stats["prefix_hits"] >= 1, stats
    assert not any(serve_launches.values()), serve_launches
    decode_steps = sum(r["steps"] for r in stats["decode_by_batch"].values())
    assert paged_launches == cfg.n_layers * decode_steps, (
        paged_launches, decode_steps)

    # Greedy consistency against teacher-forced logits (these launch the
    # forward kernel: the counters were read above). The control holds
    # each token to the logits one position later, and must fail.
    greedy = greedy_consistency(torch, teacher, requests, outs, delta, dev,
                                "serve (e3)")

    ttft = [(a[0] - t0) * 1e3 for a in arrivals]  # all submitted at t0
    gaps = [(y - x) * 1e3 for a in arrivals for x, y in zip(a, a[1:])]
    full = stats["decode_by_batch"].get(ec.slots, {"steps": 0, "ms": 0.0})
    decode_ms = sum(r["ms"] for r in stats["decode_by_batch"].values())
    step_ms_full = full["ms"] / full["steps"] if full["steps"] else None
    # The decode bound at a full batch: the weights and the live KV of
    # 8 rows read once, at the run's mean live length.
    kv_per_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    mean_live = (sum(len(p) for p in requests) / len(requests)
                 + ec.max_new_tokens / 2)
    weight_bytes = cfg.num_params() * 2
    bound = (weight_bytes + ec.slots * mean_live * kv_per_token) / HBM_BYTES_PER_S
    serve = {
        "card": card,
        "config": f"llama2_7b, {cfg.n_layers} layers, bf16, random init",
        "engine": dataclasses.asdict(ec),
        "requests": len(requests), "prompt_tokens": [len(p) for p in requests],
        "new_tokens": ec.max_new_tokens, "wall_s": wall_s,
        "ttft_ms_p50": percentile(ttft, 50), "ttft_ms_p99": percentile(ttft, 99),
        "ttft_ms_mean": statistics.fmean(ttft), "ttft_ms_by_request": ttft,
        "itl_ms_p50": percentile(gaps, 50), "itl_ms_p99": percentile(gaps, 99),
        "decode_tokens_per_s": stats["tokens_emitted"] / (decode_ms / 1e3),
        "decode_step_ms_full_batch": step_ms_full,
        "decode_steps_full_batch": full["steps"],
        "decode_by_batch": stats["decode_by_batch"],
        "decode_bound_ms_full_batch": bound * 1e3,
        "decode_bound_mean_live_tokens": mean_live,
        "prefill_tokens_per_s": stats["prefill_tokens"] / (stats["prefill_ms"] / 1e3),
        "prefill_chunks": stats["prefill_chunks"],
        "prefix_hits": stats["prefix_hits"],
        "prefix_tokens_saved": stats["prefix_tokens_saved"],
        "pool_bytes": stats["kv_bytes"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "logits_max_err": {"cached": err_cached, "paged": err_paged},
        "delta": delta,
        "exact_argmax_share": greedy["exact_argmax"] / greedy["tokens"],
        "flash_launches_while_serving": serve_launches,
        "paged_decode_launches_per_step": {
            "e2": e2_launches, "e3": paged_launches / decode_steps},
        "paged_decode_launches_e3": paged_launches,
        "paged_decode": paged,
    }
    print(f"serve (e3): {len(requests)} requests in {wall_s:.2f} s; decode "
          f"step at batch {ec.slots} {step_ms_full} ms (bound "
          f"{bound * 1e3:.3f} ms); TTFT p50 {serve['ttft_ms_p50']:.1f} ms; "
          f"paged decode kernel launches a decode step "
          f"{paged_launches / decode_steps} ({decode_steps} steps)")
    # (j4): the watch's hot path on a decode step's arguments, as the
    # engine passes them (its pool, tables, logits, positions, mask).
    decode_args = (model, cfg, eng._kv.pool,
                   torch.tensor(eng._tables, device=dev), eng._last_logits,
                   torch.tensor(eng._positions, device=dev),
                   torch.tensor(eng._alive, device=dev),
                   eng._seeded(eng._steps))
    watch.update(hot_path_us=hot_path_us(
        decode_args, {"temperature": ec.temperature, "top_k": ec.top_k}),
        step_ms=step_ms_full)
    serve["compile_watch"] = watch
    del eng, decode_args
    if profile:
        serve["profile"] = profile_serving(torch, gen, model, cfg, ec,
                                           round(mean_live), dev)
    del model
    torch.cuda.empty_cache()
    return serve, requests


#: (e4): the seed of the app's weights (`build_model`'s "init" kind),
#: the seconds a dropped stream's slot has to come free, and the token
#: budget of the stream that is dropped.
APP_SEED = 12
APP_CANCEL_S = 30.0
APP_CANCEL_BUDGET = 1024
#: (e4)'s f32 check: (e1)'s small width (with room for the app's
#: max_len), its prompts' lengths and tokens each.
APP_SMALL = {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4,
             "n_kv_heads": 2, "intermediate": 512, "max_seq_len": 2048,
             "dtype": "float32", "remat": False}
APP_SMALL_PROMPTS = (87, 114, 20, 300)
APP_SMALL_TOKENS = 24


def http_stream(port, path, body, timeout=600.0):
    """POST `body` as JSON to the proxy on localhost `port` and yield
    (arrival time, chunk) for each chunk of the chunked response, read
    off the socket as sent. A body that ends without its last chunk
    raises; closing the generator closes the connection."""
    import socket

    data = json.dumps(body).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        sock.sendall(
            f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n"
            .encode() + data)
        reader = sock.makefile("rb")
        status = reader.readline()
        assert status.split()[1:2] == [b"200"], status
        headers = {}
        for line in iter(reader.readline, b"\r\n"):
            assert line, "connection closed inside the headers"
            key, _, value = line.decode().partition(":")
            headers[key.strip().lower()] = value.strip()
        assert headers.get("transfer-encoding") == "chunked", headers
        while True:
            size = reader.readline().strip()
            assert size, "chunked body ended without its last chunk"
            if int(size, 16) == 0:
                return
            chunk = reader.read(int(size, 16))
            assert reader.read(2) == b"\r\n", "malformed chunk"
            yield time.perf_counter(), chunk
    finally:
        sock.close()


#: (e4): the request path's spans (serve/observability.py) read back from
#: the head's metrics: the engine's TTFT (submit to first token), the
#: replica's queue wait (router send to handler start), the router's pick
#: and the proxy's whole request.
APP_SPANS = ("serve_engine_ttft_ms", "serve_queue_wait_ms",
             "serve_router_routing_ms", "serve_http_request_latency_ms")


def app_spans(metrics_summary, app, counts, timeout=30.0):
    """{series: (count, sum, p50, p99)} of `app`'s APP_SPANS in the head's
    metrics, once each series holds at least `counts[series]`
    observations (the processes flush their records every half second);
    fails after `timeout` s."""
    deadline = time.perf_counter() + timeout
    while True:
        summary = metrics_summary()
        out = {}
        for name in APP_SPANS:
            for flat, series in (summary.get(name, {}).get("by_tags")
                                 or {}).items():
                if f"app={app}" in flat.split("|"):
                    out[name] = (series["count"], series["sum"],
                                 series.get("p50"), series.get("p99"))
        if all(out.get(name, (0,))[0] >= n for name, n in counts.items()):
            return out
        assert time.perf_counter() < deadline, (counts, out)


def token_of(chunk):
    """One stream chunk -> its token id; each chunk is one decimal id
    and a space."""
    text = chunk.decode() if isinstance(chunk, bytes) else str(chunk)
    assert text.endswith(" ") and text[:-1].isdigit(), text
    return int(text)


def serve_app_phase(torch, llama, card, n_layers, e3, requests, dev):
    """Phase (e4), `build_llm_app` behind the port's Serve runtime on
    device `dev` (see the module's doc). `e3` is (e3)'s record and
    `requests` its prompts. Returns the `{"serve_app": ...}` record."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_app
    from ray_tpu_torch.llm.serving import build_model
    from ray_tpu_torch.models import generate as gen
    from ray_tpu_torch.util.metrics import metrics_summary

    seconds = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now
        print(f"serve (e4) {name}: {seconds[name]:.1f} s")

    ec = {"slots": 8, "max_len": 2048, "prefill_chunk": 256,
          "prefix_cache": True, "max_new_tokens": 64}
    new_tokens = ec["max_new_tokens"]
    # (e3)'s model config, Llama-2-7B's widths in bf16, spelled out.
    cfg7 = llama.LlamaConfig.llama2_7b(n_layers=n_layers, remat=False)
    spec = {"kind": "init", "seed": APP_SEED, "config": {
        name: getattr(cfg7, name) for name in (
            "vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
            "intermediate", "rope_theta", "max_seq_len", "attention",
            "remat")}}
    spec["config"]["dtype"] = str(cfg7.dtype).removeprefix("torch.")
    small = {"kind": "init", "seed": APP_SEED, "config": APP_SMALL}
    # The burst is (e3)'s: 16 prompts of 512 + 64-1024 tokens at once, far
    # past the router's default SLO admission threshold (1024 outstanding
    # tokens a replica), which would shed all but the first; the engine
    # queues what its slots cannot take, as in (e3).
    saved_env = os.environ.get("RT_serve_slo_admission_enabled")
    os.environ["RT_serve_slo_admission_enabled"] = "0"
    on_card = dev.type == "cuda"
    rt.init(num_cpus=4, num_gpus=1 if on_card else 0)
    try:
        t0 = time.perf_counter()
        port = serve.start(http_port=0, per_node=False)  # controller, proxy
        controller_proxy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve.run(build_llm_app({"llama2_7b": spec, "small": small},
                                engine=ec, device=str(dev)),
                  name="llm", route_prefix="/llm")
        replica_start_s = time.perf_counter() - t0
        handle = serve.get_app_handle("llm")
        lap("controller, proxy and replica start")
        # The warm-up pays the replica's model build; it is not timed.
        warm = [token_of(c) for c in handle.options(stream=True).remote(
            {"prompt": requests[0][:32], "max_new_tokens": 2})]
        assert len(warm) == 2, warm
        lap("warm-up (model build)")
        spans0 = app_spans(metrics_summary, "llm", {
            "serve_engine_ttft_ms": 1, "serve_queue_wait_ms": 1})

        # (e3)'s traffic over HTTP, one client thread a request.
        outs = [[] for _ in requests]
        arrivals = [[] for _ in requests]
        sent = [0.0] * len(requests)
        errors = []

        def client(i):
            try:
                sent[i] = time.perf_counter()
                for at, chunk in http_stream(port, "/llm", {
                        "prompt": requests[i],
                        "max_new_tokens": new_tokens}):
                    arrivals[i].append(at)
                    outs[i].append(token_of(chunk))
            except BaseException as e:  # noqa: BLE001 - asserted below
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall_s = time.perf_counter() - t0
        assert not errors, errors
        assert not any(th.is_alive() for th in threads)
        assert all(len(o) == new_tokens for o in outs), [len(o) for o in outs]
        spans1 = app_spans(metrics_summary, "llm", {
            name: spans0.get(name, (0,))[0] + len(requests)
            for name in APP_SPANS})
        # Each span's mean over the burst alone: the warm-up's
        # observations are taken out by difference.
        span_means = {
            name: (spans1[name][1] - spans0.get(name, (0, 0.0))[1])
            / (spans1[name][0] - spans0.get(name, (0,))[0])
            for name in APP_SPANS}
        stats = handle.engine_stats.remote().result(timeout=60)["llama2_7b"]
        device_stats = handle.device_stats.remote().result(timeout=60)
        assert stats["prefix_hits"] >= 1, stats
        lap("traffic")

        # The replica served the weights built here from the same spec:
        # (e3)'s greedy consistency against this model's logits.
        model, cfg = build_model(spec, dev)
        assert cfg == cfg7, cfg

        def teacher(seq):
            with torch.no_grad():
                return llama.forward(model, seq)

        greedy = greedy_consistency(torch, teacher, requests, outs,
                                    e3["delta"], dev, "serve (e4)")
        del model
        torch.cuda.empty_cache()
        lap("greedy consistency")

        # A client drops its stream mid-decode: the slot comes free.
        before = handle.engine_stats.remote().result(timeout=60)["llama2_7b"]
        dropped = http_stream(port, "/llm", {
            "prompt": requests[1][:100], "max_new_tokens": APP_CANCEL_BUDGET})
        next(dropped)
        busy = handle.engine_stats.remote().result(timeout=60)["llama2_7b"]
        assert busy["slots_used"] == 1, busy
        t0 = time.perf_counter()
        dropped.close()
        after = busy
        while (after["slots_used"]
               and time.perf_counter() - t0 < APP_CANCEL_S):
            after = handle.engine_stats.remote().result(
                timeout=60)["llama2_7b"]
        freed_s = time.perf_counter() - t0
        emitted = after["tokens_emitted"] - before["tokens_emitted"]
        assert after["slots_used"] == 0, after
        assert after["requests_done"] == before["requests_done"] + 1, after
        assert emitted < APP_CANCEL_BUDGET, emitted
        later = [token_of(c) for _, c in http_stream(port, "/llm", {
            "prompt": requests[2][:64], "max_new_tokens": 4})]
        assert len(later) == 4, later
        print(f"serve (e4): a dropped stream's slot came free in "
              f"{freed_s * 1e3:.0f} ms, after {emitted} of "
              f"{APP_CANCEL_BUDGET} tokens; a later request was served")
        lap("cancellation")

        # f32 at (e1)'s width through the same app, then the kill switch
        # in an app of its own: equal to `generate`, token for token.
        g = torch.Generator().manual_seed(APP_SEED)
        shared = torch.randint(0, 512, (64,), generator=g).tolist()
        prompts = [shared + torch.randint(0, 512, (n - 64,),
                                          generator=g).tolist()
                   if n > 64 else torch.randint(0, 512, (n,),
                                                generator=g).tolist()
                   for n in APP_SMALL_PROMPTS]
        m_small, small_cfg = build_model(small, dev)
        want = []
        for p in prompts:
            out, _ = gen.generate(m_small, torch.tensor([p], device=dev),
                                  torch.tensor([len(p)], device=dev),
                                  small_cfg, max_new_tokens=APP_SMALL_TOKENS)
            want.append(out[0].tolist())
        del m_small

        def small_paths(app_handle, route):
            for p, w in zip(prompts, want):
                body = {"prompt": p, "max_new_tokens": APP_SMALL_TOKENS,
                        "model": "small"}
                over_handle = [token_of(c) for c in app_handle.options(
                    stream=True).remote(body)]
                over_http = [token_of(c) for _, c in http_stream(
                    port, route, body)]
                assert over_handle == w, (route, len(p), over_handle, w)
                assert over_http == w, (route, len(p), over_http, w)

        small_paths(handle, "/llm")
        serve.delete("llm")
        serve.run(build_llm_app({"small": small}, engine=ec,
                                engine_enabled=False, device=str(dev)),
                  name="llm-fallback", route_prefix="/fallback")
        small_paths(serve.get_app_handle("llm-fallback"), "/fallback")
        print(f"serve (e4), f32 small width: {len(prompts)} requests over "
              "the handle and over HTTP equal generate token for token, "
              "through the engine and through the kill switch")
        lap("f32 exactness")
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            if saved_env is None:
                os.environ.pop("RT_serve_slo_admission_enabled", None)
            else:
                os.environ["RT_serve_slo_admission_enabled"] = saved_env

    ttft = [(a[0] - t) * 1e3 for a, t in zip(arrivals, sent)]
    http_ttft_mean = statistics.fmean(ttft)
    gaps = [(y - x) * 1e3 for a in arrivals for x, y in zip(a, a[1:])]
    full = stats["decode_by_batch"].get(ec["slots"], {"steps": 0, "ms": 0.0})
    record = {
        "card": card,
        "config": f"llama2_7b, {n_layers} layers, bf16, random init "
                  f"(seed {APP_SEED}), build_llm_app, one num_gpus=1 replica",
        "engine": ec, "requests": len(requests), "clients": len(requests),
        "new_tokens": new_tokens, "slo_admission": "off",
        "http": {
            "wall_s": wall_s,
            "ttft_ms_p50": percentile(ttft, 50),
            "ttft_ms_p99": percentile(ttft, 99),
            "itl_ms_p50": percentile(gaps, 50),
            "itl_ms_p99": percentile(gaps, 99),
            "ttft_ms_mean": http_ttft_mean,
            "ttft_ms_by_request": ttft,
        },
        "in_process_e3": {k: e3[k] for k in (
            "wall_s", "ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50",
            "itl_ms_p99", "decode_step_ms_full_batch", "ttft_ms_mean",
            "ttft_ms_by_request")},
        # The burst's mean of each request-path span beside the clients'
        # mean TTFT: what the front end adds before the engine's first
        # token is the HTTP mean less the engine's.
        "span_means_ms": span_means,
        "span_p50_p99_ms_with_warmup": {
            name: spans1[name][2:] for name in APP_SPANS},
        "decode_step_ms_full_batch": (full["ms"] / full["steps"]
                                      if full["steps"] else None),
        "decode_steps_full_batch": full["steps"],
        "decode_by_batch": stats["decode_by_batch"],
        "prefix_hits": stats["prefix_hits"],
        "prefix_tokens_saved": stats["prefix_tokens_saved"],
        "controller_proxy_start_s": controller_proxy_s,
        "replica_start_s": replica_start_s,
        "model_build_s": device_stats["build_s"].get("llama2_7b"),
        "replica_max_memory_allocated": device_stats.get(
            "max_memory_allocated"),
        "greedy": greedy,
        "cancel": {"freed_ms": freed_s * 1e3, "tokens_emitted": emitted,
                   "budget": APP_CANCEL_BUDGET},
        "small_f32_requests": len(prompts),
        "seconds": seconds,
    }
    print(f"serve (e4): {len(requests)} HTTP streams in {wall_s:.2f} s; TTFT "
          f"p50 {record['http']['ttft_ms_p50']:.1f} ms (in process "
          f"{e3['ttft_ms_p50']:.1f}), gap p50 "
          f"{record['http']['itl_ms_p50']:.2f} ms (in process "
          f"{e3['itl_ms_p50']:.2f}); mean TTFT {http_ttft_mean:.1f} ms, "
          f"of it the engine's {span_means['serve_engine_ttft_ms']:.1f}; "
          f"decode step at batch {ec['slots']} "
          f"{record['decode_step_ms_full_batch']} ms; {card}")
    return record


def remat_runs(torch, llama, attn, cfg, init_state, batch, dev,
               profile=False):
    """(f1): `REMAT_STEPS` single-device steps under each policy from the
    same weights and batch. Returns {policy: record}."""
    from ray_tpu_torch.train import default_optimizer, make_train_step

    runs = {}
    for policy in REMAT_POLICIES:
        c = dataclasses.replace(cfg, remat_policy=policy)
        model = llama.Llama(c, device=dev)
        model.load_state_dict(init_state)
        init_fn, step_fn = make_train_step(
            llama.loss_fn,
            default_optimizer(learning_rate=3e-4, total_steps=20), device=dev)
        state = init_fn(model)
        runs[policy] = train_steps(torch, llama, attn, c, state, step_fn,
                                   batch[:, :-1], batch[:, 1:], profile)
        del model, state, step_fn, init_fn
        torch.cuda.empty_cache()
    return runs


def train_steps(torch, llama, attn, cfg, state, step_fn, tokens, targets,
                profile=False, steps=REMAT_STEPS):
    """`steps` steps, timed by the host clock around a synchronise, with
    the launch counters zeroed just before them and read just after,
    and the peak memory of the steps; with `profile`, the allocations
    alive at the steps' peak (from the allocator's history, recorded
    beside the timed steps) and one more step traced by
    `profile_step`. The run's step program (`train.step` or
    `train.pp_step`) must record its one signature once."""
    from ray_tpu_torch._private import compile_watch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    compile_watch.reset()
    if profile:
        torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                                 stacks="python")
    attn.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens, targets)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    launches = dict(attn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    compiles = watch_counts(["train.step", "train.pp_step"])
    assert list(compiles.values()) == [[1, 1]], compiles
    steady = statistics.median(step_s[1:])
    n_tokens = tokens.shape[0] * tokens.shape[1]
    tokens_per_s = n_tokens / steady
    traced = {}
    if profile:
        trace = torch.cuda.memory._snapshot()["device_traces"][
            torch.cuda.current_device()]
        torch.cuda.memory._record_memory_history(enabled=None)
        traced["alive_at_peak"] = peak_allocations(trace)[1]
        del trace
        traced["profile"] = profile_step(
            torch, lambda: step_fn(state, tokens, targets))
    return {**traced,
        "losses": losses, "grad_norms": norms,
        "step_ms": [x * 1e3 for x in step_s], "steady_step_ms": steady * 1e3,
        "tokens_per_s": tokens_per_s,
        "mfu": train_flops_per_token(cfg, tokens.shape[1]) * tokens_per_s
        / PEAK_BF16_FLOPS,
        "max_memory_allocated": peak,
        "launches": launches,
        "compiles": compiles,
    }


def rel(a, b):
    return abs(a - b) / abs(b)


def mesh_run(torch, llama, attn, cfg, init_state, batch, dev, profile=False):
    """(f2): the flagship's mesh path, `bench.py`'s `make_train_step(loss,
    optimizer, mesh, param_annotations(cfg))` over `MeshSpec(fsdp=1)`, on
    a NCCL world of one rank made by the port's backend."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import (
        default_optimizer,
        init_torch_distributed,
        make_train_step,
        prefetch_to_device,
        shard_batch,
    )
    from ray_tpu_torch.train.backend import free_port

    init_torch_distributed(0, 1, f"localhost:{free_port()}", device=dev)
    try:
        backend = dist.get_backend()
        mesh = MeshSpec(fsdp=1).build(dev)
        model = llama.Llama(cfg, device=dev)
        model.load_state_dict(init_state)
        init_fn, step_fn = make_train_step(
            llama.loss_fn, default_optimizer(learning_rate=3e-4,
                                             total_steps=20),
            mesh, llama.param_annotations(cfg))
        state = init_fn(model)
        params = list(model.parameters())
        # Every weight a DTensor on the CUDA mesh; the norms, which the
        # rules replicate, whole on the card.
        on_mesh = all(
            (isinstance(p, DTensor) and p.device_mesh.device_type == "cuda"
             and p.to_local().is_cuda) if not name.endswith("norm")
            else (not isinstance(p, DTensor) and p.is_cuda)
            for name, p in model.named_parameters())
        record = train_steps(torch, llama, attn, cfg, state, step_fn,
                             shard_batch(batch[:, :-1], mesh),
                             shard_batch(batch[:, 1:], mesh), profile)
        # The prefetcher's pinned side-stream copies onto the same mesh.
        host = [batch.cpu() + i for i in range(3)]
        fetched = list(prefetch_to_device(iter(host), mesh,
                                          logical_axes=("batch", None)))
        prefetched = all(isinstance(b, DTensor) and torch.equal(
            b.to_local().cpu(), h) for b, h in zip(fetched, host))
        record.update({"backend": backend, "params_laid_out": on_mesh,
                       "prefetch_equal": prefetched and len(fetched) == 3,
                       "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))})
        del model, state, step_fn, init_fn, params
        # FSDP2 ties its module into reference cycles. The port collects
        # where it lays out the next FSDP2 model (`shard_module`), but
        # phase (g) lays out none, so free this one here (it lived into
        # phase (g) before).
        gc.collect()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return record


def trainer_run(torch, llama, dev):
    """(f3): a `TorchTrainer` fit at phase (c)'s small width that saves
    an async checkpoint every 2 of 6 steps through a `CheckpointManager`
    keeping 2; then the newest is restored into a fresh state."""
    import shutil

    from ray_tpu_torch._private import step_telemetry
    from ray_tpu_torch.train import (
        CheckpointManager,
        RunConfig,
        ScalingConfig,
        TorchTrainer,
        default_optimizer,
        make_train_step,
        pending_checkpoints,
        report,
        restore_checkpoint,
        save_checkpoint,
        wait_for_checkpoints,
    )

    small = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                              n_heads=4, n_kv_heads=2, intermediate=512,
                              max_seq_len=256, dtype=torch.bfloat16)
    storage = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_trainer")
    shutil.rmtree(storage, ignore_errors=True)
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, small.vocab_size, (4, 129), generator=g,
                         device=dev)
    init = {k: v.clone() for k, v in
            llama.init_params(small, g, device=dev).state_dict().items()}
    saved, block_ms, save_ms, in_flight = {}, [], [], []

    def make_state():
        model = llama.Llama(small, device=dev)
        model.load_state_dict(init)
        init_fn, step_fn = make_train_step(
            llama.loss_fn, default_optimizer(learning_rate=1e-3,
                                             total_steps=20), device=dev)
        return init_fn(model), step_fn

    def loop():
        state, step_fn = make_state()
        mgr = CheckpointManager(os.path.join(storage, "checkpoints"),
                                num_to_keep=2)
        for step in range(1, 7):
            state, metrics = step_fn(state, toks[:, :-1], toks[:, 1:])
            loss = metrics["loss"].item()
            path = None
            if step % 2 == 0:
                step_telemetry.take_phases()
                in_flight.append(len(pending_checkpoints()))
                t0 = time.perf_counter()
                path = mgr.save(step, state.state_dict(), {"loss": loss},
                                async_save=True)
                # The snapshot, as save_checkpoint bills it; the call's
                # wall also waits for the write it retires (keep 2).
                save_ms.append((time.perf_counter() - t0) * 1e3)
                block_ms.append(step_telemetry.take_phases()["ckpt_block_ms"])
                saved[path] = {k: v.detach().clone() if torch.is_tensor(v)
                               else v for k, v in flat(state.state_dict())}
            report({"step": step, "loss": loss}, checkpoint=path)

    try:
        result = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1),
                              run_config=RunConfig(storage_path=storage)).fit()
        assert result.error is None, result.error
        root = os.path.join(storage, "checkpoints")
        kept = sorted(os.listdir(root))
        durable = all(os.path.exists(os.path.join(root, d, "metadata.json"))
                      for d in kept)
        fresh, _ = make_state()
        restored = restore_checkpoint(result.checkpoint_path,
                                      fresh.state_dict())
        want = saved[result.checkpoint_path]
        got = dict(flat(restored))
        bitwise = set(got) == set(want) and all(
            torch.equal(got[k], want[k]) if torch.is_tensor(want[k])
            else got[k] == want[k] for k in want)
        # The same snapshot with no write running beside it: each save
        # here waits for its own write before the next.
        idle_ms = []
        for i in range(3):
            step_telemetry.take_phases()
            save_checkpoint(os.path.join(storage, f"idle_{i}"),
                            fresh.state_dict(), async_save=True)
            idle_ms.append(step_telemetry.take_phases()["ckpt_block_ms"])
            wait_for_checkpoints()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    record = {
        "config": "vocab 512, dim 256, 2 layers, 4 heads / 2 KV, bf16",
        "steps": len(result.metrics_history), "kept": kept,
        "metadata_in_every_kept": durable,
        "checkpoint_path": os.path.basename(result.checkpoint_path),
        "restored_bitwise": bitwise, "tensors": len(want),
        "ckpt_block_ms": block_ms, "manager_save_ms": save_ms,
        "writes_in_flight_at_save": in_flight,
        "ckpt_block_ms_writer_idle": idle_ms,
    }
    print(f"(f3) trainer: {record['steps']} steps, kept {kept}, metadata "
          f"in every kept: {durable}, restored bit for bit: {bitwise}, "
          f"ckpt_block_ms {[round(x, 2) for x in block_ms]} (writes in "
          f"flight {in_flight}), manager.save wall "
          f"{[round(x, 2) for x in save_ms]} ms; with the writer idle "
          f"{[round(x, 2) for x in idle_ms]} ms")
    assert kept == ["checkpoint_00000004", "checkpoint_00000006"], kept
    assert durable and bitwise, record
    return record


def flat(tree, prefix=""):
    """(dotted key, leaf) pairs of nested dicts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def flagship_inputs(torch, llama, cfg, dev):
    """The weights (a state dict) and batch [BATCH, SEQ + 1] of phases
    (f) and (g1), from one seed."""
    g = torch.Generator(device=dev).manual_seed(2)
    init_state = {k: v.clone() for k, v in
                  llama.init_params(cfg, g, device=dev).state_dict().items()}
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=g,
                          device=dev)
    torch.cuda.empty_cache()
    return init_state, batch


def train_sharded_phase(torch, llama, attn, card, n_layers, dev,
                        profile=False):
    """Phase (f), after (c) has freed its memory (see the module's doc).
    Returns the `{"train_sharded": ...}` record."""
    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
    init_state, batch = flagship_inputs(torch, llama, cfg, dev)
    runs = remat_runs(torch, llama, attn, cfg, init_state, batch, dev,
                      profile)
    full = runs["full"]
    for policy, r in runs.items():
        r["loss_rel_to_full"] = [rel(a, b) for a, b in
                                 zip(r["losses"], full["losses"])]
        r["grad_norm_rel_to_full"] = rel(r["grad_norms"][0],
                                         full["grad_norms"][0])
        print(f"(f1) remat {policy}: losses {[round(x, 5) for x in r['losses']]}"
              f" (relative to full: "
              f"{[f'{d:.2e}' for d in r['loss_rel_to_full']]}; step-1 grad "
              f"norm {r['grad_norm_rel_to_full']:.2e})"
              f", grad norms {[round(x, 5) for x in r['grad_norms']]}, step "
              f"{r['steady_step_ms']:.2f} ms, {r['tokens_per_s']:.0f} tokens/s"
              f", MFU {r['mfu']:.4f}, peak {r['max_memory_allocated']} B, "
              f"launches {r['launches']}")
        if "profile" in r:
            prof = r["profile"]
            print(f"(f1) remat {policy}, traced step: device busy "
                  f"{prof['device_busy_ms']:.2f} ms of {prof['wall_ms']:.2f}, "
                  f"by group {prof['groups_ms']}")
    for policy, r in runs.items():
        assert all(math.isfinite(x) for x in r["losses"] + r["grad_norms"])
        assert r["losses"][-1] < r["losses"][0], (policy, r["losses"])
        assert rel(r["losses"][0], full["losses"][0]) <= REMAT_LOSS_REL, policy
        assert rel(r["grad_norms"][0], full["grad_norms"][0]) <= \
            REMAT_GNORM_REL, policy
        assert all(d <= MESH_LOSS_REL for d in r["loss_rel_to_full"]), (
            policy, r["loss_rel_to_full"])
        fwd_per_layer = 1 if policy == "dots_flash" else 2
        assert r["launches"]["flash_fwd"] == \
            REMAT_STEPS * n_layers * fwd_per_layer, (policy, r["launches"])
        for name in BWD_LAUNCHES:
            assert r["launches"][name] == REMAT_STEPS * n_layers, (
                policy, r["launches"])

    mesh = mesh_run(torch, llama, attn,
                    dataclasses.replace(cfg, remat_policy="dots_flash"),
                    init_state, batch, dev, profile)
    ref = runs["dots_flash"]
    diffs = [rel(a, b) for a, b in zip(mesh["losses"], ref["losses"])]
    print(f"(f2) MeshSpec(fsdp=1) on {mesh['backend']}: losses "
          f"{[round(x, 5) for x in mesh['losses']]} (relative to (f1) "
          f"dots_flash: {[f'{d:.2e}' for d in diffs]}), step "
          f"{mesh['steady_step_ms']:.2f} ms against {ref['steady_step_ms']:.2f}"
          f" ms, weights DTensors and norms whole on CUDA: "
          f"{mesh['params_laid_out']}, "
          f"prefetched batches equal: {mesh['prefetch_equal']}, "
          f"launches {mesh['launches']}")
    assert mesh["backend"] == "nccl" and mesh["params_laid_out"], mesh
    assert mesh["prefetch_equal"], mesh
    assert all(d <= MESH_LOSS_REL for d in diffs), diffs
    assert mesh["launches"]["flash_fwd"] == REMAT_STEPS * n_layers, mesh
    del init_state, batch
    torch.cuda.empty_cache()

    trainer = trainer_run(torch, llama, dev)
    return {
        "card": card,
        "config": f"llama2_7b width, {n_layers} layers, bf16, flash",
        "batch": BATCH, "seq": SEQ, "steps": REMAT_STEPS,
        "bars": {"remat_loss_rel": REMAT_LOSS_REL,
                 "remat_grad_norm_rel": REMAT_GNORM_REL,
                 "mesh_loss_rel": MESH_LOSS_REL},
        "f1": {"policies": runs,
               "launches": {p: r["launches"] for p, r in runs.items()}},
        "f2": {**mesh, "loss_rel_to_f1": diffs,
               "f1_dots_flash_step_ms": ref["steady_step_ms"]},
        "f3": trainer,
    }


def pp_run(torch, llama, attn, cfg, owned, mesh, batch, steps, profile):
    """`make_pp_train_step` on `mesh` from the weights of the model in
    `owned` (a list of one, emptied here: the whole model is freed once
    the stage holds its copy), `steps` steps on one batch."""
    from ray_tpu_torch.train import default_optimizer, make_pp_train_step

    init_fn, step_fn = make_pp_train_step(
        cfg, mesh, default_optimizer(learning_rate=3e-4, total_steps=20),
        num_microbatches=PP_MICROBATCHES)
    state = init_fn(owned.pop())
    torch.cuda.empty_cache()
    record = train_steps(torch, llama, attn, cfg, state, step_fn,
                         batch[:, :-1], batch[:, 1:], profile, steps)
    del state, step_fn, init_fn
    torch.cuda.empty_cache()
    return record


def moe_check(torch, llama, group, dev):
    """(g3): `moe_ffn_ep` over an ep group of one against `moe_ffn_dense`
    at the MoE model's width, with a capacity at which nothing drops."""
    from ray_tpu_torch.ops.moe import init_moe_params, moe_ffn_dense, moe_ffn_ep

    g = torch.Generator(device=dev).manual_seed(5)
    width = llama.LlamaConfig.llama2_7b()
    cfg_dim, ff = width.dim, width.intermediate
    params = init_moe_params(PP_MOE_EXPERTS, cfg_dim, ff, g,
                             dtype=torch.bfloat16, device=dev)
    x = torch.randn(MOE_TOKENS, cfg_dim, generator=g, device=dev).to(
        torch.bfloat16)
    capacity_factor = PP_MOE_EXPERTS / PP_MOE_TOP_K
    with torch.no_grad():
        out_ep, aux_ep = moe_ffn_ep(params, x, group, k=PP_MOE_TOP_K,
                                    capacity_factor=capacity_factor)
        out_dense, aux_dense = moe_ffn_dense(params, x, k=PP_MOE_TOP_K)
        ep_ms = cuda_ms(torch, lambda: moe_ffn_ep(
            params, x, group, k=PP_MOE_TOP_K,
            capacity_factor=capacity_factor), 3)
        dense_ms = cuda_ms(torch, lambda: moe_ffn_dense(
            params, x, k=PP_MOE_TOP_K), 3)
    print(f"(g3) moe_ffn_ep (ep group of one, capacity factor "
          f"{capacity_factor}) against moe_ffn_dense, {MOE_TOKENS} tokens x "
          f"{cfg_dim}, {PP_MOE_EXPERTS} experts of {cfg_dim} x {ff}, top-"
          f"{PP_MOE_TOP_K}, bf16:")
    ok, err = held("out", out_ep, out_dense)
    aux_err = abs(aux_ep.item() - aux_dense.item())
    print(f"  aux {aux_ep.item():.6f} against {aux_dense.item():.6f} (bar "
          f"{AUX_TOL}); moe_ffn_ep {ep_ms:.2f} ms, moe_ffn_dense "
          f"{dense_ms:.2f} ms")
    assert ok and aux_err <= AUX_TOL, (err, aux_err)
    del params, x, out_ep, out_dense
    torch.cuda.empty_cache()
    return {"tokens": MOE_TOKENS, "dim": cfg_dim, "ffn": ff,
            "experts": PP_MOE_EXPERTS, "top_k": PP_MOE_TOP_K,
            "capacity_factor": capacity_factor, "out_max_abs_err": err,
            "aux_ep": aux_ep.item(), "aux_dense": aux_dense.item(),
            "moe_ffn_ep_ms": ep_ms, "moe_ffn_dense_ms": dense_ms}


def pp_phase(torch, llama, attn, card, n_layers, dev, f1_full_loss,
             profile=False, f1_full_peak=None):
    """Phase (g), after (f) has freed its memory (see the module's doc).
    Returns the `{"train_pp": ...}` record."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import pipeline_mesh
    from ray_tpu_torch.train import init_torch_distributed
    from ray_tpu_torch.train.backend import free_port

    init_torch_distributed(0, 1, f"localhost:{free_port()}", device=dev)
    try:
        backend = dist.get_backend()
        mesh = pipeline_mesh(1, 1, 1, dev)
        # (g1) the flagship's width and depth, (f1)'s weights and batch.
        cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
        init_state, batch = flagship_inputs(torch, llama, cfg, dev)
        model = llama.Llama(cfg, device=dev)
        model.load_state_dict(init_state)
        del init_state
        owned = [model]
        del model
        g1 = pp_run(torch, llama, attn, cfg, owned, mesh, batch, REMAT_STEPS,
                    profile)
        g1["loss_rel_to_f1_full"] = rel(g1["losses"][0], f1_full_loss)
        per_step = {n: c / REMAT_STEPS for n, c in g1["launches"].items()}
        print(f"(g1) make_pp_train_step, (pp, sp, ep) = (1, 1, 1) on "
              f"{backend}, {PP_MICROBATCHES} microbatches: losses "
              f"{[round(x, 5) for x in g1['losses']]} (step 1 relative to "
              f"(f1) full: {g1['loss_rel_to_f1_full']:.2e}), grad norms "
              f"{[round(x, 5) for x in g1['grad_norms']]}, step "
              f"{g1['steady_step_ms']:.2f} ms, {g1['tokens_per_s']:.0f} "
              f"tokens/s, MFU {g1['mfu']:.4f}, peak "
              f"{g1['max_memory_allocated']} B, launches per step {per_step}")
        if profile:
            prof = g1["profile"]
            print(f"(g1) traced step: device busy {prof['device_busy_ms']:.2f}"
                  f" ms of {prof['wall_ms']:.2f}, by group {prof['groups_ms']}")
            print(f"(g1) alive at the peak, by site: {g1['alive_at_peak']}")
            print(f"(f1) full, alive at the peak, by site: {f1_full_peak}")
        losses = g1["losses"]
        assert backend == "nccl", backend
        assert all(math.isfinite(x) for x in losses + g1["grad_norms"])
        assert losses[-1] < losses[0], losses
        assert g1["loss_rel_to_f1_full"] <= MESH_LOSS_REL, g1
        # Full remat: each layer's forward runs once, and again in the
        # backward's recompute, for each microbatch.
        fwd = REMAT_STEPS * n_layers * 2 * PP_MICROBATCHES
        assert g1["launches"]["flash_fwd"] == fwd, g1["launches"]
        for name in BWD_LAUNCHES:
            assert g1["launches"][name] == fwd // 2, g1["launches"]

        # (g2) MoE at the same width: every token through all experts.
        moe_cfg = llama.LlamaConfig.llama2_7b(
            n_layers=PP_MOE_LAYERS, moe_experts=PP_MOE_EXPERTS,
            moe_top_k=PP_MOE_TOP_K, max_seq_len=SEQ)
        owned = [llama.init_params(
            moe_cfg, torch.Generator(device=dev).manual_seed(4), device=dev)]
        g2 = pp_run(torch, llama, attn, moe_cfg, owned, mesh, batch,
                    PP_MOE_STEPS, profile)
        del batch
        g2["params"] = moe_cfg.num_params()
        print(f"(g2) make_pp_train_step, MoE {PP_MOE_EXPERTS} experts top-"
              f"{PP_MOE_TOP_K}, {PP_MOE_LAYERS} layers ({g2['params']} "
              f"parameters): losses {[round(x, 5) for x in g2['losses']]}, "
              f"grad norms {[round(x, 5) for x in g2['grad_norms']]}, step "
              f"{g2['steady_step_ms']:.2f} ms, {g2['tokens_per_s']:.0f} "
              f"tokens/s, MFU {g2['mfu']:.4f} (active experts only: every "
              f"token runs all {PP_MOE_EXPERTS}, so it reads low by design), "
              f"peak {g2['max_memory_allocated']} B, launches "
              f"{g2['launches']}")
        assert all(math.isfinite(x) for x in g2["losses"] + g2["grad_norms"])
        assert g2["losses"][-1] < g2["losses"][0], g2["losses"]
        fwd = PP_MOE_STEPS * PP_MOE_LAYERS * 2 * PP_MICROBATCHES
        assert g2["launches"]["flash_fwd"] == fwd, g2["launches"]

        g3 = moe_check(torch, llama, mesh.get_group("ep"), dev)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {
        "card": card, "backend": backend, "mesh": {"pp": 1, "sp": 1, "ep": 1},
        "microbatches": PP_MICROBATCHES, "batch": BATCH, "seq": SEQ,
        "g1": {"config": f"llama2_7b width, {n_layers} layers, bf16, flash, "
                         "remat full", "steps": REMAT_STEPS, **g1,
               "launches_per_step": {n: c / REMAT_STEPS
                                     for n, c in g1["launches"].items()}},
        "g2": {"config": f"llama2_7b width, {PP_MOE_LAYERS} layers, MoE "
                         f"{PP_MOE_EXPERTS} experts top-{PP_MOE_TOP_K}, bf16,"
                         " flash, remat full", "steps": PP_MOE_STEPS, **g2,
               "mfu_counts": "active experts only (train_flops_per_token)",
               "launches_per_step": {n: c / PP_MOE_STEPS
                                     for n, c in g2["launches"].items()}},
        "g3": g3,
    }


def mpmd_expected_launches(cfg, pipe, steps):
    """The flash launches each stage of `pipe` must count in `steps`
    steps. Per microbatch a layer of a chunk other than the last runs
    its forward in the F op and again in the B op's recompute; the last
    chunk's F op runs nothing. Inside the B op `cfg.remat` applies per
    layer as in the plain step: "full" and "dots" rerun each layer's
    forward in the backward, "dots_flash" keeps the flash outputs. Each
    layer runs one backward op (3 launches) per microbatch."""
    in_b = 2 if cfg.remat and cfg.remat_policy != "dots_flash" else 1
    out = []
    for s in range(pipe.n):
        fwd = bwd = 0
        for c in range(s, pipe.V, pipe.n):
            lo, hi = pipe.bounds[c]
            fwd += (hi - lo) * (in_b + (c != pipe.V - 1))
            bwd += hi - lo
        runs = steps * pipe.m
        out.append({"flash_fwd": runs * fwd,
                    **{name: runs * bwd for name in BWD_LAUNCHES}})
    return out


def mpmd_steps(torch, rt, pipe, tokens, targets, steps):
    """`steps` steps of `pipe`, timed by the host clock, with every
    stage's flash launch counts and peak memory zeroed just before them
    and read just after. Returns the record of the run."""
    rt.get([a.take_launch_counts.remote() for a in pipe.stages], timeout=60)
    rt.get([a.peak_memory.remote() for a in pipe.stages], timeout=60)
    losses, step_s, outs = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = pipe.step(tokens, targets)
        step_s.append(time.perf_counter() - t0)
        losses.append(out["loss"])
        outs.append(out["stages"])
    launches = rt.get([a.take_launch_counts.remote() for a in pipe.stages],
                      timeout=60)
    memory = rt.get([a.peak_memory.remote() for a in pipe.stages],
                    timeout=60)
    # (j2): each stage program's compile-watch counts in its process.
    compiles = rt.get([a.compile_counts.remote() for a in pipe.stages],
                      timeout=60)
    steady = statistics.median(step_s[1:]) if steps > 1 else step_s[0]
    last = outs[-1]
    # Step 1 pays each stage process's first launches: kept apart.
    first = [{k: st[k] for k in ("busy_ms", "wall_ms", "opt_ms", "op_ms")}
             for st in outs[0]]
    return {
        "first_step_stages": first,
        "losses": losses, "step_ms": [x * 1e3 for x in step_s],
        "steady_step_ms": steady * 1e3,
        "tokens_per_s": tokens.shape[0] * tokens.shape[1] / steady,
        "bounds": pipe.bounds, "stash_bound": pipe.stash_bound,
        "stash_peaks": [[st["stash_peak"] for st in o] for o in outs],
        "theoretical_efficiency": pipe.theoretical_efficiency(),
        "build_ms": pipe.build_ms,
        "launches": launches,
        "expected_launches": mpmd_expected_launches(pipe.cfg, pipe, steps),
        "compiles": compiles,
        "stages": [{
            "device": mem["device"],
            "max_memory_allocated": mem["max_memory_allocated"],
            "busy_ms": st["busy_ms"], "wall_ms": st["wall_ms"],
            "opt_ms": st["opt_ms"], "op_ms": st["op_ms"],
            "send_wait_ms": sum(e["send_wait_ms"] for e in st["edges"]),
            "recv_wait_ms": sum(e["recv_wait_ms"] for e in st["edges"]),
            "bytes_out": sum(e["bytes_out"] for e in st["edges"]),
            "bytes_in": sum(e["bytes_in"] for e in st["edges"]),
        } for st, mem in zip(last, memory)],
    }


def mpmd_print(label, r, ref_loss):
    print(f"{label}: losses {[round(x, 5) for x in r['losses']]} (step 1 "
          f"relative to one card's {ref_loss:.5f}: "
          f"{rel(r['losses'][0], ref_loss):.2e}), step "
          f"{r['steady_step_ms']:.2f} ms, {r['tokens_per_s']:.0f} tokens/s, "
          f"bubble bound {r['theoretical_efficiency']:.3f}, bounds "
          f"{r['bounds']}, stash peaks {r['stash_peaks']} (bound "
          f"{r['stash_bound']}), build ms "
          f"{ {k: round(v, 1) for k, v in r['build_ms'].items()} }")
    print(f"  step 1 ({r['step_ms'][0]:.1f} ms), busy / wall ms by stage: "
          f"{[(st['busy_ms'], st['wall_ms']) for st in r['first_step_stages']]}"
          f", ops {[st['op_ms'] for st in r['first_step_stages']]}")
    for s, st in enumerate(r["stages"]):
        print(f"  stage {s} on {st['device']}: busy {st['busy_ms']} ms, "
              f"wall {st['wall_ms']} ms, opt {st['opt_ms']} ms, "
              f"send wait {st['send_wait_ms']:.3f} ms, recv wait "
              f"{st['recv_wait_ms']:.3f} ms, ops {st['op_ms']}, bytes out "
              f"{st['bytes_out']} in "
              f"{st['bytes_in']}, peak {st['max_memory_allocated']} B, "
              f"launches {r['launches'][s]}, compiles "
              f"{ {k: v['compiles'] for k, v in r['compiles'][s].items()} }")


def mpmd_held(r, ref_loss):
    """(g4b)'s and `--cards 4`'s bars on one run's record."""
    losses = r["losses"]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    assert max(max(p) for p in r["stash_peaks"]) <= r["stash_bound"], r
    # The other pairs' counters must read 0.
    expected = [{**dict.fromkeys(got, 0), **want} for got, want in
                zip(r["launches"], r["expected_launches"])]
    assert r["launches"] == expected, (r["launches"], expected)
    # (j2): every stage program recorded each signature once, and kept
    # its first step's: one, or one per chunk for `acc`.
    for stage in r["compiles"]:
        for key, row in stage.items():
            assert row["compiles"] == row["distinct_shapes"] == \
                row["signatures"] >= 1, (key, row)


def flagship_weights(torch, llama, cfg, rows, dev):
    """Weights (a state dict on the CPU) and a batch [rows, SEQ + 1] on
    `dev` drawn from MPMD_SEED (phase (c)'s), and one card's loss on
    them under `torch.no_grad()`; the model is freed."""
    g = torch.Generator(device=dev).manual_seed(MPMD_SEED)
    model = llama.init_params(cfg, g, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (rows, SEQ + 1), generator=g,
                          device=dev)
    with torch.no_grad():
        ref_loss = llama.loss_fn(model, batch[:, :-1], batch[:, 1:]).item()
    state = {k: v.detach().to("cpu", copy=True)
             for k, v in model.state_dict().items()}
    return model, state, batch, ref_loss


def mpmd_exactness(torch, llama, dev):
    """(g4a): one SGD step of the MPMD pipeline at the small width in f32
    against one card's autograd on the same weights and batch, and the
    control: the same results against targets shifted by one position
    must fail the bars."""
    import functools

    from ray_tpu_torch.train import SGD, MPMDPipeline

    cfg = llama.LlamaConfig(**MPMD_SMALL, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(MPMD_SEED)
    state = {k: v.detach().to("cpu", copy=True) for k, v in
             llama.init_params(cfg, g, device=dev).state_dict().items()}
    batch = torch.randint(0, cfg.vocab_size,
                          (MPMD_SMALL_BATCH, MPMD_SMALL_SEQ + 1), generator=g,
                          device=dev)
    tokens, targets = batch[:, :-1], batch[:, 1:]

    def one_card(tgt):
        model = llama.Llama(cfg, device=dev)
        model.load_state_dict(state)
        loss = llama.loss_fn(model, tokens, tgt)
        loss.backward()
        return loss.item(), {
            n: (p.detach() - MPMD_SMALL_LR * p.grad).cpu()
            for n, p in model.named_parameters()}

    want = one_card(targets)
    control = one_card(targets.roll(1, dims=1))
    pipe = MPMDPipeline(
        cfg, 2, num_microbatches=2,
        microbatch_size=MPMD_SMALL_BATCH // 2, seq_len=MPMD_SMALL_SEQ,
        optimizer_factory=functools.partial(SGD, MPMD_SMALL_LR),
        params=state, device="cuda")
    try:
        loss = pipe.step(tokens.cpu(), targets.cpu())["loss"]
        got = pipe.collect_params()
    finally:
        pipe.shutdown()

    def errors(ref):
        ref_loss, ref_params = ref
        excess = max(((got[n] - w).abs() - MPMD_PARAM_ATOL
                      - MPMD_PARAM_RTOL * w.abs()).max().item()
                     for n, w in ref_params.items())
        worst = max((got[n] - w).abs().max().item()
                    for n, w in ref_params.items())
        return {"loss_err": abs(loss - ref_loss), "param_max_abs_err": worst,
                "param_excess": excess,
                "held": abs(loss - ref_loss) <= MPMD_LOSS_ABS
                and excess <= 0.0}

    rec = {"config": {**MPMD_SMALL, "dtype": "float32"},
           "batch": MPMD_SMALL_BATCH, "seq": MPMD_SMALL_SEQ,
           "microbatches": 2, "lr": MPMD_SMALL_LR, "loss": loss,
           "one_card_loss": want[0], **errors(want),
           "control": errors(control),
           "bars": {"loss_abs": MPMD_LOSS_ABS, "param_rtol": MPMD_PARAM_RTOL,
                    "param_atol": MPMD_PARAM_ATOL}}
    print(f"(g4a) MPMD 2 stages x 2 microbatches, f32 small width, one SGD "
          f"step: loss {loss:.7f} against one card's {want[0]:.7f} (err "
          f"{rec['loss_err']:.2e}, bar {MPMD_LOSS_ABS}), parameters max abs "
          f"err {rec['param_max_abs_err']:.2e} (excess over rtol "
          f"{MPMD_PARAM_RTOL} / atol {MPMD_PARAM_ATOL}: "
          f"{rec['param_excess']:.2e}); control, targets shifted one "
          f"position (must fail): {rec['control']}")
    assert rec["held"], rec
    assert not rec["control"]["held"], rec["control"]
    return rec


def mpmd_phase(torch, llama, attn, card, dev):
    """Phase (g4), after (g3) has freed its memory: the MPMD pipeline's
    stage actors on the card ((g4a), then (g4b) under each of
    MPMD_SCHEDULES, with (c)'s single-card step at the same batch beside
    them). Returns the `{"train_mpmd": ...}` record."""
    import functools

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (
        MPMDPipeline,
        default_optimizer,
        make_train_step,
    )

    rt.init(num_cpus=4, num_gpus=1)
    try:
        g4a = mpmd_exactness(torch, llama, dev)
        cfg = llama.LlamaConfig.llama2_7b(n_layers=MPMD_LAYERS,
                                          max_seq_len=SEQ)
        model, state, batch, ref_loss = flagship_weights(
            torch, llama, cfg, MPMD_MICROBATCHES, dev)
        # (c)'s single-card step at the same batch, weights and
        # optimizer: the yardstick the stages are read beside.
        init_fn, step_fn = make_train_step(
            llama.loss_fn,
            default_optimizer(learning_rate=3e-4, total_steps=20),
            device=dev)
        single = train_steps(torch, llama, attn, cfg, init_fn(model),
                             step_fn, batch[:, :-1], batch[:, 1:],
                             steps=MPMD_STEPS)
        del model, init_fn, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        tokens, targets = batch[:, :-1].cpu(), batch[:, 1:].cpu()
        del batch
        print(f"(g4b) one card, make_train_step at {MPMD_MICROBATCHES} x "
              f"{SEQ}: losses {[round(x, 5) for x in single['losses']]} "
              f"(no_grad loss {ref_loss:.5f}), step "
              f"{single['steady_step_ms']:.2f} ms, "
              f"{single['tokens_per_s']:.0f} tokens/s, peak "
              f"{single['max_memory_allocated']} B")
        runs = {}
        for label, v in MPMD_SCHEDULES:
            pipe = MPMDPipeline(
                cfg, 2, num_microbatches=MPMD_MICROBATCHES,
                microbatch_size=1, seq_len=SEQ, chunks_per_stage=v,
                optimizer_factory=functools.partial(
                    default_optimizer, learning_rate=3e-4, total_steps=20),
                params=state, device="cuda")
            try:
                r = mpmd_steps(torch, rt, pipe, tokens, targets, MPMD_STEPS)
            finally:
                pipe.shutdown()
            r["loss_rel_to_one_card"] = rel(r["losses"][0], ref_loss)
            runs[label] = r
            mpmd_print(f"(g4b) MPMD {label}, 2 stages x {v} chunks on one "
                       "card", r, ref_loss)
            mpmd_held(r, ref_loss)
            assert r["loss_rel_to_one_card"] <= MESH_LOSS_REL, r
    finally:
        rt.shutdown()
    return {"card": card,
            "config": f"llama2_7b width, {MPMD_LAYERS} layers, bf16, flash, "
                      "remat full",
            "batch": MPMD_MICROBATCHES, "seq": SEQ,
            "microbatches": MPMD_MICROBATCHES, "steps": MPMD_STEPS,
            "one_card_no_grad_loss": ref_loss, "one_card_step": single,
            "bars": {"loss_rel_to_one_card": MESH_LOSS_REL},
            "g4a": g4a, "g4b": runs}


def cards4_mpmd_run(torch, card):
    """`--cards 4`: the MPMD pipeline in 4 stages, one per card, at the
    7B width on CARDS4_MPMD_LAYERS layers, against one card's loss on
    the same weights and batch. Returns its record."""
    import functools

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import MPMDPipeline, default_optimizer

    if torch.cuda.device_count() < 4:
        raise RuntimeError(f"--cards 4 needs 4 cards, this machine has "
                           f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    cfg = llama.LlamaConfig.llama2_7b(n_layers=CARDS4_MPMD_LAYERS,
                                      max_seq_len=SEQ)
    model, state, batch, ref_loss = flagship_weights(
        torch, llama, cfg, CARDS4_MPMD_MICROBATCHES, dev)
    del model
    tokens, targets = batch[:, :-1].cpu(), batch[:, 1:].cpu()
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    rt.init(num_cpus=8, num_gpus=4)
    try:
        pipe = MPMDPipeline(
            cfg, 4, num_microbatches=CARDS4_MPMD_MICROBATCHES,
            microbatch_size=1, seq_len=SEQ,
            optimizer_factory=functools.partial(
                default_optimizer, learning_rate=3e-4, total_steps=20),
            params=state, device="cuda")
        try:
            r = mpmd_steps(torch, rt, pipe, tokens, targets, MPMD_STEPS)
        finally:
            pipe.shutdown()
    finally:
        rt.shutdown()
    r["loss_rel_to_one_card"] = rel(r["losses"][0], ref_loss)
    mpmd_print(f"--cards 4, MPMD 4 stages x 1 chunk, {CARDS4_MPMD_LAYERS} "
               f"layers, {CARDS4_MPMD_MICROBATCHES} x {SEQ}", r, ref_loss)
    mpmd_held(r, ref_loss)
    assert sorted(st["device"] for st in r["stages"]) == [
        f"cuda:{i}" for i in range(4)], r["stages"]
    assert r["loss_rel_to_one_card"] <= CARDS4_LOSS_REL, r
    return {"card": card, "layers": CARDS4_MPMD_LAYERS,
            "batch": CARDS4_MPMD_MICROBATCHES, "seq": SEQ,
            "one_card_no_grad_loss": ref_loss, **r}


def cards_rank(rank, n_layers, world, profile=False):
    """One rank of `--cards 4`'s gangs (NCCL, one card a rank): with
    world 1 the references on one card, with world 4 the four-card runs,
    on the Llama-2-7B width at `n_layers`, from the same weights and
    batch: `make_pp_train_step` dense (pp 2 x sp 2 with ring attention on
    four cards) and MoE with 8 experts at capacity factor E/k, so that
    nothing drops (pp 2 x ep 2); `make_train_step` under "dots_flash"
    (over `MeshSpec(fsdp=4)`, `(fsdp=2, tp=2)`, `(fsdp=2, sp=2)` and
    `(sp=2, tp=2)`; over `(sp=4)` at 1 x CARDS4_LONG_SEQ; the MoE over
    `(fsdp=2, tp=2)`). Every mesh spans the gang's whole world. With
    `profile`, one more step of each `make_train_step` run is traced.
    Returns {run: record}."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.parallel import MeshSpec, pipeline_mesh
    from ray_tpu_torch.train import (
        default_optimizer,
        make_train_step,
        shard_batch,
    )

    dev = torch.device("cuda")
    out = {}
    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
    init_state, _ = flagship_inputs(torch, llama, cfg, dev)
    batch = torch.randint(0, cfg.vocab_size, (CARDS4_BATCH, SEQ + 1),
                          generator=torch.Generator(device=dev).manual_seed(6),
                          device=dev)

    def whole(c, state):
        model = llama.Llama(c, device=dev)
        model.load_state_dict(state)
        return model

    def moe_model(c):
        return llama.init_params(
            c, torch.Generator(device=dev).manual_seed(4), device=dev)

    def done(name):
        print(f"--cards 4, rank {rank} of {world}: {name} "
              f"{out[name]['steady_step_ms']:.2f} ms", flush=True)

    ring = dataclasses.replace(cfg, attention="ring")
    dense, dense_cfg, mesh = (
        ("dense_one_card", cfg, pipeline_mesh(1, 1, 1, "cuda")) if world == 1
        else ("dense_pp2_sp2_ring", ring, pipeline_mesh(2, 2, 1, "cuda")))
    out[dense] = pp_run(torch, llama, attn, dense_cfg,
                        [whole(dense_cfg, init_state)], mesh, batch,
                        REMAT_STEPS, False)
    done(dense)

    moe_cfg = llama.LlamaConfig.llama2_7b(
        n_layers=n_layers, moe_experts=PP_MOE_EXPERTS, moe_top_k=PP_MOE_TOP_K,
        moe_capacity_factor=PP_MOE_EXPERTS / PP_MOE_TOP_K, max_seq_len=SEQ)
    moe, mesh = (("moe_one_card", pipeline_mesh(1, 1, 1, "cuda"))
                 if world == 1 else
                 ("moe_pp2_ep2", pipeline_mesh(2, 1, 2, "cuda")))
    out[moe] = pp_run(torch, llama, attn, moe_cfg, [moe_model(moe_cfg)],
                      mesh, batch, PP_MOE_STEPS, False)
    done(moe)

    flash = dataclasses.replace(cfg, remat_policy="dots_flash")
    long = dataclasses.replace(flash, max_seq_len=CARDS4_LONG_SEQ)
    long_batch = torch.randint(
        0, cfg.vocab_size, (1, CARDS4_LONG_SEQ + 1),
        generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    moe_flash = dataclasses.replace(moe_cfg, n_layers=PP_MOE_LAYERS,
                                    remat_policy="dots_flash")
    optimizer = default_optimizer(learning_rate=3e-4, total_steps=20)
    # name -> (mesh spec, config, the whole model, batch); None: one card.
    runs = {
        "mesh_one_card": (None, flash, lambda: whole(flash, init_state),
                          batch),
        "long_one_card": (None, long, lambda: whole(long, init_state),
                          long_batch),
        "moe_mesh_one_card": (None, moe_flash,
                              lambda: moe_model(moe_flash), batch),
    } if world == 1 else {
        "fsdp4": (MeshSpec(fsdp=4), flash, lambda: whole(flash, init_state),
                  batch),
        "fsdp2_tp2": (MeshSpec(fsdp=2, tp=2), flash,
                      lambda: whole(flash, init_state), batch),
        "fsdp2_sp2": (MeshSpec(fsdp=2, sp=2), flash,
                      lambda: whole(flash, init_state), batch),
        "sp2_tp2": (MeshSpec(sp=2, tp=2), flash,
                    lambda: whole(flash, init_state), batch),
        "sp4_long": (MeshSpec(sp=4), long, lambda: whole(long, init_state),
                     long_batch),
        "moe_fsdp2_tp2": (MeshSpec(fsdp=2, tp=2), moe_flash,
                          lambda: moe_model(moe_flash), batch),
    }
    for name, (spec, c, model, b) in runs.items():
        if spec is None:
            init_fn, step_fn = make_train_step(llama.loss_fn, optimizer,
                                               device=dev)
            tokens, targets = b[:, :-1], b[:, 1:]
        else:
            mesh = spec.build("cuda")
            init_fn, step_fn = make_train_step(
                llama.loss_fn, optimizer, mesh, llama.param_annotations(c))
            tokens = shard_batch(b[:, :-1], mesh)
            targets = shard_batch(b[:, 1:], mesh)
        state = init_fn(model())
        out[name] = train_steps(torch, llama, attn, c, state, step_fn,
                                tokens, targets, profile)
        out[name]["n_layers"] = c.n_layers
        done(name)
        del state, init_fn, step_fn, tokens, targets
        gc.collect()
        torch.cuda.empty_cache()
    return out


def four_card_phase(torch, card, n_layers, profile=False):
    """`--cards 4`: `cards_rank` in a gang of one (the references on card
    0), then in a gang of 4. Returns the `{"four_cards": ...}` record."""
    from ray_tpu_torch.train import run_local_gang

    if torch.cuda.device_count() < 4:
        raise RuntimeError(f"--cards 4 needs 4 cards, this machine has "
                           f"{torch.cuda.device_count()}")
    one = run_local_gang(cards_rank, 1, (n_layers, 1, profile),
                         device="cuda", timeout=300)[0]
    ranks = run_local_gang(cards_rank, 4, (n_layers, 4, profile),
                           device="cuda", timeout=360)
    runs = {**one, **ranks[0]}
    for ref, names in (("dense_one_card", ("dense_pp2_sp2_ring",)),
                       ("moe_one_card", ("moe_pp2_ep2",)),
                       ("mesh_one_card", ("fsdp4", "fsdp2_tp2", "fsdp2_sp2",
                                          "sp2_tp2")),
                       ("long_one_card", ("sp4_long",)),
                       ("moe_mesh_one_card", ("moe_fsdp2_tp2",))):
        base = runs[ref]
        for name in (ref, *names):
            if "profile" in runs[name]:
                prof = runs[name]["profile"]
                print(f"--cards 4, {name}, traced step on rank 0: device "
                      f"busy {prof['device_busy_ms']:.2f} ms of "
                      f"{prof['wall_ms']:.2f}, by group {prof['groups_ms']}, "
                      f"top {prof['top'][:6]}")
        for name in names:
            r = runs[name]
            r["loss_rel_to_one_card"] = [rel(a, b) for a, b in
                                         zip(r["losses"], base["losses"])]
            print(f"--cards 4, {name}: losses "
                  f"{[round(x, 5) for x in r['losses']]} (one card: "
                  f"{[round(x, 5) for x in base['losses']]}; step 1 relative "
                  f"{r['loss_rel_to_one_card'][0]:.2e}), step "
                  f"{r['steady_step_ms']:.2f} ms against "
                  f"{base['steady_step_ms']:.2f} ms on one card, "
                  f"{r['tokens_per_s']:.0f} tokens/s (one card "
                  f"{base['tokens_per_s']:.0f}), peak per card "
                  f"{[rk[name]['max_memory_allocated'] for rk in ranks]} B "
                  f"(one card {base['max_memory_allocated']} B), launches "
                  f"{r['launches']}")
            assert all(math.isfinite(x) for x in r["losses"])
            assert r["losses"][-1] < r["losses"][0], (name, r["losses"])
            assert r["loss_rel_to_one_card"][0] <= CARDS4_LOSS_REL, (name, r)
    # The flash kernels' launches on every rank: the mesh steps (under
    # sp through Ulysses) once a layer and step under "dots_flash", the
    # ring pp run none.
    for rk in [one] + ranks:
        for name, r in rk.items():
            if "n_layers" in r:
                each = REMAT_STEPS * r["n_layers"]
                want = {"flash_fwd": each, **dict.fromkeys(BWD_LAUNCHES, each)}
            elif name == "dense_pp2_sp2_ring":
                want = {"flash_fwd": 0, **dict.fromkeys(BWD_LAUNCHES, 0)}
            else:
                continue
            got = {k: r["launches"][k] for k in want}
            assert got == want, (name, got, want)
    runs["trainer_gang_fsdp4"] = trainer_gang_run(
        n_layers, runs["fsdp4"]["losses"])
    return {"card": card, "cards": 4, "batch": CARDS4_BATCH, "seq": SEQ,
            "long_seq": CARDS4_LONG_SEQ, "layers": n_layers, "runs": runs,
            "mpmd": cards4_mpmd_run(torch, card),
            "data": cards4_data_run(torch, card, n_layers),
            "peak_per_card": {name: [rk[name]["max_memory_allocated"]
                                     for rk in ranks] for name in runs
                              if all(name in rk for rk in ranks)},
            "bars": {"loss_rel_to_one_card": CARDS4_LOSS_REL}}


def scores_tf32x3_check(torch, attn):
    """(b) The f32 forward's three-term TF32 product alone: S = q2 k^T at
    d 256 (the f32 kernel's longest sum; bh 8 x 512, q/k = randn * 0.5)
    by the library's check entry point `rtt_scores_tf32x3`, as the kernel
    makes it (held to the plain f32 product at F32_REL_TOL), in one
    tensor-core chain over all of d (printed), and with its split rounded
    by the cvt.rna.tf32.f32 instruction (must equal the kernel's bit for
    bit); one TF32 term (the plain product under `allow_tf32`) must lie
    outside the bars. The entry point is no kernel of the op and counts
    no launch. Returns the max abs errors."""
    fn = attn._build.load("flash_fwd_any").rtt_scores_tf32x3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bh, t, d = 8, 512, 256
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k = (torch.randn(bh, t, d, generator=gen, device=dev) * 0.5
            for _ in range(2))
    q2 = attn.prescale(q, 1.0 / math.sqrt(d))
    ref = torch.matmul(q2, k.transpose(1, 2))
    got = {}
    for mode, label in enumerate(("chains", "one_chain", "cvt")):
        got[label] = torch.empty_like(ref)
        err = fn(q2.data_ptr(), k.data_ptr(), got[label].data_ptr(), bh, t,
                 t, d, mode, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"rtt_scores_tf32x3: CUDA error {err}"
    torch.cuda.synchronize()
    print(f"S = q2 k^T alone at {(bh, t, d)}, three-term TF32 (bars "
          f"{F32_REL_TOL:g}):")
    ok, chains = held("S, the kernel's chains", got["chains"], ref,
                      rel_tol=F32_REL_TOL)
    assert ok, chains
    _, one_chain = held("S, one chain over d", got["one_chain"], ref,
                        rel_tol=F32_REL_TOL)
    same = torch.equal(got["cvt"], got["chains"])
    print(f"  S split by cvt.rna.tf32.f32 equal bit for bit: {same}")
    assert same
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        print("  control, one TF32 term (must be outside the f32 bars):")
        ok, one_term = held("S", torch.matmul(q2, k.transpose(1, 2)), ref,
                            rel_tol=F32_REL_TOL)
        assert not ok, one_term
    finally:
        matmul.allow_tf32 = False
    return {"chains": chains, "one_chain": one_chain, "one_term": one_term}


def any_kernel_checks(torch, attn):
    """(b) for the "any" and "wide" kernels (`csrc/flash_fwd_any.cu`,
    `csrc/flash_bwd_any.cu`): each against its plain version at
    ANY_CASES under a random upstream gradient (f32 at F32_REL_TOL), the
    two negative controls, the controls of the f32 bar (the plain version
    with TF32 or bf16 products must lie outside it), and the public op
    against `mha_reference` in f32 at ANY_OP_CASES. Returns {label: (out
    err, lse err, max grad err)}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(dtype, *shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(
            dtype)

    results = {"scores_tf32x3": scores_tf32x3_check(torch, attn),
               "wide_chunks_agree": wide_chunks_agree(torch, attn)}
    for label, dt, bh, t, tk, d, causal, q_len, kv_len in ANY_CASES:
        dtype = getattr(torch, dt)
        pair = attn._kernel_for(dtype, d)
        assert pair in ("any", "wide"), (dt, d)
        q, k, v = randn(dtype, bh, t, d), randn(dtype, bh, tk, d), \
            randn(dtype, bh, tk, d)
        q[:, q_len:] = 0
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
        q2 = attn.prescale(q, 1.0 / math.sqrt(d))
        attn.reset_launch_counts()
        out, lse = attn.flash_forward(q2, k, v, causal, kv_len)
        torch.cuda.synchronize()
        assert attn.LAUNCHES[f"flash_fwd_{pair}"] == 1, attn.LAUNCHES
        assert out.dtype == dtype and out.shape == q2.shape, label
        p_out, p_lse = attn.flash_forward_plain(q2, k, v, causal, kv_len)
        f32 = dtype == torch.float32
        tol = F32_REL_TOL if f32 else REL_TOL
        lse_tol = (F32_REL_TOL * p_lse[:, :q_len].abs().max().item() if f32
                   else LSE_TOL)
        print(f"fwd {pair} {label} {(dt, bh, t, tk, d)} causal={causal} "
              f"(bars {tol:g}):")
        ok, e_out = held("out", out[:, :q_len], p_out[:, :q_len],
                         rel_tol=tol)
        e_lse = max_err(lse[:, :q_len], p_lse[:, :q_len])
        print(f"  lse: max err {e_lse:.3g} (bar {lse_tol:.3g})")
        assert ok and e_lse <= lse_tol, (label, e_out, e_lse)
        do = randn(dtype, bh, t, d)
        do[:, q_len:] = 0
        args = (q2, k, v, out, do, lse, 1.0 / math.sqrt(d), causal, kv_len,
                q_len)
        got = attn.flash_backward(*args)
        torch.cuda.synchronize()
        assert all(attn.LAUNCHES[n] == 1 for n in bwd_launches(pair)), \
            attn.LAUNCHES
        assert all(g.dtype == dtype for g in got), label
        ref = attn.flash_backward_plain(*args)
        print(f"bwd {pair} {label}, random do:")
        ok, errs = grads_held(got, ref, q_len, kv_len, rel_tol=tol)
        assert ok, (label, errs)
        if label in ("f32_d128", "f32_d512"):
            f32_bar_controls(torch, attn, args, p_out, ref)
        if label in ("bf16_d256", "bf16_d512"):
            print("  negative control, dq = 0 (must be outside the bars):")
            assert not grads_held((torch.zeros_like(got[0]),) + got[1:],
                                  ref, q_len, kv_len)[0]
            print("  negative control, do shifted one row (must be "
                  "outside the bars):")
            shifted = list(args)
            shifted[4] = do.roll(1, dims=1)
            assert not grads_held(attn.flash_backward(*shifted), ref,
                                  q_len, kv_len)[0]
        results[label] = (e_out, e_lse, max(errs))
        del q, k, v, q2, out, lse, p_out, p_lse, do, got, ref, args
    attn.reset_launch_counts()
    for dt, d in ANY_OP_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (randn(dtype, 1, 2, 512, d).requires_grad_()
                   for _ in range(3))
        do = randn(dtype, 1, 2, 512, d)
        out = attn.flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out, (q, k, v), do)
        qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
        ref = attn.mha_reference(qf, kf, vf, causal=True)
        ref_grads = torch.autograd.grad(ref, (qf, kf, vf), do.float())
        tol = F32_REL_TOL if dtype == torch.float32 else REL_TOL
        print(f"flash_attention ({dt}, d {d}) vs mha_reference (f32), "
              f"t 512 causal (bars {tol:g}):")
        checks = [held("out", out, ref, rel_tol=tol)] + [
            held(name, g, r, rel_tol=tol)
            for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads)]
        assert all(ok for ok, _ in checks), (dt, d)
    assert attn.LAUNCHES["flash_fwd"] == attn.LAUNCHES["flash_bwd"] == 0
    for pair in ("any", "wide"):
        n = sum(attn._kernel_for(getattr(torch, dt), d) == pair
                for dt, d in ANY_OP_CASES)
        assert attn.LAUNCHES[f"flash_fwd_{pair}"] == n, attn.LAUNCHES
        assert attn.LAUNCHES[f"flash_bwd_{pair}"] == n, attn.LAUNCHES
    torch.cuda.empty_cache()
    return results


def wide_chunks_agree(torch, attn):
    """(b) The "wide" kernels make S (and dP) over all of d in one order
    in every 256-column chunk, so the chunks' P, lse and dS agree to the
    bit: with q, k, v and do made of equal 256-column chunks (bh 4 x 256,
    causal, at d 512 and 608, in f32, bf16 and f16), the chunks of out, dk
    and dv must be equal bit for bit (dq sums in f32 reductions of no
    fixed order). Returns {"dtype d": True}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    bh, t = 4, 256
    agree = {}
    for dt, d in ((dt, d) for dt in ("float32", "bfloat16", "float16")
                  for d in (512, 608)):
        def chunked():
            x = torch.randn(bh, t, 256, generator=gen, device=dev) * 0.5
            return x.repeat(1, 1, -(-d // 256))[..., :d].to(
                getattr(torch, dt)).contiguous()

        q2 = attn.prescale(chunked(), 1.0 / math.sqrt(d))
        k, v, do = chunked(), chunked(), chunked()
        out, lse = attn.flash_forward(q2, k, v, True, t)
        _, dk, dv = attn.flash_backward(q2, k, v, out, do, lse,
                                        1.0 / math.sqrt(d), True, t, t)
        torch.cuda.synchronize()
        same = all(
            torch.equal(x[..., c0:c0 + min(256, d - c0)],
                        x[..., :min(256, d - c0)])
            for x in (out, dk, dv) for c0 in range(256, d, 256))
        print(f"{dt} wide d {d}: chunks of out, dk, dv equal bit for bit "
              f"(equal input chunks): {same}")
        assert same, (dt, d)
        agree[f"{dt} {d}"] = same
    return agree


def bwd_launches(pair):
    """The launch counters of the "any" or "wide" backward op."""
    return ("flash_bwd_any_pre", f"flash_bwd_{pair}", "flash_bwd_any_dq")


def f32_bar_controls(torch, attn, args, p_out, p_grads):
    """Controls of F32_REL_TOL on one f32 case: the plain version with its
    products in bf16 (inputs rounded), then in TF32, must lie outside the
    bars that the f32 kernels meet, so a kernel that took either shortcut
    would fail them."""
    q2, k, v, _, do, lse, scale, causal, kv_len, q_len = args
    rounded = [x.bfloat16().float() for x in (q2, k, v)]
    print("  control, plain f32 with bf16 products (must be outside the "
          "f32 bars):")
    assert not held("out", attn.flash_forward_plain(
        *rounded, causal, kv_len)[0][:, :q_len], p_out[:, :q_len],
        rel_tol=F32_REL_TOL)[0]
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        print("  control, plain f32 with TF32 products (must be outside "
              "the f32 bars):")
        assert not held("out", attn.flash_forward_plain(
            q2, k, v, causal, kv_len)[0][:, :q_len], p_out[:, :q_len],
            rel_tol=F32_REL_TOL)[0]
        assert not grads_held(attn.flash_backward_plain(*args), p_grads,
                              q_len, kv_len, rel_tol=F32_REL_TOL)[0]
    finally:
        matmul.allow_tf32 = False


def any_kernel_times(torch, attn):
    """The "any" and "wide" kernels timed at ANY_TIMED beside their plain
    versions, `scaled_dot_product_attention` (a yardstick only) and their
    bounds, each held to its plain version there. Returns {label:
    record}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out_records = {}
    for label, dt, bh, t, d in ANY_TIMED:
        dtype = getattr(torch, dt)
        scale = 1.0 / math.sqrt(d)
        q, k, v, do = ((torch.randn(bh, t, d, generator=gen, device=dev)
                        * 0.5).to(dtype) for _ in range(4))
        q2 = attn.prescale(q, scale)
        out, lse = attn.flash_forward(q2, k, v, True, t)
        p_out, _ = attn.flash_forward_plain(q2, k, v, True, t)
        fwd_err = max_err(out, p_out)
        f32 = dtype == torch.float32
        tol = F32_REL_TOL if f32 else REL_TOL
        ok_fwd, _ = held(f"timed fwd any {dt} out", out, p_out, rel_tol=tol)
        b = 2 if bh == 16 else 1
        q4, k4, v4, do4 = (x.view(b, bh // b, t, d) for x in (q, k, v, do))
        sdpa_err = None
        if f32:
            # The yardstick's own precision (not a check of the port).
            print("  sdpa f32 against the plain version (f32 bars; "
                  "printed, not held):")
            sdpa_out = sdpa(q4, k4, v4, is_causal=True, scale=scale)
            _, sdpa_err = held("sdpa out", sdpa_out.reshape(bh, t, d), p_out,
                               rel_tol=F32_REL_TOL)
            del sdpa_out
        del p_out
        bwd_args = (q2, k, v, out, do, lse, scale, True, t, t)
        got = attn.flash_backward(*bwd_args)
        ref = attn.flash_backward_plain(*bwd_args)
        ok_bwd, errs = grads_held(got, ref, t, t, rel_tol=tol)
        assert ok_fwd and ok_bwd, (dt, errs)
        del got, ref
        fwd_ms = cuda_ms(torch, lambda: attn.flash_forward(q2, k, v, True, t),
                         5)
        bwd_ms = cuda_ms(torch, lambda: attn.flash_backward(*bwd_args), 3)
        fwd_plain_ms = cuda_ms(
            torch, lambda: attn.flash_forward_plain(q2, k, v, True, t), 2)
        bwd_plain_ms = cuda_ms(
            torch, lambda: attn.flash_backward_plain(*bwd_args), 2)
        sdpa_fwd_ms = cuda_ms(
            torch, lambda: sdpa(q4, k4, v4, is_causal=True, scale=scale), 10)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
        sdpa_fwd_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True, scale=scale), (qg, kg, vg),
            do4), 5)
        peak = None if f32 else PEAK_BF16_FLOPS
        pairs = bh * valid_pairs(True, t, t)
        fwd_bound, fwd_by = bound_ms(
            4 * d * pairs, nbytes(q2, k, v, out, lse), peak)
        bwd_bound, bwd_by = bound_ms(
            10 * d * pairs, nbytes(q2, k, v, out, do, lse) + 3 * nbytes(q2),
            peak)
        rec = {
            "shape": [bh, t, d], "dtype": dt, "causal": True,
            "pair": attn._kernel_for(dtype, d),
            "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
            "fwd_library_ms": sdpa_fwd_ms, "fwd_bound_ms": fwd_bound,
            "fwd_bound_by": fwd_by, "fwd_max_abs_err": fwd_err,
            "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
            "bwd_library_ms": sdpa_fwd_bwd_ms - sdpa_fwd_ms,
            "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
            "bwd_max_abs_err": max(errs),
            "peak_flops": "f32: lesser of 67e12 and 495e12 / 3" if f32
            else peak,
        }
        if f32:
            rec["library_max_abs_err"] = sdpa_err
        pair = rec["pair"]
        if pair == "wide":
            # The column split makes S (and dP) once per 256-column chunk:
            # the bound of the work it does.
            nch = -(-d // 256)
            rec["fwd_split_bound_ms"] = bound_ms(
                2 * d * (nch + 1) * pairs, nbytes(q2, k, v, out, lse), peak)[0]
            rec["bwd_split_bound_ms"] = bound_ms(
                2 * d * (2 * nch + 3) * pairs,
                nbytes(q2, k, v, out, do, lse) + 3 * nbytes(q2), peak)[0]
        print(f"flash_fwd_{pair} {dt} {(bh, t, d)}: {fwd_ms:.3f} ms (plain "
              f"{fwd_plain_ms:.2f}, sdpa {sdpa_fwd_ms:.3f}, bound "
              f"{fwd_bound:.3f} by {fwd_by}); flash_bwd_{pair} op {bwd_ms:.3f} "
              f"ms (plain {bwd_plain_ms:.2f}, sdpa bwd "
              f"{rec['bwd_library_ms']:.3f}, bound {bwd_bound:.3f} by "
              f"{bwd_by})")
        if label == "bf16_d256":
            rec["softmax_data"] = softmax_data_times(torch, attn, q, k, v, do,
                                                     scale, t)
        out_records[label] = rec
        del q, k, v, do, q2, out, lse, bwd_args, q4, k4, v4, do4, qg, kg, vg
        torch.cuda.empty_cache()
    return out_records


def card_clocks():
    """The card's SM clock (now and its maximum, MHz), power draw (W) and
    temperature (C), as nvidia-smi reads them; None where it cannot."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
             "temperature.gpu", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.splitlines()[0]
        return [float(x) for x in line.split(",")]
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def softmax_data_times(torch, attn, q, k, v, do, scale, t):
    """Whether the "any" pair's time depends on the data: the same q, k,
    v and do under three softmaxes. q pre-scaled as the op does (logits
    of std about 0.36 in the log2 domain); q scaled by log2(e) alone, as
    if 1/sqrt(d) were left out (std about 5.8: a sharp softmax, as a
    trained model's can be); and 8 times that (std about 46: nearly one
    hot, with P values that are subnormal or zero in f32, exp2 below
    2^-126, whose share is counted on two heads). Timed in turns
    pre-scaled, sharp, sharpest, sharpest, sharp, pre-scaled, each beside
    the card's clocks read after it; both sharp variants are held to
    their plain versions. Returns the record."""
    variants = {}
    rec = {"order": [], "fwd_ms": {}, "bwd_ms": {}, "clocks": {},
           "p_subnormal_share": {}, "p_zero_share": {}}
    for name, s in (("prescaled", scale), ("sharp", 1.0), ("sharpest", 8.0)):
        q2 = attn.prescale(q, s)
        out, lse = attn.flash_forward(q2, k, v, True, t)
        args = (q2, k, v, out, do, lse, scale, True, t, t)
        variants[name] = (q2, args)
        if name == "prescaled":
            continue
        p_out, _ = attn.flash_forward_plain(q2, k, v, True, t)
        print(f"{name} softmax, fwd any bfloat16:")
        ok_fwd, _ = held("out", out, p_out)
        del p_out
        print(f"{name} softmax, bwd any bfloat16:")
        ok_bwd, errs = grads_held(attn.flash_backward(*args),
                                  attn.flash_backward_plain(*args), t, t)
        assert ok_fwd and ok_bwd, (name, errs)
        s2 = torch.matmul(q2[:2].float(), k[:2].float().transpose(1, 2))
        valid = torch.ones(t, t, dtype=torch.bool, device=s2.device).tril()
        e = (s2 - lse[:2, :, None]).masked_select(valid)
        del s2
        rec["p_subnormal_share"][name] = (
            (e < -126) & (e >= -149)).float().mean().item()
        rec["p_zero_share"][name] = (e < -149).float().mean().item()
        del e
    for name in ("prescaled", "sharp", "sharpest", "sharpest", "sharp",
                 "prescaled"):
        q2, args = variants[name]
        fwd = cuda_ms(torch, lambda: attn.flash_forward(q2, k, v, True, t), 5)
        bwd = cuda_ms(torch, lambda: attn.flash_backward(*args), 3)
        rec["order"].append(name)
        rec["fwd_ms"].setdefault(name, []).append(fwd)
        rec["bwd_ms"].setdefault(name, []).append(bwd)
        rec["clocks"].setdefault(name, []).append(card_clocks())
    print(f"\"any\" pair by softmax (bf16 {tuple(q.shape)}, causal; turns "
          f"{rec['order']}): fwd ms {rec['fwd_ms']}, bwd op ms "
          f"{rec['bwd_ms']}; P subnormal {rec['p_subnormal_share']}, zero "
          f"{rec['p_zero_share']}; clocks [sm MHz, max sm MHz, W, C] "
          f"{rec['clocks']}")
    del variants
    return rec


def weights_digest(torch, state):
    """{name: (dtype, shape, device type, weighted sum of the bytes)}: two
    state dicts with equal digests hold the same bytes (a changed byte
    moves its tensor's sum by its weight, 1-251)."""
    out = {}
    for name, t in state.items():
        raw = t.detach().contiguous().view(-1).view(torch.uint8)
        total = 0
        for chunk in raw.split(1 << 26):
            w = torch.arange(chunk.numel(), device=chunk.device) % 251 + 1
            total += int((chunk.long() * w).sum().item())
        out[name] = (str(t.dtype), tuple(t.shape), t.device.type, total)
    return out


class CardStepper:
    """(h1)'s actor, in a `num_gpus=1` worker of the port's runtime: the
    weights and batch from the object store, then `RUNTIME_STEPS` steps
    of phase (c)'s step with the flash kernels."""

    def probe(self):
        import torch

        import ray_tpu_torch as rt

        return {"cuda": torch.cuda.is_available(),
                "accelerator_ids": rt.get_runtime_context()
                .get_accelerator_ids(),
                "device": torch.cuda.get_device_name(0)}

    def train(self, weights, batch, n_layers):
        import torch

        from ray_tpu_torch.models import llama
        from ray_tpu_torch.ops import attention as attn
        from ray_tpu_torch.train import default_optimizer, make_train_step

        torch.backends.cuda.matmul.allow_tf32 = False
        on_card = all(t.device.type == "cuda" for t in weights.values())
        digest = weights_digest(torch, weights)
        cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
        model = llama.Llama(cfg, device="cuda")
        model.load_state_dict(weights)
        del weights
        init_fn, step_fn = make_train_step(
            llama.loss_fn, default_optimizer(learning_rate=3e-4,
                                             total_steps=20), device="cuda")
        state = init_fn(model)
        rec = train_steps(torch, llama, attn, cfg, state, step_fn,
                          batch[:, :-1], batch[:, 1:], steps=RUNTIME_STEPS)
        rec.update({"weights_on_card": on_card, "digest": digest,
                    "batch_on_card": batch.device.type == "cuda"})
        return rec


def runtime_phase(torch, card, weights_ref, batch_ref, digest, losses,
                  step_ms, n_layers):
    """(h1): phase (c)'s weights and batch, put by the driver before its
    steps, go to a `num_gpus=1` actor that trains two steps; a CPU task
    sees no card; a 1 GiB bf16 CPU tensor is put and got. Returns the
    `{"runtime": ...}` record."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.serialization import SerializationContext

    rec = {"card": card}
    stepper = rt.remote(num_gpus=1)(CardStepper).remote()
    t0 = time.perf_counter()
    rec["actor_probe"] = rt.get(stepper.probe.remote(), timeout=300)
    rec["actor_start_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = rt.get(stepper.train.remote(weights_ref, batch_ref, n_layers),
                 timeout=600)
    rec["actor_call_s"] = time.perf_counter() - t0
    rt.kill(stepper)

    @rt.remote
    def cpu_probe():
        import torch

        return {"cuda": torch.cuda.is_available(),
                "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES")}

    rec["cpu_task"] = rt.get(cpu_probe.remote(), timeout=120)
    big = torch.arange(RUNTIME_PUT_BYTES // 2, dtype=torch.int16).view(
        torch.bfloat16)
    buffers = len(SerializationContext().serialize(big).buffers)
    t0 = time.perf_counter()
    ref = rt.put(big)
    put_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = rt.get(ref)
    get_ms = (time.perf_counter() - t0) * 1e3
    equal = back.dtype == torch.bfloat16 and torch.equal(
        back.view(torch.int16), big.view(torch.int16))
    del ref, back, big
    step2_rel = rel(got["losses"][1], losses[1])
    rec.update({
        "losses": got["losses"], "driver_losses": losses[:RUNTIME_STEPS],
        "step1_equal": got["losses"][0] == losses[0],
        "step2_rel": step2_rel, "step_ms": got["step_ms"],
        "driver_step_ms": step_ms[:RUNTIME_STEPS],
        "steady_step_ms": got["steady_step_ms"],
        "max_memory_allocated": got["max_memory_allocated"],
        "launches": got["launches"],
        "weights_on_card": got["weights_on_card"],
        "batch_on_card": got["batch_on_card"],
        "weights_bit_for_bit": got["digest"] == digest,
        "put_1gib_bf16": {"buffers": buffers, "put_ms": put_ms,
                          "get_ms": get_ms, "equal": equal},
    })
    print(f"(h1) runtime actor (num_gpus=1) on {rec['actor_probe']}: losses "
          f"{got['losses']} against the driver's {losses[:RUNTIME_STEPS]} "
          f"(step 1 equal: {rec['step1_equal']}, step 2 relative "
          f"{step2_rel:.2e}), step ms {[round(x, 2) for x in got['step_ms']]}"
          f" against the driver's {[round(x, 2) for x in rec['driver_step_ms']]}"
          f", weights on the card bit for bit: "
          f"{rec['weights_on_card'] and rec['weights_bit_for_bit']}, "
          f"launches {got['launches']}; CPU task {rec['cpu_task']}; 1 GiB "
          f"bf16 put {put_ms:.1f} ms, get {get_ms:.1f} ms, {buffers} "
          f"out-of-band buffer, equal {equal}")
    assert rec["actor_probe"]["cuda"], rec
    # The actor sees this host's cards, and is told so.
    assert len(rec["actor_probe"]["accelerator_ids"]["GPU"]) == \
        torch.cuda.device_count(), rec
    assert rec["weights_on_card"] and rec["batch_on_card"], rec
    assert rec["weights_bit_for_bit"], "weights changed in the store"
    assert rec["step1_equal"], (got["losses"], losses)
    assert step2_rel <= RUNTIME_STEP2_REL, step2_rel
    assert got["launches"]["flash_fwd"] == RUNTIME_STEPS * n_layers * 2
    assert not rec["cpu_task"]["cuda"], rec["cpu_task"]
    assert buffers == 1 and equal, rec["put_1gib_bf16"]
    return rec


def gemma_phase(torch, llama, attn, card, dev, profile=False):
    """(h2): Gemma-2B (`LlamaConfig.gemma_2b()`, 18 layers, head_dim
    256, bf16) at full width under remat "full", random weights from a
    seed, batch GEMMA_BATCH x GEMMA_SEQ, GEMMA_STEPS steps of
    `make_train_step`: the loss must be finite and fall, and every flash
    launch must go to the "any" kernels. Returns the `{"gemma": ...}`
    record."""
    from ray_tpu_torch.train import default_optimizer, make_train_step

    cfg = llama.LlamaConfig.gemma_2b(max_seq_len=GEMMA_SEQ,
                                     remat_policy="full")
    g = torch.Generator(device=dev).manual_seed(9)
    model = llama.init_params(cfg, g, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (GEMMA_BATCH, GEMMA_SEQ + 1),
                          generator=g, device=dev)
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=3e-4, total_steps=20),
        device=dev)
    state = init_fn(model)
    del model
    rec = train_steps(torch, llama, attn, cfg, state, step_fn, batch[:, :-1],
                      batch[:, 1:], profile, steps=GEMMA_STEPS)
    n = cfg.n_layers
    launches = rec["launches"]
    per_step = {k: v / GEMMA_STEPS for k, v in launches.items()}
    rec.update({"card": card, "config": "gemma_2b, 18 layers, head_dim 256, "
                "bf16, remat full", "layers": n, "params": cfg.num_params(),
                "batch": GEMMA_BATCH, "seq": GEMMA_SEQ,
                "launches_per_step": per_step})
    print(f"(h2) Gemma-2B ({n} layers, {cfg.num_params()} parameters): losses "
          f"{[round(x, 5) for x in rec['losses']]}, step ms "
          f"{[round(x, 2) for x in rec['step_ms']]}, {rec['tokens_per_s']:.0f}"
          f" tokens/s, MFU {rec['mfu']:.4f}, peak "
          f"{rec['max_memory_allocated']} B, launches per step {per_step}")
    assert all(math.isfinite(x) for x in rec["losses"] + rec["grad_norms"])
    assert rec["losses"][-1] < rec["losses"][0], rec["losses"]
    assert launches["flash_fwd"] == 0 and launches["flash_bwd"] == 0, launches
    assert launches["flash_fwd_any"] == GEMMA_STEPS * n * 2, launches
    for name in bwd_launches("any"):
        assert launches[name] == GEMMA_STEPS * n, launches
    del state, step_fn, init_fn, batch
    torch.cuda.empty_cache()
    return rec


def wide_phase(torch, llama, attn, card, dev, dtype=None, steps=WIDE_STEPS,
               head_dim=WIDE_HEAD_DIM, label="(h3)"):
    """(h3) and (h4): the kernels of one head_dim on a training path.
    Gemma-2B's geometry with `head_dim` (WIDE_HEAD_DIM: the "wide"
    kernels', which no preset has; 256: Gemma-2B's own, the "any"
    kernels'), WIDE_LAYERS layers, random weights from a seed, batch 1 x
    WIDE_SEQ, `steps` steps of `make_train_step` under remat "full", in
    bf16 (the preset's dtype) or `dtype`: the loss must be finite and
    fall, and every flash launch must go to the pair `_kernel_for` names.
    Returns the record."""
    from ray_tpu_torch.train import default_optimizer, make_train_step

    cfg = dataclasses.replace(
        llama.LlamaConfig.gemma_2b(max_seq_len=WIDE_SEQ, remat_policy="full"),
        n_layers=WIDE_LAYERS, custom_head_dim=head_dim)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    dt = str(cfg.dtype).replace("torch.", "")
    g = torch.Generator(device=dev).manual_seed(10)
    model = llama.init_params(cfg, g, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (1, WIDE_SEQ + 1), generator=g,
                          device=dev)
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=3e-4, total_steps=20),
        device=dev)
    state = init_fn(model)
    del model
    rec = train_steps(torch, llama, attn, cfg, state, step_fn, batch[:, :-1],
                      batch[:, 1:], False, steps=steps)
    n = cfg.n_layers
    pair = attn._kernel_for(cfg.dtype, head_dim)
    other = {"any": "wide", "wide": "any"}[pair]
    launches = rec["launches"]
    per_step = {k: v / steps for k, v in launches.items()}
    rec.update({"card": card, "config": f"gemma_2b geometry, {n} layers, "
                f"head_dim {head_dim}, {dt}, remat full", "layers": n,
                "dtype": dt, "batch": 1, "seq": WIDE_SEQ, "pair": pair,
                "launches_per_step": per_step})
    print(f"{label} head_dim {head_dim} ({n} layers, {dt}): losses "
          f"{[round(x, 5) for x in rec['losses']]}, step ms "
          f"{[round(x, 2) for x in rec['step_ms']]}, peak "
          f"{rec['max_memory_allocated']} B, launches per step {per_step}")
    assert all(math.isfinite(x) for x in rec["losses"] + rec["grad_norms"])
    assert rec["losses"][-1] < rec["losses"][0], rec["losses"]
    assert launches["flash_fwd"] == launches[f"flash_fwd_{other}"] == 0, \
        launches
    assert launches["flash_bwd"] == launches[f"flash_bwd_{other}"] == 0, \
        launches
    assert launches[f"flash_fwd_{pair}"] == steps * n * 2, launches
    for name in bwd_launches(pair):
        assert launches[name] == steps * n, launches
    del state, step_fn, init_fn, batch
    torch.cuda.empty_cache()
    return rec


def cards_trainer_loop(config):
    """`--cards 4`'s `TorchTrainer(num_workers=4)` loop, on each rank of
    the runtime gang (NCCL, a card each): `cards_rank`'s fsdp=4 run, the
    same weights and batch, each step reported."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import (
        default_optimizer,
        make_train_step,
        report,
        shard_batch,
    )

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama2_7b(n_layers=config["n_layers"],
                                      max_seq_len=SEQ,
                                      remat_policy="dots_flash")
    init_state, _ = flagship_inputs(torch, llama, cfg, dev)
    batch = torch.randint(0, cfg.vocab_size, (CARDS4_BATCH, SEQ + 1),
                          generator=torch.Generator(device=dev).manual_seed(6),
                          device=dev)
    mesh = MeshSpec(fsdp=4).build("cuda")
    model = llama.Llama(cfg, device=dev)
    model.load_state_dict(init_state)
    del init_state
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=3e-4, total_steps=20),
        mesh, llama.param_annotations(cfg))
    rec = train_steps(torch, llama, attn, cfg, init_fn(model), step_fn,
                      shard_batch(batch[:, :-1], mesh),
                      shard_batch(batch[:, 1:], mesh))
    for loss, ms in zip(rec["losses"], rec["step_ms"]):
        report({"loss": loss, "step_ms": ms})
    return rec


def trainer_gang_run(n_layers, fsdp4_losses, timeout=420.0):
    """`--cards 4`: `TorchTrainer(num_workers=4)` on a gang of the port's
    runtime actors (`num_gpus=1` each), joined by `TorchBackend` on NCCL,
    running `cards_trainer_loop` (fsdp=4). Its losses must equal the
    local gang's fsdp4 run's to CARDS4_LOSS_REL. A fit still running
    after `timeout` seconds fails the phase (the runtime's shutdown at
    exit kills its workers)."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    rt.init(num_cpus=8, num_gpus=4)
    try:
        box = {}
        trainer = TorchTrainer(cards_trainer_loop,
                               train_loop_config={"n_layers": n_layers},
                               scaling_config=ScalingConfig(num_workers=4))
        fit = threading.Thread(target=lambda: box.update(r=trainer.fit()),
                               daemon=True)
        t0 = time.perf_counter()
        fit.start()
        fit.join(timeout)
        if fit.is_alive():
            raise TimeoutError(f"TorchTrainer(num_workers=4) still running "
                               f"after {timeout} s")
        result = box["r"]
        wall_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
    assert result.error is None, result.error
    losses = [m["loss"] for m in result.metrics_history]
    step_ms = [m["step_ms"] for m in result.metrics_history]
    diffs = [rel(a, b) for a, b in zip(losses, fsdp4_losses)]
    print(f"--cards 4, TorchTrainer(num_workers=4) on the runtime gang: "
          f"losses {[round(x, 5) for x in losses]} (local gang fsdp4: "
          f"{[round(x, 5) for x in fsdp4_losses]}), step ms "
          f"{[round(x, 2) for x in step_ms]}, fit {wall_s:.1f} s, ranks "
          f"reporting {len(result.metrics_by_rank)}")
    assert len(result.metrics_by_rank) == 4, result.metrics_by_rank
    assert all(len(h) == len(losses) for h in result.metrics_by_rank)
    assert losses[-1] < losses[0], losses
    assert all(d <= CARDS4_LOSS_REL for d in diffs), diffs
    return {"losses": losses, "step_ms": step_ms,
            "steady_step_ms": statistics.median(step_ms[1:]),
            "loss_rel_to_local_gang": diffs, "fit_s": wall_s,
            "ranks_reporting": len(result.metrics_by_rank)}


def profile_serving(torch, gen, model, cfg, ec, live, dev):
    """One paged decode step over a full batch whose rows hold `live`
    tokens each, and one prefill chunk, each timed by the host clock
    (mean of 5 after a warm-up) and then traced by `profile_step`."""
    nb = ec.max_len // 16
    pool = gen.init_block_pool(cfg, ec.slots * nb + 1, 16, device=dev)
    tables = torch.arange(1, ec.slots * nb + 1, device=dev).view(ec.slots, nb)
    last = torch.randn(ec.slots, cfg.vocab_size, device=dev)
    positions = torch.full((ec.slots,), live, device=dev)
    alive = torch.ones(ec.slots, dtype=torch.bool, device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (1, ec.prefill_chunk), device=dev)
    off = (live // ec.prefill_chunk) * ec.prefill_chunk
    runs = {
        "decode_step": lambda: gen.paged_decode_step(
            model, cfg, pool, tables, last, positions, alive),
        "prefill_chunk": lambda: gen.paged_prefill(
            model, cfg, chunk, pool, tables[:1], off, off + ec.prefill_chunk),
    }
    out = {"live_tokens": live, "prefill_offset": off}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        out[name] = {"host_clock_ms": (time.perf_counter() - t0) / 5 * 1e3,
                     **profile_step(torch, run)}
        print(f"serve profile, {name}: {out[name]['host_clock_ms']:.2f} ms, "
              f"device busy {out[name]['device_busy_ms']:.2f} ms of "
              f"{out[name]['wall_ms']:.2f} traced, idle share "
              f"{out[name]['idle_share']:.3f}")
    return out


def profile_step(torch, run_step):
    """Device time by kernel over one traced step, grouped into the
    flash kernels, matrix products, NCCL's collectives and the rest; and
    the device's idle share of the step's wall time (the profiler's own
    cost included), of the compute kernels (the collectives overlap
    them on their own streams)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # c10d marks each NCCL kernel's span again on the device as
    # "nccl:<op>": count the kernel once.
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("nccl:")]
    kernels.sort(key=lambda row: -row[1])
    groups = {"flash": 0.0, "matmul": 0.0, "nccl": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        low = name.lower()
        if any(k in low for k in FLASH_KERNELS):
            groups["flash"] += ms
        elif "nccl" in low:
            groups["nccl"] += ms
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    # NCCL's kernels run on their own streams, beside the compute.
    busy_ms = sum(ms for group, ms in groups.items() if group != "nccl")
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms, "groups_ms": groups,
        "top": [{"kernel": n[:120], "ms": ms, "calls": c}
                for n, ms, c in kernels[:12]],
    }


# ---- (i) the RL slice ------------------------------------------------

#: (i): the seed of every batch, init and run; (i1)'s bar (parameters of
#: the card's learner against the CPU's after one update, as ROADMAP
#: queue 3 holds Adam trajectories); (i2)'s return bar within the
#: reference's 25 iterations (`tests/test_rl.py:56-75`); (i3)'s updates
#: before and after a runner is killed.
RL_SEED = 0
RL_PARAM_TOL = 1e-4
RL_ROWS = 4096
RL_MINIBATCH = 128
RL_EPOCHS = 4
RL_LR = 1e-3
RL_DQN_UPDATES = 8
RL_RETURN_BAR = 100.0
RL_MAX_ITERATIONS = 25
RL_ENGINE_RUNNERS = 4
RL_ENGINE_UPDATES = 8
RL_UPDATES_AFTER_KILL = 3
#: (i4): the RLHF push at the Llama-2-7B width. Streams of RL_PUSH_PROMPT
#: tokens; the old ones (weights A) get a budget they do not reach before
#: they are cancelled, once the new ones (weights B) have decoded
#: RL_PUSH_NEW tokens each; the object store is sized for B.
RL_PUSH_LAYERS = N_LAYERS
RL_PUSH_STREAMS = 8
RL_PUSH_PROMPT = 128
RL_PUSH_NEW = 64
RL_PUSH_OLD_BUDGET = 3840
RL_PUSH_TAKE = 2
RL_PUSH_STORE_BYTES = 8 << 30
RL_PUSH_SEEDS = (21, 22)


def rl_batch(n, seed):
    """A CartPole-shaped PPO batch (obs 4, 2 actions) of `n` rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "obs": (rng.normal(size=(n, 4)) * [1.0, 0.5, 0.1, 0.5]).astype(
            np.float32),
        "actions": rng.integers(0, 2, size=n).astype(np.int32),
        "logp": (np.log(0.5) + 0.1 * rng.normal(size=n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": (10 * rng.random(n)).astype(np.float32),
    }


def tree_err(a, b):
    """Max abs difference of two policy trees, and whether every leaf is
    within RL_PARAM_TOL (rtol and atol)."""
    import numpy as np

    from ray_tpu_torch.rl.models import policy_state

    sa, sb = policy_state(a), policy_state(b)
    err = max(float(np.abs(sa[k] - sb[k]).max()) for k in sa)
    ok = all(np.allclose(sa[k], sb[k], rtol=RL_PARAM_TOL, atol=RL_PARAM_TOL)
             for k in sa)
    return err, ok


def rl_learners(torch, dev):
    """(i1): `TorchLearner` on `dev` and on the CPU from the same seeded
    weights take one update over RL_ROWS rows; `DQNLearner` takes
    RL_DQN_UPDATES TD updates. Each control is the CPU learner one step
    short, which must fall outside the bar."""
    import numpy as np

    from ray_tpu_torch.rl import DQNLearner, TorchLearner

    def short_by_one(learner, total):
        """Skip `learner`'s last optimizer step of `total`."""
        step, count = learner._step, [0]

        def skip_last(grads):
            count[0] += 1
            if count[0] < total:
                step(grads)

        learner._step = skip_last

    kw = dict(minibatch_size=RL_MINIBATCH, num_epochs=RL_EPOCHS, lr=RL_LR,
              hidden=(64, 64), seed=RL_SEED)
    card = TorchLearner(4, 2, device=dev, **kw)
    host = TorchLearner(4, 2, device="cpu", **kw)
    short = TorchLearner(4, 2, device="cpu", **kw)
    short_by_one(short, RL_EPOCHS * (RL_ROWS // RL_MINIBATCH))
    assert tree_err(card.get_weights(), host.get_weights())[0] == 0.0
    batch = rl_batch(RL_ROWS, RL_SEED)
    metrics = card.update(batch)
    host_metrics = host.update(batch)
    short.update(batch)
    err, ok = tree_err(card.get_weights(), host.get_weights())
    control_err, control_ok = tree_err(card.get_weights(),
                                       short.get_weights())
    # One more update of each, timed (the metrics' float() waits).
    times = {}
    for name, learner in (("card", card), ("host", host)):
        t0 = time.perf_counter()
        learner.update(batch)
        times[name] = (time.perf_counter() - t0) * 1e3
    card_ms, host_ms = times["card"], times["host"]
    print(f"(i1) TorchLearner, one update of {RL_ROWS} rows (minibatch "
          f"{RL_MINIBATCH}, {RL_EPOCHS} epochs) on {dev} against the CPU: "
          f"params max err {err:.3g} (bar {RL_PARAM_TOL} rtol/atol); one "
          f"step short (control, must fail): {control_err:.3g}; a second "
          f"update {card_ms:.1f} ms on {dev}, {host_ms:.1f} ms on the CPU")
    assert ok, err
    assert not control_ok, control_err
    for k, v in metrics.items():
        assert np.isclose(v, host_metrics[k], rtol=RL_PARAM_TOL,
                          atol=RL_PARAM_TOL), (k, v, host_metrics[k])

    rng = np.random.default_rng(RL_SEED + 1)
    n = RL_ROWS
    transitions = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=n).astype(np.int32),
        "rewards": np.ones(n, np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "dones": (rng.random(n) < 0.05).astype(np.float32),
    }
    dqn_kw = dict(learning_starts=0, train_batch_size=64,
                  target_update_freq=4, seed=RL_SEED)
    learners = {}
    for name, device, steps in (("card", dev, RL_DQN_UPDATES),
                                ("host", "cpu", RL_DQN_UPDATES),
                                ("short", "cpu", RL_DQN_UPDATES - 1)):
        learner = DQNLearner(4, 2, device=device, **dqn_kw)
        learner.ingest(transitions)
        t0 = time.perf_counter()
        loss = learner.td_steps(steps)
        learners[name] = (learner, loss, (time.perf_counter() - t0) * 1e3)
    dqn_err, dqn_ok = tree_err(learners["card"][0].get_weights(),
                               learners["host"][0].get_weights())
    dqn_control, dqn_control_ok = tree_err(
        learners["card"][0].get_weights(), learners["short"][0].get_weights())
    print(f"(i1) DQNLearner, {RL_DQN_UPDATES} TD updates on {dev} against "
          f"the CPU: params max err {dqn_err:.3g}; one update short "
          f"(control): {dqn_control:.3g}; {learners['card'][2]:.1f} ms on "
          f"{dev} (first calls included)")
    assert dqn_ok, dqn_err
    assert not dqn_control_ok, dqn_control
    return {"ppo": {"max_abs_err": err, "control_max_abs_err": control_err,
                    "update_ms": card_ms, "cpu_update_ms": host_ms,
                    "metrics": metrics, "rows": RL_ROWS,
                    "minibatch": RL_MINIBATCH, "epochs": RL_EPOCHS},
            "dqn": {"max_abs_err": dqn_err, "control_max_abs_err": dqn_control,
                    "td_ms": learners["card"][2],
                    "td_loss": learners["card"][1],
                    "cpu_td_loss": learners["host"][1]},
            "bar": RL_PARAM_TOL}


def rl_sync_ppo(dev):
    """(i2): synchronous PPO at `PPOConfig()`'s defaults, the learner on
    `dev`, the runners actors on the host, until the mean return reaches
    RL_RETURN_BAR within RL_MAX_ITERATIONS iterations."""
    from ray_tpu_torch.rl import PPOConfig

    import torch

    algo = (PPOConfig().environment("CartPole-v1")
            .learners(device=dev.type).debugging(seed=RL_SEED).build())
    update, update_ms, last_batch = algo.learner.update, [], []

    def timed_update(batch):
        last_batch[:] = [batch]
        t0 = time.perf_counter()
        out = update(batch)  # the metrics' float() waits for the card
        update_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    algo.learner.update = timed_update
    returns, iter_s = [], []
    try:
        for _ in range(RL_MAX_ITERATIONS):
            t0 = time.perf_counter()
            result = algo.train()
            iter_s.append(time.perf_counter() - t0)
            returns.append(result["episode_return_mean"])
            if returns[-1] >= RL_RETURN_BAR:
                break
        # (j2)'s counts of the run, then (j4): the watch's hot path on a
        # minibatch update's argument beside that update's own time.
        learner = algo.learner
        watch = {"counts": watch_counts(["rl."])}
        minibatch = {k: v[:learner.minibatch_size]
                     for k, v in learner.to_device(last_batch[0]).items()}
        step_ms = []
        for _ in range(20):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            learner._update_jit(minibatch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        watch.update(hot_path_us=hot_path_us((minibatch,)),
                     step_ms=statistics.median(step_ms[1:]))
    finally:
        algo.stop()
    cfg = algo.config
    print(f"(i2) synchronous PPO, learner on {dev}, {cfg.num_env_runners} "
          f"runners x {cfg.num_envs_per_runner} envs x "
          f"{cfg.rollout_length} steps: {len(returns)} iterations, returns "
          f"{[round(r, 1) for r in returns]}, learner update "
          f"{statistics.median(update_ms):.1f} ms (median; first "
          f"{update_ms[0]:.1f}), iteration {statistics.median(iter_s):.2f} s")
    assert max(returns) >= RL_RETURN_BAR, returns
    return {"compile_watch": watch,
            "iterations": len(returns), "returns": returns,
            "update_ms": update_ms, "iteration_s": iter_s,
            "rows_per_iteration": cfg.num_env_runners
            * cfg.num_envs_per_runner * cfg.rollout_length,
            "bar": RL_RETURN_BAR, "max_iterations": RL_MAX_ITERATIONS}


def rl_engine_ppo(rt, dev):
    """(i3): decoupled PPO with the policy served by `PolicyEngineActor`
    on `dev`, RL_ENGINE_RUNNERS runners: RL_ENGINE_UPDATES updates, then
    one runner killed and RL_UPDATES_AFTER_KILL more."""
    from ray_tpu_torch.rl import PPOConfig

    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=RL_ENGINE_RUNNERS)
            .dataflow(policy="engine").learners(device=dev.type)
            .debugging(seed=RL_SEED).build())
    cfg = algo.config
    results = []
    try:
        t0 = time.perf_counter()
        for _ in range(RL_ENGINE_UPDATES):
            results.append(algo.train())
        wall_s = time.perf_counter() - t0
        before = algo.flow.stats()
        engine = algo.flow.engine_stats()
        rt.kill(algo.flow.runner_handle(0))
        for _ in range(RL_UPDATES_AFTER_KILL):
            results.append(algo.train())
        after = algo.flow.stats()
        engine_after = algo.flow.engine_stats()
    finally:
        algo.stop()
    returns = [r["episode_return_mean"] for r in results]
    per_step = {int(k): v for k, v in
                engine["policy_requests_per_step"].items()}
    batched = sum(v for k, v in per_step.items() if k > 1)
    rows_per_forward = engine["policy_rows_served"] / engine["policy_steps"]
    print(f"(i3) decoupled PPO, policy engine on {dev}, "
          f"{RL_ENGINE_RUNNERS} runners x {cfg.num_envs_per_runner} envs: "
          f"{RL_ENGINE_UPDATES} updates in {wall_s:.1f} s, returns "
          f"{[round(r, 1) for r in returns]}, weight versions "
          f"{[r['weight_version'] for r in results]}, fragments "
          f"{before['fragments_ok']} ok; engine forwards "
          f"{engine['policy_steps']}, {rows_per_forward:.1f} rows each on "
          f"average, {batched} serving 2 or more runners' requests "
          f"(requests per forward: {per_step}); after the kill: "
          f"{after['runner_failures']} runner failure(s), fragments "
          f"{after['fragments_ok']} ok, {after['fragments_dropped']} dropped")
    n = RL_ENGINE_UPDATES + RL_UPDATES_AFTER_KILL
    assert [r["weight_version"] for r in results] == list(range(1, n + 1))
    assert engine["weight_version"] == RL_ENGINE_UPDATES, engine
    assert engine_after["weight_version"] == n and not engine_after["dead"]
    assert before["fragments_ok"] >= RL_ENGINE_UPDATES, before
    assert batched > 0 and max(per_step) > 1, per_step
    assert returns[RL_ENGINE_UPDATES - 1] > returns[0], returns
    assert after["runner_failures"] >= 1, after
    assert after["fragments_ok"] > before["fragments_ok"], (before, after)
    return {"runners": RL_ENGINE_RUNNERS, "updates": RL_ENGINE_UPDATES,
            "updates_after_kill": RL_UPDATES_AFTER_KILL, "wall_s": wall_s,
            "returns": returns,
            "update_ms": [r["update_ms"] for r in results],
            "weight_sync_ms": [r["weight_sync_ms"] for r in results],
            "weight_versions": [r["weight_version"] for r in results],
            "engine_steps": engine["policy_steps"],
            "engine_rows": engine["policy_rows_served"],
            "rows_per_forward": rows_per_forward,
            "requests_per_forward": per_step,
            "forwards_serving_several_runners": batched,
            "before_kill": before, "after_kill": after,
            "compile_watch": {"counts": watch_counts(["rl."]),
                              "engine_compiles": engine["compiles"]}}


class EngineHost:
    """(i4)'s actor: an `InferenceEngine` over weights drawn from a seed
    on its own device, streams consumed as they are asked for, and
    `update_weights` taking a state dict as `push_weights` sends it."""

    def __init__(self, cfg, seed, engine_kw, device):
        import torch

        from ray_tpu_torch.llm import EngineConfig, InferenceEngine
        from ray_tpu_torch.models import llama

        self.cfg, self.device = cfg, torch.device(device)
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.model = llama.init_params(cfg, g, device=self.device)
        self.engine = InferenceEngine(self.model, cfg,
                                      EngineConfig(**engine_kw),
                                      family="rlhf")
        self.streams, self.outs, self.at_push = [], [], None

    def digest(self):
        import torch

        return weights_digest(torch, self.model.state_dict())

    def submit(self, prompts, max_new):
        first = len(self.streams)
        for p in prompts:
            self.streams.append(self.engine.submit(p, max_new_tokens=max_new))
            self.outs.append([])
        return list(range(first, len(self.streams)))

    def take(self, ids, n):
        """Read `n` more tokens of each stream of `ids`."""
        for i in ids:
            for _ in range(n):
                self.outs[i].append(next(self.streams[i]))
        return [len(self.outs[i]) for i in ids]

    def update_weights(self, state, *, version):
        from ray_tpu_torch.models import llama

        t0 = time.perf_counter()
        model = llama.Llama(self.cfg, device=self.device)
        model.load_state_dict(state)
        del state
        v = self.engine.update_weights(model, version=version)
        self.at_push = dict(self.engine.stats(),
                            install_ms=(time.perf_counter() - t0) * 1e3,
                            tokens_read=[len(o) for o in self.outs])
        return v

    def push_stats(self):
        return self.at_push

    def cancel(self, ids):
        for i in ids:
            self.streams[i].cancel()
        return True

    def finish(self, ids):
        """Drain each stream of `ids`: (tokens, finish reasons)."""
        for i in ids:
            self.outs[i].extend(self.streams[i])
        return ([self.outs[i] for i in ids],
                [self.streams[i].finish_reason for i in ids])

    def stats(self):
        return self.engine.stats()


def rl_push_run(torch, llama, cfg, dev, prompts, new_prompts, old_budget,
                new_budget, take=RL_PUSH_TAKE, seeds=RL_PUSH_SEEDS,
                store_bytes=RL_PUSH_STORE_BYTES):
    """The RLHF push: an `InferenceEngine` in an actor (a `num_gpus=1`
    worker on "cuda") serves `prompts` from weights A (`seeds[0]`); once
    each stream has given `take` tokens, `push_weights` sends weights B
    (`seeds[1]`, built here) through the object store; `new_prompts`
    are admitted after it; when they end, the old streams are cancelled.
    Returns (A, B, old tokens, new tokens, record); the caller holds the
    tokens to A's and B's logits."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import push_weights

    on_card = dev.type == "cuda"
    rt.init(num_cpus=2, num_gpus=1 if on_card else 0,
            _system_config={"object_store_memory": store_bytes})
    try:
        host_cls = rt.remote(num_gpus=1 if on_card else 0,
                             num_cpus=0 if on_card else 1)(EngineHost)
        ec = dict(slots=len(prompts) + len(new_prompts),
                  max_len=max(len(p) for p in prompts + new_prompts)
                  + max(old_budget, new_budget),
                  prefill_chunk=min(256, cfg.max_seq_len),
                  prefix_cache=False)
        ec["max_len"] = -(-ec["max_len"] // ec["prefill_chunk"]) * ec[
            "prefill_chunk"]
        t0 = time.perf_counter()
        host = host_cls.remote(cfg, seeds[0], ec, dev.type)
        a = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seeds[0]), device=dev)
        assert rt.get(host.digest.remote(), timeout=600) == weights_digest(
            torch, a.state_dict()), "the actor's weights A differ"
        start_s = time.perf_counter() - t0
        old = rt.get(host.submit.remote(prompts, old_budget), timeout=60)
        rt.get(host.take.remote(old, take), timeout=600)
        b = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seeds[1]), device=dev)
        state = b.state_dict()
        push_bytes = sum(t.numel() * t.element_size() for t in state.values())
        push_ms = push_weights(state, 1, engines=[host], timeout=600)
        del state
        at_push = rt.get(host.push_stats.remote(), timeout=60)
        new = rt.get(host.submit.remote(new_prompts, new_budget), timeout=60)
        outs_new, reasons_new = rt.get(host.finish.remote(new), timeout=600)
        rt.get(host.cancel.remote(old), timeout=60)
        outs_old, reasons_old = rt.get(host.finish.remote(old), timeout=600)
        stats = rt.get(host.stats.remote(), timeout=60)
        rt.kill(host)
    finally:
        rt.shutdown()
    record = {"push_bytes": push_bytes, "push_ms": push_ms,
              "install_ms": at_push["install_ms"],
              "object_store_memory": store_bytes, "actor_start_s": start_s,
              "engine": ec,
              "at_push": {k: at_push[k] for k in (
                  "weight_gens", "weight_version", "requests_done",
                  "slots_used", "tokens_read")},
              "old_tokens": [len(o) for o in outs_old],
              "new_tokens": [len(o) for o in outs_new],
              "old_finish": reasons_old, "new_finish": reasons_new,
              "weight_gens_after": stats["weight_gens"],
              "weight_version_after": stats["weight_version"]}
    # The push landed mid-decode: every old stream was running, pinning
    # generation A beside B, when B was installed; none had ended.
    assert at_push["weight_gens"] == 2, at_push
    assert at_push["requests_done"] == 0, at_push
    assert at_push["slots_used"] == len(prompts), at_push
    assert reasons_new == ["length"] * len(new_prompts), reasons_new
    assert all(len(o) == new_budget for o in outs_new)
    assert all(r in ("cancelled", "length") for r in reasons_old)
    assert all(len(o) > take for o in outs_old), record["old_tokens"]
    assert stats["weight_gens"] == 1 and stats["weight_version"] == 1, stats
    return a, b, outs_old, outs_new, record


def rl_push_phase(torch, llama, dev, delta):
    """(i4): `rl_push_run` at the Llama-2-7B width (RL_PUSH_LAYERS
    layers, bf16); each old stream's tokens held to A's teacher-forced
    logits, each new one's to B's, within `delta` of their row's maximum
    ((e3)'s greedy-consistency delta); the new streams held to A's must
    fail."""
    cfg = llama.LlamaConfig.llama2_7b(n_layers=RL_PUSH_LAYERS, remat=False)
    g = torch.Generator(device=dev).manual_seed(RL_SEED + 3)

    def prompt():
        return torch.randint(0, cfg.vocab_size, (RL_PUSH_PROMPT,), generator=g,
                             device=dev).tolist()

    prompts = [prompt() for _ in range(RL_PUSH_STREAMS)]
    new_prompts = [prompt() for _ in range(RL_PUSH_STREAMS)]
    t0 = time.perf_counter()
    a, b, outs_old, outs_new, record = rl_push_run(
        torch, llama, cfg, dev, prompts, new_prompts, RL_PUSH_OLD_BUDGET,
        RL_PUSH_NEW)
    record["wall_s"] = time.perf_counter() - t0

    def teacher(model):
        def forced(seq):
            with torch.no_grad():
                return llama.forward(model, seq)
        return forced

    record["old_on_a"] = greedy_consistency(
        torch, teacher(a), prompts, outs_old, delta, dev, "(i4) old on A")
    record["new_on_b"] = greedy_consistency(
        torch, teacher(b), new_prompts, outs_new, delta, dev, "(i4) new on B")
    control = greedy_counts(torch, teacher(a), new_prompts, outs_new, delta,
                            dev)
    record["control_new_on_a"] = control
    print(f"(i4) push of {record['push_bytes']} B (weights B) in "
          f"{record['push_ms']:.1f} ms through an object store of "
          f"{record['object_store_memory']} B (install in the actor "
          f"{record['install_ms']:.1f} ms); at the push the old streams had "
          f"read {record['at_push']['tokens_read'][:RL_PUSH_STREAMS]} tokens, "
          f"weight_gens {record['at_push']['weight_gens']}; old streams "
          f"{record['old_tokens']} tokens, new {record['new_tokens']}; "
          f"control, the new streams on A: {control['consistent']} of "
          f"{control['tokens']} within delta (must not be all); weight_gens "
          f"after {record['weight_gens_after']}")
    assert control["consistent"] < control["tokens"], control
    record.update(config=f"llama2_7b width, {cfg.n_layers} layers, bf16, "
                         "random init", delta=delta, streams=RL_PUSH_STREAMS,
                  prompt_tokens=RL_PUSH_PROMPT)
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    return record


def rl_decode_delta(torch, llama, dev):
    """`--only-rl`'s stand-in for (e3)'s delta, measured as (e2) measures
    it, on (i4)'s model (weights A): 3 x the max abs error of the paged
    path's logits (`paged_prefill` in 256-token chunks and 16
    `paged_decode_step`s, 2 x 1024 tokens) against the teacher-forced
    bf16 `llama.forward`."""
    cfg = llama.LlamaConfig.llama2_7b(n_layers=RL_PUSH_LAYERS, remat=False)
    g = torch.Generator(device=dev).manual_seed(RL_PUSH_SEEDS[0])
    model = llama.init_params(cfg, g, device=dev)
    b, t, steps, chunk, bl = 2, 1024, 16, 256, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev)
    nb = (t + steps) // bl
    tables = (torch.arange(b * nb, device=dev) + 1).view(b, nb)
    got, seq = paged_run(torch, model, cfg, tokens, steps, chunk, tables, bl,
                         dev)
    with torch.no_grad():
        teacher = llama.forward(model, seq)[:, t - 1:]
    err = rel_errors(got, teacher)[0]
    del model, got, seq, teacher
    torch.cuda.empty_cache()
    print(f"(i4) delta for --only-rl: 3 x {err:.4g} (paged logits against "
          "the teacher-forced bf16 forward)")
    return 3.0 * err


def rl_phase(torch, llama, card, dev, delta):
    """Phase (i), the RL slice: (i1)-(i4) (see the module's doc). Returns
    the `{"rl": ...}` record."""
    import ray_tpu_torch as rt

    from ray_tpu_torch._private import compile_watch

    record = {"card": card}
    t0 = time.perf_counter()
    record["i1"] = rl_learners(torch, dev)
    rt.init(num_cpus=6, num_gpus=1 if dev.type == "cuda" else 0)
    try:
        compile_watch.reset()  # (j2)'s windows: (i2), then (i3)
        record["i2"] = rl_sync_ppo(dev)
        compile_watch.reset()
        record["i3"] = rl_engine_ppo(rt, dev)
    finally:
        rt.shutdown()
    record["i4"] = rl_push_phase(torch, llama, dev, delta)
    record["wall_s"] = time.perf_counter() - t0
    return record


# ---- (j) the compile watch on the card ------------------------------

#: (j4)'s bar: the watch's hot path (digest + seen-set lookup) at most
#: this share of the program's step, on the program's real arguments.
WATCH_SHARE = 0.01
#: (j3)'s loop: prefill lengths drifting by WATCH_DRIFT_STEP from
#: WATCH_DRIFT_FROM, one more than the storm threshold's 8 and then some.
WATCH_DRIFT_FROM, WATCH_DRIFT_STEP, WATCH_DRIFT_CALLS = 16, 8, 12
#: Calls timed per round of `hot_path_us` (best of 3 rounds).
WATCH_REPS = 2000


def watch_counts(prefixes=None):
    """{program: [compiles, distinct_shapes]} of this process's compile
    watch, for the programs whose names start with one of `prefixes`."""
    from ray_tpu_torch._private import compile_watch as cw

    return {name: [row["compiles"], row["distinct_shapes"]]
            for name, row in sorted(cw.snapshot().items())
            if prefixes is None or name.startswith(tuple(prefixes))}


def one_record_per_signature(label, counts):
    """Each program of `counts` recorded each signature once."""
    assert counts, label
    for name, (compiles, distinct) in counts.items():
        assert compiles == distinct, (label, name, compiles, distinct)


def hot_path_us(args, kwargs=None):
    """The compile watch's cost per call on a hit, on these arguments:
    an instrumented no-op's time less the no-op's own, best of 3 rounds
    of WATCH_REPS calls (host clock: the hot path is host work)."""
    from ray_tpu_torch._private import compile_watch as cw

    kwargs = kwargs or {}

    def noop(*a, **k):
        return None

    watched = cw.instrument("chip_smoke.hot_path", noop)
    watched(*args, **kwargs)  # the one miss
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(WATCH_REPS):
            watched(*args, **kwargs)
        t1 = time.perf_counter()
        for _ in range(WATCH_REPS):
            noop(*args, **kwargs)
        t2 = time.perf_counter()
        best = min(best, ((t1 - t0) - (t2 - t1)) / WATCH_REPS)
    return best * 1e6


def watch_forced_build(torch, _build):
    """(j1): flash_fwd built anew (a fresh build directory, the loaded
    library set aside) inside an instrumented call: exactly one
    `kernel.flash_fwd` record with nvcc's wall time, and the call's
    program billed the build's time as compile_ms."""
    import shutil
    import tempfile
    from pathlib import Path

    from ray_tpu_torch._private import compile_watch as cw
    from ray_tpu_torch._private import step_telemetry

    cw.reset()
    step_telemetry.take_phases()
    load = cw.instrument("chip_smoke.load_flash_fwd",
                         lambda: _build.load("flash_fwd"))
    saved_dir, saved_lib = _build.BUILD_DIR, _build._libs.pop("flash_fwd")
    saved_dir.parent.mkdir(parents=True, exist_ok=True)
    fresh = tempfile.mkdtemp(prefix="compile_watch_", dir=saved_dir.parent)
    try:
        _build.BUILD_DIR = Path(fresh)
        t0 = time.perf_counter()
        load()
        wall_ms = (time.perf_counter() - t0) * 1e3
        built = _build.library_path("flash_fwd").exists()
    finally:
        _build.BUILD_DIR = saved_dir
        _build._libs["flash_fwd"] = saved_lib
        shutil.rmtree(fresh, ignore_errors=True)
    phases = step_telemetry.take_phases()
    snap = cw.snapshot()
    kernel = snap["kernel.flash_fwd"]
    program = snap["chip_smoke.load_flash_fwd"]
    record = {"kernel_records": kernel["compiles"],
              "nvcc_ms": kernel["total_ms"],
              "program_compiles": program["compiles"],
              "program_compile_ms": program["total_ms"],
              "billed_compile_ms": phases.get("compile_ms", 0.0),
              "call_ms": wall_ms}
    print(f"(j1) flash_fwd built anew inside an instrumented call: "
          f"{kernel['compiles']} kernel.flash_fwd record(s), nvcc "
          f"{kernel['total_ms']:.1f} ms; the program billed "
          f"{record['billed_compile_ms']:.1f} ms of compile_ms (its record "
          f"{program['total_ms']:.1f} ms; the call {wall_ms:.1f} ms)")
    assert built
    assert kernel["compiles"] == 1 and kernel["distinct_shapes"] == 0, kernel
    assert program["compiles"] == 1, program
    assert set(snap) == {"kernel.flash_fwd", "chip_smoke.load_flash_fwd"}
    # The build's wall time: nvcc's own plus the poll and the rename.
    assert kernel["total_ms"] > 0.0
    assert 0.0 <= program["total_ms"] - kernel["total_ms"] < 100.0, record
    # Billed once, by the program's record (the snapshot rounds to µs).
    assert abs(record["billed_compile_ms"] - program["total_ms"]) < 1e-2, \
        record
    assert program["total_ms"] <= wall_ms, record
    return record


def watch_storm(torch, llama, dev):
    """(j3): a loop whose sequence length drifts through
    `generate.prefill` at (e1)'s width is a storm `detect_storms`
    names, with the drifting dimension; a shape-stable loop is not."""
    from ray_tpu_torch._private import compile_watch as cw
    from ray_tpu_torch.models import generate as gen

    small = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                              n_heads=4, n_kv_heads=2, intermediate=512,
                              max_seq_len=256, dtype=torch.float32,
                              remat=False)
    g = torch.Generator(device=dev).manual_seed(5)
    model = llama.init_params(small, g, device=dev)
    lengths = [WATCH_DRIFT_FROM + i * WATCH_DRIFT_STEP
               for i in range(WATCH_DRIFT_CALLS)]
    tokens = torch.randint(0, small.vocab_size, (1, max(lengths)),
                           generator=g, device=dev)

    def loop(lens):
        cw.reset()
        with torch.no_grad():
            for t in lens:
                gen.prefill(model, small, tokens[:, :t],
                            gen.init_kv_cache(small, 1, 256, device=dev),
                            0, t)
        torch.cuda.synchronize()
        return cw.detect_storms(cw.snapshot())

    storms = loop(lengths)
    stable = loop([lengths[4]] * WATCH_DRIFT_CALLS)
    cw.load_inventory(refresh=True)
    hint = cw.static_hint("generate.prefill")
    record = {"storms": [{k: s[k] for k in ("program", "compiles",
                                            "distinct_shapes", "delta")}
                         for s in storms],
              "stable_storms": len(stable), "hint": hint}
    print(f"(j3) prefill lengths {lengths[0]}..{lengths[-1]}: storms "
          f"{record['storms']}; the same {WATCH_DRIFT_CALLS} calls at one "
          f"length: {len(stable)} storm(s); static hint: {hint}")
    assert [s["program"] for s in storms] == ["generate.prefill"], storms
    assert storms[0]["distinct_shapes"] == WATCH_DRIFT_CALLS, storms
    assert "dim 1 drifting" in storms[0]["delta"], storms
    assert stable == [], stable
    assert hint and "ray_tpu_torch/models/generate.py:" in hint, hint
    del model
    torch.cuda.empty_cache()
    return record


def watch_phase(torch, llama, _build, card, dev, windows):
    """Phase (j), the compile watch on the card: (j1) and (j3) run here;
    (j2)'s counts and (j4)'s hot-path costs were taken in (c), (e3),
    (g4) and (i) (`windows`), and are held here. Returns the
    `{"compile_watch": ...}` record."""
    t0 = time.perf_counter()
    record = {"card": card, "windows": windows}
    # (j2): one record per signature, and no signature past warm-up.
    c = windows["c"]
    assert c["after_step_1"] == c["after_last_step"] == {
        "train.step": [1, 1]}, c
    e3 = windows["e3"]
    for key in ("prefill", "decode"):
        assert e3["engine_compiles"][key] == {
            "compiles": 1, "distinct_shapes": 1}, e3
    one_record_per_signature("(e3)", e3["counts"])
    if "g4" in windows:
        for label, stages in windows["g4"].items():
            for stage in stages:
                for key, row in stage.items():
                    assert row["compiles"] == row["distinct_shapes"] == \
                        row["signatures"], (label, key, row)
    for label in ("i2", "i3"):
        one_record_per_signature(f"({label})", windows[label]["counts"])
    policy = windows["i3"]["engine_compiles"]["policy"]
    assert policy["compiles"] == policy["distinct_shapes"] >= 1, policy
    print("(j2) compile counts [compiles, distinct shapes]: (c) "
          f"{c['after_last_step']}; (e3) {e3['counts']}, the engine's "
          f"stats()['compiles'] {e3['engine_compiles']}; (i2) "
          f"{windows['i2']['counts']}; (i3) {windows['i3']['counts']}, "
          f"the policy engine's {windows['i3']['engine_compiles']}"
          + (f"; (g4) by stage {windows['g4']}" if "g4" in windows else ""))
    # (j4): the hot path against each program's step.
    shares = {}
    for label, key in (("c", "train.step"), ("e3", "engine.paged_decode_step"),
                       ("i2", "rl.ppo.minibatch_update")):
        w = windows[label]
        shares[key] = w["hot_path_us"] / (w["step_ms"] * 1e3)
        print(f"(j4) {key}: hot path {w['hot_path_us']:.2f} us a call "
              f"against its step of {w['step_ms']:.3f} ms: share "
              f"{shares[key]:.2e} (bar {WATCH_SHARE})")
    record["hot_path_share"] = shares
    record["j1"] = watch_forced_build(torch, _build)
    record["j3"] = watch_storm(torch, llama, dev)
    for key, share in shares.items():
        assert share < WATCH_SHARE, (key, share)
    record["wall_s"] = time.perf_counter() - t0
    return record


def data_loop(config):
    """Phase (k)'s train loop, run by `TorchTrainer` in the driver
    ((k1)), in each (k2) trial's actor and on each rank of (k3)'s gang:
    (c)'s model at `config["n_layers"]` from MPMD_SEED (phase (c)'s),
    the mesh step over `MeshSpec(fsdp=config["fsdp"])`, fed by
    `get_device_batches` for at most `config["steps"]` steps. Each step
    reports its loss, the first step's loss, its own time, the batch's
    row ids (this rank's), whether every batch tensor was on the card,
    the card's name and the process. With `config["hold"]` ((l1)) the
    rank waits after its first step until the profiler starts."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import (
        default_optimizer,
        get_context,
        get_device_batches,
        init_torch_distributed,
        make_train_step,
        report,
    )
    from ray_tpu_torch.train.backend import free_port

    dev = torch.device(config.get("device", "cuda"))
    cuda = dev.type == "cuda"
    # (k1) and (k2) make a world of one rank; (k3)'s gang has its group.
    own_group = not dist.is_initialized()
    if own_group:
        init_torch_distributed(0, 1, f"localhost:{free_port()}", device=dev)
    batches = None
    try:
        cfg = llama.LlamaConfig.llama2_7b(n_layers=config["n_layers"],
                                          max_seq_len=SEQ)
        if "width" in config:  # a CPU rehearsal's small width
            cfg = dataclasses.replace(cfg, **config["width"])
        model = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(MPMD_SEED),
            device=dev)
        mesh = MeshSpec(fsdp=config["fsdp"]).build(dev)
        init_fn, step_fn = make_train_step(
            llama.loss_fn, default_optimizer(learning_rate=config["lr"],
                                             total_steps=config["steps"]),
            mesh, llama.param_annotations(cfg))
        state = init_fn(model)
        del model
        batches = get_device_batches("train", mesh=mesh, batch_size=BATCH,
                                     prefetch_batches=2, buffer_size=2)
        first = None
        for _, batch in zip(range(config["steps"]), batches):
            on_card = all(
                x.device_mesh.device_type == dev.type
                and x.to_local().device.type == dev.type
                for x in batch.values())
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch["tokens"], batch["targets"])
            if cuda:
                torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            loss = metrics["loss"].item()
            first = loss if first is None else first
            report({"loss": loss, "first_loss": first, "step_ms": step_ms,
                    "rows": batch["row"].to_local().tolist(),
                    "on_card": on_card,
                    "device": torch.cuda.get_device_name() if cuda else "cpu",
                    "pid": os.getpid(), "rank": get_context().world_rank})
            if "hold" in config and loss == first:
                hold_for_profiler(config["hold"])
        del state, step_fn, init_fn
    finally:
        if batches is not None:
            batches.close()
        if own_group:
            dist.destroy_process_group()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()


def hold_for_profiler(directory):
    """(l1): after the first step, send its record to the head, leave
    `ready` in `directory` and wait for `go`: the gang profiler, started
    once the head knows this rank, opens its window on the steps that
    follow."""
    from ray_tpu_torch.util import metrics

    metrics.flush()
    open(os.path.join(directory, "ready"), "w").close()
    deadline = time.time() + CLUSTER_TIMEOUT_S
    while not os.path.exists(os.path.join(directory, "go")):
        assert time.time() < deadline, "the profiler never started"
        time.sleep(0.01)


def data_rows(torch, dev):
    """(k)'s DATA_ROWS rows of SEQ + 1 int32 tokens below DATA_VOCAB,
    drawn from MPMD_SEED (phase (c)'s) on `dev`, as numpy."""
    g = torch.Generator(device=dev).manual_seed(MPMD_SEED)
    return torch.randint(0, DATA_VOCAB, (DATA_ROWS, SEQ + 1), generator=g,
                         device=dev).to(torch.int32).cpu().numpy()


def token_dataset(rows, directory, shuffle):
    """`rows` written as DATA_FILES .npy shards into `directory` and read
    back by `ray_tpu_torch.data.read_numpy`; a `map_batches` splits each
    row into int64 `tokens` and `targets` of SEQ and adds its `row` id
    (found by its first 8 tokens); with `shuffle`, a seeded
    `random_shuffle`."""
    import numpy as np

    from ray_tpu_torch import data

    per_file = len(rows) // DATA_FILES
    for i in range(DATA_FILES):
        np.save(os.path.join(directory, f"part-{i:02d}.npy"),
                rows[i * per_file:(i + 1) * per_file])
    row_of = {row[:8].tobytes(): i for i, row in enumerate(rows)}
    assert len(row_of) == len(rows)

    def split_rows(batch):
        t = batch["tokens"]
        return {"tokens": t[:, :-1].astype(np.int64),
                "targets": t[:, 1:].astype(np.int64),
                "row": np.array([row_of[r[:8].tobytes()] for r in t])}

    ds = data.read_numpy(directory, column="tokens").map_batches(split_rows)
    return ds.random_shuffle(seed=DATA_SHUFFLE_SEED) if shuffle else ds


def rows_seen(histories):
    """Row ids in the order the steps of each history read them."""
    return [[r for m in h for r in m["rows"]] for h in histories]


def data_train_run(torch, llama, attn, rows, ds, n_layers, dev):
    """(k1): `TorchTrainer(datasets=...)` in the driver over `ds`, every
    row once (see the module's doc); then a direct `make_train_step` on
    the same weights and the fit's first batch. Returns the record."""
    from ray_tpu_torch.train import (
        ScalingConfig,
        TorchTrainer,
        default_optimizer,
        make_train_step,
        telemetry,
    )

    steps = DATA_ROWS // BATCH
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    result = TorchTrainer(
        data_loop,
        train_loop_config={"n_layers": n_layers, "lr": 3e-4, "steps": steps,
                           "fsdp": 1, "device": dev.type},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        datasets={"train": ds},
    ).fit()
    fit_s = time.perf_counter() - t0
    launches = dict(attn.LAUNCHES)
    assert result.error is None, result.error
    hist = result.metrics_history
    # The loop's steps, as step telemetry recorded them.
    records = sorted((r for r in telemetry.step_records()
                      if r.get("pid") == os.getpid()),
                     key=lambda r: r["step"])[-steps:]
    losses = [m["loss"] for m in hist]
    (seen,) = rows_seen([hist])
    # The direct step: the same weights, the fit's first batch.
    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
    model = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(MPMD_SEED), device=dev)
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=3e-4,
                                         total_steps=steps), device=dev)
    first = torch.from_numpy(rows[hist[0]["rows"]]).long().to(dev)
    direct = step_fn(init_fn(model), first[:, :-1], first[:, 1:])[1][
        "loss"].item()
    del model, init_fn, step_fn, first
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = [m["step_ms"] for m in hist]
    data_wait = [r.get("data_wait_ms", 0.0) for r in records]
    h2d = [r.get("h2d_ms", 0.0) for r in records]
    return {
        "steps": len(hist), "losses": losses, "step_ms": step_ms,
        "steady_step_ms": statistics.median(step_ms[1:]),
        "data_wait_ms": data_wait, "h2d_ms": h2d,
        "median_data_wait_ms": statistics.median(data_wait[1:]),
        "median_h2d_ms": statistics.median(h2d[1:]),
        "telemetry_steps": [r["step"] for r in records],
        "rows_seen": len(seen), "distinct_rows": len(set(seen)),
        "row_sum": sum(seen), "on_card": all(m["on_card"] for m in hist),
        "direct_step1_loss": direct,
        "loss_rel_to_direct": rel(losses[0], direct),
        "launches": launches, "fit_s": fit_s,
    }


def data_tune_run(ds, dev):
    """(k2): a `Tuner` over `TorchTrainer` trials of `data_loop` at
    TUNE_LAYERS layers and TUNE_STEPS steps on (k1)'s dataset, one trial
    a card; then one trial that asks for no card (see the module's
    doc). Returns the record."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    trainer = TorchTrainer(
        data_loop,
        train_loop_config={"n_layers": TUNE_LAYERS, "lr": 3e-4,
                           "steps": TUNE_STEPS, "fsdp": 1,
                           "device": dev.type},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        datasets={"train": ds})
    t0 = time.perf_counter()
    grid = tune.Tuner(
        trainer, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", resources_per_trial={"num_gpus": 1},
            max_concurrent_trials=1)).fit()
    tune_s = time.perf_counter() - t0
    trials = [{"lr": r.config["lr"], "error": r.error,
               **{k: r.metrics.get(k) for k in (
                   "loss", "first_loss", "device", "pid",
                   "training_iteration")}} for r in grid]
    best = grid.get_best_result("loss", "min") if not grid.errors else None
    t0 = time.perf_counter()
    cardless = tune.Tuner(
        trainer, tune_config=tune.TuneConfig(
            metric="loss", mode="min",
            resources_per_trial={"num_cpus": 1})).fit()
    cardless_s = time.perf_counter() - t0
    return {"trials": trials, "errors": len(grid.errors),
            "best_lr": best.config["lr"] if best else None,
            "tune_s": tune_s,
            "cardless_trials": len(cardless),
            "cardless_errors": [r.error for r in cardless.errors],
            "cardless_s": cardless_s}


def data_phase(torch, llama, attn, card, n_layers, dev, f2_step_ms=None):
    """Phase (k), (k1) and (k2) on one card (see the module's doc).
    Returns the `{"data": ...}` record."""
    import tempfile

    import ray_tpu_torch as rt

    rows = data_rows(torch, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        ds = token_dataset(rows, tmp, shuffle=True)
        rt.init(num_cpus=4, num_gpus=1)
        try:
            t0 = time.perf_counter()
            k1 = data_train_run(torch, llama, attn, rows, ds, n_layers, dev)
            print(f"(k1): {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            k2 = data_tune_run(ds, dev)
            print(f"(k2): {time.perf_counter() - t0:.1f} s")
        finally:
            rt.shutdown()
    losses = k1["losses"]
    print(f"(k1) TorchTrainer(datasets=...) -> get_device_batches -> "
          f"MeshSpec(fsdp=1) step, {n_layers} layers, {k1['steps']} steps "
          f"of {BATCH} x {SEQ}: losses {[round(x, 4) for x in losses]}, "
          f"step 1 {losses[0]:.6f} against the direct step's "
          f"{k1['direct_step1_loss']:.6f} (relative "
          f"{k1['loss_rel_to_direct']:.2e}), rows seen {k1['rows_seen']} "
          f"({k1['distinct_rows']} distinct, sum {k1['row_sum']}), batches "
          f"on the card: {k1['on_card']}, launches {k1['launches']}, fit "
          f"{k1['fit_s']:.1f} s")
    print(f"(k1) median step {k1['steady_step_ms']:.2f} ms; per step "
          f"data_wait_ms {[round(x, 3) for x in k1['data_wait_ms']]} "
          f"(median {k1['median_data_wait_ms']:.3f}), h2d_ms "
          f"{[round(x, 3) for x in k1['h2d_ms']]} (median "
          f"{k1['median_h2d_ms']:.3f}); (f2)'s median step "
          + (f"{f2_step_ms:.2f} ms" if f2_step_ms is not None
             else "not run in this call") + f"; card: {card}")
    print(f"(k2) Tuner over TorchTrainer, lr {list(TUNE_LRS)}: trials "
          f"{k2['trials']}, best lr {k2['best_lr']}, {k2['tune_s']:.1f} s; "
          f"the trial that asked for no card: {k2['cardless_errors']} "
          f"({k2['cardless_s']:.1f} s)")
    steps = DATA_ROWS // BATCH
    assert k1["steps"] == steps and len(k1["telemetry_steps"]) == steps, k1
    assert k1["on_card"], k1
    assert k1["rows_seen"] == DATA_ROWS == k1["distinct_rows"], k1
    assert k1["row_sum"] == DATA_ROWS * (DATA_ROWS - 1) // 2, k1
    assert all(math.isfinite(x) for x in losses), losses
    assert statistics.mean(losses[-4:]) < statistics.mean(losses[:4]), losses
    assert k1["loss_rel_to_direct"] <= MESH_LOSS_REL, k1
    if dev.type == "cuda":
        assert k1["launches"]["flash_fwd"] == steps * n_layers * 2, k1
        for name in BWD_LAUNCHES:
            assert k1["launches"][name] == steps * n_layers, k1
    trials = k2["trials"]
    assert len(trials) == len(TUNE_LRS) and k2["errors"] == 0, k2
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    assert all(t["device"] == name and t["pid"] not in (None, os.getpid())
               for t in trials), k2
    first = [t["first_loss"] for t in trials]
    assert max(first) - min(first) <= MESH_LOSS_REL * min(first), first
    assert k2["best_lr"] == min(trials, key=lambda t: t["loss"])["lr"], k2
    assert k2["cardless_trials"] == 1 and len(k2["cardless_errors"]) == 1, k2
    assert "no CUDA device is visible" in k2["cardless_errors"][0], k2
    return {"card": card,
            "config": f"llama2_7b width, {n_layers} layers, bf16, flash, "
                      f"remat full, MeshSpec(fsdp=1); {DATA_ROWS} rows in "
                      f"{DATA_FILES} .npy files, batch {BATCH} x {SEQ}",
            "k1": k1, "f2_steady_step_ms": f2_step_ms, "k2": k2,
            "bars": {"mesh_loss_rel": MESH_LOSS_REL}}


def cards4_data_run(torch, card, n_layers, timeout=420.0, dev=None):
    """(k3), `--cards 4`: `TorchTrainer(num_workers=4, datasets=...)` on a
    gang of the runtime's `num_gpus=1` actors (NCCL) at fsdp 4, each rank
    reading its `get_device_batches` shard of (k1)'s rows (unshuffled, one
    file a rank): every rank reads as many rows, and their union is every
    row once. A fit still running after `timeout` seconds fails."""
    import tempfile
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    dev = dev or torch.device("cuda")
    rows = data_rows(torch, dev)
    steps = DATA_ROWS // (4 * BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        ds = token_dataset(rows, tmp, shuffle=False)
        rt.init(num_cpus=8, num_gpus=4)
        try:
            box = {}
            trainer = TorchTrainer(
                data_loop,
                train_loop_config={"n_layers": n_layers, "lr": 3e-4,
                                   "steps": steps, "fsdp": 4,
                                   "device": dev.type},
                scaling_config=ScalingConfig(
                    num_workers=4, use_gpu=dev.type == "cuda"),
                datasets={"train": ds})
            fit = threading.Thread(
                target=lambda: box.update(r=trainer.fit()), daemon=True)
            t0 = time.perf_counter()
            fit.start()
            fit.join(timeout)
            if fit.is_alive():
                raise TimeoutError(f"(k3) still running after {timeout} s")
            result = box["r"]
            fit_s = time.perf_counter() - t0
        finally:
            rt.shutdown()
    assert result.error is None, result.error
    histories = result.metrics_by_rank
    seen = rows_seen(histories)
    losses = [[m["loss"] for m in h] for h in histories]
    union = [r for s in seen for r in s]
    step_ms = [m["step_ms"] for m in histories[0]]
    print(f"(k3) TorchTrainer(num_workers=4, datasets=...) at fsdp 4: rows "
          f"per rank {[len(s) for s in seen]}, union {len(set(union))} of "
          f"{DATA_ROWS} ({len(union)} read), losses (rank 0) "
          f"{[round(x, 4) for x in losses[0]]}, step ms "
          f"{[round(x, 2) for x in step_ms]}, fit {fit_s:.1f} s; card: {card}")
    assert len(histories) == 4 and all(len(h) == steps for h in histories)
    assert all(len(s) == DATA_ROWS // 4 for s in seen), seen
    assert sorted(union) == list(range(DATA_ROWS)), seen
    assert all(m["on_card"] for h in histories for m in h)
    assert all(math.isfinite(x) for x in losses[0]), losses
    assert all(h == losses[0] for h in losses), losses
    return {"rows_per_rank": [len(s) for s in seen],
            "union": len(set(union)), "losses": losses[0],
            "step_ms": step_ms,
            "steady_step_ms": statistics.median(step_ms[1:]),
            "fit_s": fit_s}


def cluster_cli(info, *argv, timeout=120.0):
    """`python -m ray_tpu_torch --cluster-info INFO *argv` from this
    checkout: the CompletedProcess, its output as text."""
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "--cluster-info", info,
         *argv],
        env=cluster_env(), capture_output=True, text=True, timeout=timeout)


def cluster_env():
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    env.pop("RT_ADDRESS", None)
    return env


def descendants(pid):
    """The live processes below `pid`, read from /proc."""
    children = collections.defaultdict(list)
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if stat[0] != "Z":
            children[int(stat[1])].append(int(entry))
    found, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), ()):
            found.append(child)
            todo.append(child)
    return found


def flash_inputs(torch, seed, dev, shape):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(*shape, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(3)]


class ClusterFit:
    """(l1)'s trainer actor (`num_gpus=1`), which the submitted job
    starts: (k1)'s `TorchTrainer(datasets=...)` run in a runtime worker,
    whose steps the gang profiler reaches (a driver process has no
    profile endpoint)."""

    def fit(self, config, ds):
        import torch

        from ray_tpu_torch.ops import attention as attn
        from ray_tpu_torch.train import ScalingConfig, TorchTrainer

        attn.reset_launch_counts()
        t0 = time.perf_counter()
        result = TorchTrainer(
            data_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            datasets={"train": ds}).fit()
        if result.error is not None:
            raise result.error
        hist = result.metrics_history
        return {"losses": [m["loss"] for m in hist],
                "step_ms": [m["step_ms"] for m in hist],
                "rows": rows_seen([hist])[0],
                "on_card": all(m["on_card"] for m in hist),
                "device": hist[-1]["device"], "pid": os.getpid(),
                "launches": dict(attn.LAUNCHES),
                "fit_s": time.perf_counter() - t0,
                "cuda": torch.cuda.is_available()}


def cluster_job(config):
    """(l1)'s entrypoint, run by `python -m ray_tpu_torch submit`: it
    must see the card itself (the job manager gives it the host's
    CUDA_VISIBLE_DEVICES), draws (k1)'s rows on it, connects through
    RT_ADDRESS and fits (k1)'s run in a `ClusterFit` actor. Prints
    `JOB {...}` and returns the exit code."""
    import tempfile

    import torch

    import ray_tpu_torch as rt

    dev = torch.device(config["device"])
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"JOB-FAILED the job sees no card "
              f"(CUDA_VISIBLE_DEVICES={visible!r})", flush=True)
        return 1
    rt.init()
    try:
        rows = data_rows(torch, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_job_") as tmp:
            ds = token_dataset(rows, tmp, shuffle=True)
            fitter = rt.remote(num_gpus=1)(ClusterFit).remote()
            out = rt.get(fitter.fit.remote(config, ds),
                         timeout=CLUSTER_TIMEOUT_S)
            # The actor stays until the profiler, whose window may reach
            # past the last step, is done with it.
            deadline = time.time() + CLUSTER_TIMEOUT_S
            while not os.path.exists(os.path.join(config["hold"],
                                                  "profiled")):
                assert time.time() < deadline, "the profiler never ended"
                time.sleep(0.1)
            rt.kill(fitter)
        out["job_visible_devices"] = visible
        out["job_device"] = (torch.cuda.get_device_name(0)
                             if dev.type == "cuda" else "cpu")
        print("JOB " + json.dumps(out), flush=True)
        return 0
    finally:
        rt.shutdown()


def http_get(url, timeout=30.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def trace_kernels(path):
    """The flash kernels (FLASH_KERNELS) that a chrome trace's events
    name, with their counts."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", []) if isinstance(events, dict) \
        else events
    counts = collections.Counter()
    for event in events:
        name = str(event.get("name", ""))
        for kernel in FLASH_KERNELS:
            if re.search(rf"\b{kernel}\b", name):
                counts[kernel] += 1
    return dict(counts)


def cluster_job_run(torch, n_layers, dev, tmp, width=None):
    """(l1): a head started by the CLI with the card, (k1)'s run
    submitted as a job, its gang profiled, the dashboard read, and the
    head stopped. Returns the record."""
    info = os.path.join(tmp, "cluster.json")
    free_before = torch.cuda.mem_get_info()[0] if dev.type == "cuda" else 0
    head_log = open(os.path.join(tmp, "head.log"), "w")
    t0 = time.perf_counter()
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "--cluster-info", info,
         "start", "--head", "--num-cpus", "8", "--num-gpus", "1",
         "--session-dir", os.path.join(tmp, "session")],
        env=cluster_env(), stdout=head_log, stderr=subprocess.STDOUT)
    rec = {}
    dash = None
    try:
        deadline = time.time() + 60
        while not os.path.exists(info):
            assert head.poll() is None and time.time() < deadline, (
                "the head never wrote its cluster info")
            time.sleep(0.2)
        rec["head_start_s"] = time.perf_counter() - t0
        status = cluster_cli(info, "status")
        assert status.returncode == 0, status.stdout + status.stderr
        totals = status.stdout.split("cluster totals:", 1)[1].splitlines()[0]
        rec["status_totals"] = totals.strip()
        nodes = cluster_cli(info, "state", "ls", "nodes", "--json")
        assert nodes.returncode == 0, nodes.stdout + nodes.stderr
        rec["node_gpus"] = [n["resources"].get("GPU", 0.0)
                            for n in json.loads(nodes.stdout)]
        hold = os.path.join(tmp, "hold")
        os.makedirs(hold)
        config = {"n_layers": n_layers, "lr": 3e-4,
                  "steps": DATA_ROWS // BATCH, "fsdp": 1,
                  "device": dev.type, "hold": hold}
        if width:
            config["width"] = width
        script = os.path.join(tmp, "cluster_job.py")
        with open(script, "w") as f:
            f.write("import json, sys\n"
                    f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
                    "import chip_smoke\n"
                    "sys.exit(chip_smoke.cluster_job(json.loads(sys.argv[1])))\n")
        t_submit = time.perf_counter()
        sub = cluster_cli(info, "submit", "--no-wait", "--", sys.executable,
                          script, json.dumps(config))
        assert sub.returncode == 0, sub.stdout + sub.stderr
        job_id = re.search(r"submitted (\S+)", sub.stdout).group(1)

        def job_status():
            jobs = cluster_cli(info, "jobs")
            assert jobs.returncode == 0, jobs.stdout + jobs.stderr
            return next(j["status"] for j in json.loads(jobs.stdout)
                        if j["job_id"] == job_id)

        # The gang profiler, once the head knows the job's rank: the rank
        # waits after its first step until the profiler starts.
        while not os.path.exists(os.path.join(hold, "ready")):
            assert job_status() in ("PENDING", "RUNNING"), (
                cluster_cli(info, "logs", job_id).stdout[-4000:])
            assert time.perf_counter() - t_submit < CLUSTER_TIMEOUT_S
            time.sleep(0.2)
        trace_path = os.path.join(tmp, "gang_trace.json")
        profiler = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "--cluster-info", info,
             "profile", "--duration-s", "2", "--out", trace_path],
            env=cluster_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        open(os.path.join(hold, "go"), "w").close()
        profile = profiler.communicate(timeout=120)[0]
        open(os.path.join(hold, "profiled"), "w").close()
        assert profiler.returncode == 0, profile
        device_trace = re.search(r"device trace: (\S+)", profile)
        rec["profile"] = profile.strip().splitlines()
        rec["device_trace_kernels"] = (
            trace_kernels(device_trace.group(1)) if device_trace else {})
        with open(trace_path) as f:
            rec["merged_trace_events"] = len(json.load(f))
        while (status := job_status()) in ("PENDING", "RUNNING"):
            assert time.perf_counter() - t_submit < CLUSTER_TIMEOUT_S, (
                "the job did not finish")
            time.sleep(1.0)
        rec["job_s"] = time.perf_counter() - t_submit
        rec["job_status"] = status
        logs = cluster_cli(info, "logs", job_id)
        assert logs.returncode == 0, logs.stdout + logs.stderr
        lines = [line for line in logs.stdout.splitlines()
                 if line.startswith("JOB ")]
        assert status == "SUCCEEDED" and lines, logs.stdout[-4000:]
        rec["job"] = json.loads(lines[-1][len("JOB "):])
        # The dashboard, attached to the head as a driver.
        dash = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "--cluster-info", info,
             "dashboard", "--port", "0"],
            env=cluster_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        url = None
        for line in dash.stdout:
            if "dashboard:" in line:
                url = line.split("dashboard:", 1)[1].strip()
                break
        assert url, "the dashboard never came up"
        resources = json.loads(http_get(url + "/api/resources"))
        rec["dashboard_gpu"] = {k: resources[k].get("GPU")
                                for k in ("total", "available")}
        # The job's steps: the head's step ring (/api/steps, per job)
        # and the compile series of its rank's programs (/metrics).
        steps = json.loads(http_get(url + "/api/steps"))
        rec["dashboard_steps_observed"] = steps.get("steps_observed")
        metrics = http_get(url + "/metrics")
        rec["metrics_compile_lines"] = [
            line for line in metrics.splitlines()
            if line.startswith("rt_jax_compiles_total{")]
        rec["metrics_nodes_alive"] = [
            line for line in metrics.splitlines()
            if line.startswith("rt_nodes_alive")]
        scrape = cluster_cli(info, "metrics", "scrape")
        assert scrape.returncode == 0, scrape.stdout + scrape.stderr
        rec["scrape_bytes"] = len(scrape.stdout)
    finally:
        if dash is not None:
            dash.terminate()
            try:
                dash.wait(timeout=30)
            except subprocess.TimeoutExpired:
                dash.kill()
        below = descendants(head.pid)
        stop = cluster_cli(info, "stop")
        try:
            head.wait(timeout=60)
        except subprocess.TimeoutExpired:
            head.kill()
            head.wait(timeout=30)
        head_log.close()
    deadline = time.time() + 30
    while (left := [p for p in below if os.path.exists(f"/proc/{p}")]) \
            and time.time() < deadline:
        time.sleep(0.5)
    rec["stop"] = stop.stdout.strip()
    rec["left_processes"] = left
    rec["head_rc"] = head.returncode
    if dev.type == "cuda":
        deadline = time.time() + 30
        while True:
            free_after = torch.cuda.mem_get_info()[0]
            if free_after >= free_before - CLUSTER_MEM_SLACK or \
                    time.time() > deadline:
                break
            time.sleep(0.5)
        rec["free_before"], rec["free_after"] = free_before, free_after
    return rec


def wf_step_a(n_layers, device, row_ids, runs, width=None):
    """(l2)'s step A (`num_gpus=1`): one step of (k1)'s model on the
    rows `row_ids` of (k1)'s data (its first batch), on the flash
    kernels. Appends a line to `runs` each time
    it runs; returns the loss and the gradient norm as tensors on the
    card, and its launches."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train import default_optimizer, make_train_step

    dev = torch.device(device)
    attn.reset_launch_counts()
    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
    if width:
        cfg = dataclasses.replace(cfg, **width)
    model = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(MPMD_SEED), device=dev)
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=3e-4, total_steps=1),
        device=dev)
    rows = torch.from_numpy(data_rows(torch, dev)[row_ids]).long().to(dev)
    _, metrics = step_fn(init_fn(model), rows[:, :-1], rows[:, 1:])
    launches = dict(attn.LAUNCHES)
    with open(runs, "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "launches": launches}) + "\n")
    return {"loss": metrics["loss"].detach(),
            "grad_norm": metrics["grad_norm"].detach(),
            "launches": launches}


def wf_step_b(a, marker):
    """(l2)'s step B (`num_gpus=1`): fails on its first run (it leaves
    `marker`), then returns step A's loss and gradient norm as floats,
    read on the card."""
    import torch

    if not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("step B fails on its first run")
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return {"loss": a["loss"].to(dev).item(),
            "grad_norm": a["grad_norm"].to(dev).item(),
            "a_device": str(a["loss"].device), "b_device": str(dev)}


def wf_resume(address, storage, workflow_id, step_id):
    """(l2)'s resume, run in a driver that sees no card: step A's saved
    value loads here, on the CPU, and the workflow finishes. Prints
    `RESUME {...}`."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow

    rt.init(address=address)
    try:
        saved = workflow._WorkflowStorage(
            workflow._root(storage), workflow_id).load_step(step_id)
        out = workflow.resume(workflow_id, storage=storage)
        print("RESUME " + json.dumps({
            "cuda": torch.cuda.is_available(),
            "saved_device": str(saved["loss"].device),
            "saved_loss": saved["loss"].item(),
            "saved_grad_norm": saved["grad_norm"].item(),
            "output": out,
            "status": workflow.get_status(workflow_id, storage=storage)}),
            flush=True)
    finally:
        rt.shutdown()


def cluster_workflow_run(torch, rt, n_layers, dev, tmp, row_ids,
                         width=None):
    """(l2): step A on `row_ids`, then step B, B failing; the resume in
    a driver that sees no card. Returns the record."""
    import importlib

    from ray_tpu_torch import workflow

    cs = importlib.import_module("chip_smoke")
    storage = os.path.join(tmp, "workflows")
    runs = os.path.join(tmp, "step_a_runs")
    marker = os.path.join(tmp, "step_b_failed_once")
    step_a = rt.remote(num_gpus=1)(cs.wf_step_a)
    step_b = rt.remote(num_gpus=1)(cs.wf_step_b)
    dag = step_b.bind(step_a.bind(n_layers, dev.type, row_ids, runs, width),
                      marker)
    t0 = time.perf_counter()
    try:
        workflow.run(dag, workflow_id="l2", storage=storage)
        raise AssertionError("step B did not fail on its first run")
    except RuntimeError as e:
        first_error = repr(e)[:200]
    first_s = time.perf_counter() - t0
    (step_id,) = [name[len("step-"):-len(".pkl")]
                  for name in os.listdir(os.path.join(storage, "l2"))
                  if name.startswith("step-") and "wf_step_a" in name]
    env = cluster_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
         "chip_smoke.wf_resume(*sys.argv[2:])",
         os.path.dirname(os.path.abspath(__file__)),
         rt.api._session.daemon.socket_path, storage, "l2", step_id],
        env=env, capture_output=True, text=True, timeout=CLUSTER_TIMEOUT_S)
    resume_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESUME ")]
    resumed = json.loads(line[-1][len("RESUME "):])
    with open(runs) as f:
        a_runs = [json.loads(x) for x in f if x.strip()]
    return {"first_error": first_error, "first_s": first_s,
            "resume_s": resume_s, "step_a_runs": len(a_runs),
            "step_a_launches": a_runs[0]["launches"],
            "resume_step_a_launches": sum(
                sum(r["launches"].values()) for r in a_runs[1:]),
            "step_id": step_id, **resumed}


def flash_against_plain(dev_type, seed, shape):
    """(l3)'s and (l4)'s task: the flash forward on `shape`
    (CLUSTER_FLASH_SHAPE) from `seed`, and its error against the plain
    version."""
    import torch

    from ray_tpu_torch.ops import attention as attn

    started = time.time()
    dev = torch.device(dev_type)
    attn.reset_launch_counts()
    q, k, v = flash_inputs(torch, seed, dev, shape)
    out = attn.flash_attention(q, k, v, causal=True)
    launches = dict(attn.LAUNCHES)
    ref = attn.mha_reference(q, k, v, causal=True)
    err, ref_max, rel_l2 = rel_errors(out, ref)
    return {"started": started, "pid": os.getpid(),
            "device": (torch.cuda.get_device_name(0)
                       if dev.type == "cuda" else "cpu"),
            "launches": launches, "max_abs_err": err, "ref_max": ref_max,
            "rel_l2": rel_l2, "out": out.cpu()}


def cluster_autoscale_run(dev):
    """(l3): an AutoscalingCluster whose head has no card and whose one
    node type is {"CPU": 2, "GPU": 1}, max 1; a `num_gpus=1` task makes
    it launch that node, runs there, and the node goes after idling.
    Returns the record."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import AutoscalingCluster

    cluster = AutoscalingCluster(
        head_resources={"CPU": 2.0},
        worker_node_types={"card": {"resources": {"CPU": 2.0, "GPU": 1.0},
                                    "min_workers": 0, "max_workers": 1}},
        idle_timeout_s=CLUSTER_IDLE_S)
    cluster.start()
    try:
        rt.init(address=cluster.address)
        try:
            task = rt.remote(num_gpus=1)(flash_against_plain)
            t0 = time.time()
            out = rt.get(task.remote(dev.type, 0, CLUSTER_FLASH_SHAPE),
                         timeout=CLUSTER_TIMEOUT_S)
            workers_busy = cluster.num_workers()
        finally:
            rt.shutdown()
        t_idle = time.time()
        while cluster.num_workers() and \
                time.time() - t_idle < CLUSTER_TIMEOUT_S:
            time.sleep(0.2)
        idle_s = time.time() - t_idle
        launched = cluster.provider._seq
        left = cluster.num_workers()
    finally:
        cluster.shutdown()
    out.pop("out")
    return {"demand_to_running_s": out["started"] - t0,
            "workers_while_running": workers_busy, "launched": launched,
            "workers_after_idle": left, "idle_to_terminated_s": idle_s,
            **{k: out[k] for k in ("device", "launches", "max_abs_err",
                                   "ref_max", "rel_l2")}}


class PoolForward:
    """(l4)'s actor (`num_gpus=0.5`): each call takes a seed from the
    queue and runs `flash_against_plain` on it."""

    def __init__(self, dev_type, shape):
        self.dev_type, self.shape = dev_type, shape

    def forward(self, queue):
        seed = queue.get(timeout=60)
        out = flash_against_plain(self.dev_type, seed, self.shape)
        return seed, out["pid"], out["launches"], out["out"]


def cluster_pool_run(torch, rt, dev):
    """(l4): two half-card actors map CLUSTER_POOL_CALLS flash forwards,
    half through `ActorPool.map` and half through `map_unordered`, each
    call's seed taken from a `util.Queue`; every output against the plain
    version here. Returns the record."""
    import importlib

    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.util.actor_pool import ActorPool
    from ray_tpu_torch.util.queue import Queue

    cs = importlib.import_module("chip_smoke")
    actors = [rt.remote(num_gpus=0.5)(cs.PoolForward).remote(
        dev.type, CLUSTER_FLASH_SHAPE) for _ in range(2)]
    queue = Queue()
    for seed in range(100, 100 + CLUSTER_POOL_CALLS):
        queue.put(seed)
    pool = ActorPool(actors)
    half = CLUSTER_POOL_CALLS // 2
    t0 = time.perf_counter()
    ordered = list(pool.map(lambda a, _: a.forward.remote(queue),
                            range(half)))
    unordered = list(pool.map_unordered(lambda a, _: a.forward.remote(queue),
                                        range(half)))
    pool_s = time.perf_counter() - t0
    errs, ok = [], True
    for seed, _, _, out in ordered + unordered:
        q, k, v = flash_inputs(torch, seed, dev, CLUSTER_FLASH_SHAPE)
        good, err = held(f"(l4) seed {seed}", out.to(dev),
                         attn.mha_reference(q, k, v, causal=True))
        ok, errs = ok and good, errs + [err]
    for actor in actors:
        rt.kill(actor)
    queue.shutdown()
    return {"seeds": sorted(s for s, *_ in ordered + unordered),
            "ordered_seeds": [s for s, *_ in ordered],
            "pids": sorted({p for _, p, _, _ in ordered + unordered}),
            "launches": sum(l["flash_fwd"] for _, _, l, _ in
                            ordered + unordered),
            "max_abs_err": max(errs), "within_bars": ok, "pool_s": pool_s}


def k1_reference(torch, llama, attn, n_layers, dev):
    """(k1)'s run alone (`--only-cluster`): its record."""
    import tempfile

    import ray_tpu_torch as rt

    rows = data_rows(torch, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        ds = token_dataset(rows, tmp, shuffle=True)
        rt.init(num_cpus=4, num_gpus=1)
        try:
            return data_train_run(torch, llama, attn, rows, ds, n_layers,
                                  dev)
        finally:
            rt.shutdown()


def cluster_phase(torch, llama, attn, card, n_layers, dev, k1=None,
                  width=None):
    """Phase (l), (l1)-(l4) on one card (see the module's doc). `k1`:
    (k1)'s record, run here when None. Returns the `{"cluster": ...}`
    record."""
    import tempfile

    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    if k1 is None:
        k1 = k1_reference(torch, llama, attn, n_layers, dev)
    seconds = {"k1": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as tmp:
        t0 = time.perf_counter()
        l1 = cluster_job_run(torch, n_layers, dev, tmp, width)
        seconds["l1"] = time.perf_counter() - t0
        rt.init(num_cpus=4, num_gpus=1)
        try:
            t0 = time.perf_counter()
            l2 = cluster_workflow_run(torch, rt, n_layers, dev, tmp,
                                      l1["job"]["rows"][:BATCH], width)
            seconds["l2"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            l4 = cluster_pool_run(torch, rt, dev)
            seconds["l4"] = time.perf_counter() - t0
        finally:
            rt.shutdown()
    t0 = time.perf_counter()
    l3 = cluster_autoscale_run(dev)
    seconds["l3"] = time.perf_counter() - t0
    job = l1["job"]
    steps = DATA_ROWS // BATCH
    loss_rel = max(rel(a, b) for a, b in zip(job["losses"], k1["losses"]))
    print(f"(l1) head --num-gpus 1: status totals {l1['status_totals']}, "
          f"state ls nodes GPU {l1['node_gpus']}; job {l1['job_status']} in "
          f"{l1['job_s']:.1f} s, the job saw CUDA_VISIBLE_DEVICES="
          f"{job['job_visible_devices']!r} ({job['job_device']}); "
          f"{len(job['losses'])} steps, median "
          f"{statistics.median(job['step_ms'][1:]):.2f} ms (k1's "
          f"{k1['steady_step_ms']:.2f}), losses {[round(x, 4) for x in job['losses']]}"
          f", max relative to (k1)'s {loss_rel:.3g}; launches "
          f"{job['launches']}; profile {l1['profile']}, the rank's device "
          f"trace names {l1['device_trace_kernels']}; dashboard GPU "
          f"{l1['dashboard_gpu']}, steps {l1['dashboard_steps_observed']}, /metrics "
          f"compile series {l1['metrics_compile_lines']}; "
          f"stop: {l1['stop']!r}, left {l1['left_processes']}, free "
          f"{l1.get('free_before')} -> {l1.get('free_after')} B; card: {card}")
    print(f"(l2) workflow: first run {l2['first_error']} in "
          f"{l2['first_s']:.1f} s; resume in a card-less driver "
          f"{l2['resume_s']:.1f} s: output {l2['output']}, step A ran "
          f"{l2['step_a_runs']} time(s) (launches {l2['step_a_launches']}; "
          f"on resume {l2['resume_step_a_launches']}), its saved value on "
          f"{l2['saved_device']} (loss {l2['saved_loss']:.6f})")
    print(f"(l3) autoscaler: demand to running "
          f"{l3['demand_to_running_s']:.2f} s, {l3['launched']} launch(es), "
          f"{l3['workers_while_running']} node(s) while running, "
          f"{l3['workers_after_idle']} after {l3['idle_to_terminated_s']:.1f}"
          f" s idle; on {l3['device']}, launches {l3['launches']}, max err "
          f"{l3['max_abs_err']:.3g} (max|ref| {l3['ref_max']:.3g})")
    print(f"(l4) ActorPool: seeds {l4['seeds']}, pids {l4['pids']}, "
          f"{l4['launches']} flash launches, max err {l4['max_abs_err']:.3g}"
          f" in {l4['pool_s']:.1f} s")
    print(f"(l): {seconds}")
    assert "'GPU': 1.0" in l1["status_totals"], l1
    assert l1["node_gpus"] == [1.0], l1
    assert l1["dashboard_gpu"] == {"total": 1.0, "available": 1.0}, l1
    assert l1["job_status"] == "SUCCEEDED", l1
    assert len(job["losses"]) == steps == len(k1["losses"]), (job, k1)
    assert len(set(job["rows"])) == DATA_ROWS == len(job["rows"]), job
    assert sum(job["rows"]) == k1["row_sum"], (job["rows"], k1)
    assert loss_rel <= MESH_LOSS_REL, (job["losses"], k1["losses"])
    assert job["on_card"], job
    assert l1["merged_trace_events"] > 0, l1
    if dev.type == "cuda":
        assert job["device"] == torch.cuda.get_device_name(0), job
        assert job["launches"]["flash_fwd"] == steps * n_layers * 2, job
        for name in BWD_LAUNCHES:
            assert job["launches"][name] == steps * n_layers, job
        kernels = l1["device_trace_kernels"]
        assert kernels.get("flash_fwd_kernel") and \
            kernels.get("flash_bwd_kernel"), l1
        assert l1["free_after"] >= l1["free_before"] - CLUSTER_MEM_SLACK, l1
    assert l1["dashboard_steps_observed"] >= steps, l1
    assert l1["metrics_compile_lines"] and l1["metrics_nodes_alive"], l1
    assert not l1["left_processes"] and l1["head_rc"] is not None, l1
    assert l2["step_a_runs"] == 1 and l2["resume_step_a_launches"] == 0, l2
    assert l2["status"] == "SUCCESSFUL" and not l2["cuda"], l2
    assert l2["saved_device"] == "cpu", l2
    assert l2["output"]["loss"] == l2["saved_loss"], l2
    assert math.isfinite(l2["saved_loss"]) and l2["saved_grad_norm"] > 0, l2
    assert rel(l2["saved_loss"], k1["direct_step1_loss"]) <= MESH_LOSS_REL, (
        l2, k1["direct_step1_loss"])
    if dev.type == "cuda":
        assert l2["step_a_launches"]["flash_fwd"] == n_layers * 2, l2
        assert l3["device"] == torch.cuda.get_device_name(0), l3
        assert l3["launches"]["flash_fwd"] == 1, l3
        assert l4["launches"] == CLUSTER_POOL_CALLS, l4
    assert l3["launched"] == 1 and l3["workers_while_running"] == 1, l3
    assert l3["workers_after_idle"] == 0, l3
    assert l3["max_abs_err"] <= REL_TOL * l3["ref_max"] and \
        l3["rel_l2"] <= REL_TOL, l3
    assert l4["seeds"] == list(range(100, 100 + CLUSTER_POOL_CALLS)), l4
    assert l4["within_bars"], l4
    return {"card": card, "seconds": seconds,
            "l1": {"step_ms": job["step_ms"],
                   "steady_step_ms": statistics.median(job["step_ms"][1:]),
                   "k1_steady_step_ms": k1["steady_step_ms"],
                   "losses": job["losses"], "k1_losses": k1["losses"],
                   "max_loss_rel_to_k1": loss_rel,
                   **{k: v for k, v in l1.items() if k != "job"},
                   "job_launches": job["launches"], "fit_s": job["fit_s"],
                   "job_visible_devices": job["job_visible_devices"]},
            "l2": l2, "l3": l3, "l4": l4,
            "bars": {"loss_rel": MESH_LOSS_REL, "rel_tol": REL_TOL,
                     "mem_slack": CLUSTER_MEM_SLACK}}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile", action="store_true",
        help="after the slice, trace one more step with torch.profiler "
             "and print the device time by kernel")
    parser.add_argument(
        "--layers", type=int, default=N_LAYERS,
        help=f"depth of the slice's model (default {N_LAYERS}; "
             "Llama-2-7B has 32)")
    parser.add_argument(
        "--against", metavar="ROOT",
        help="compare the attention ops and the step's memory with those "
             "of another checkout at ROOT (phase (d))")
    parser.add_argument(
        "--serve-layers", type=int, default=SERVE_LAYERS,
        help=f"depth of the serving phase's Llama-2-7B (default "
             f"{SERVE_LAYERS}, the full model)")
    parser.add_argument(
        "--cards", type=int, choices=(1, 4), default=1,
        help="4: build the kernels, then run only the four-card phase "
             "(pipeline, ring, expert and mesh steps on four cards against "
             "one); it fails on a machine with fewer cards")
    parser.add_argument(
        "--only-mpmd", action="store_true",
        help="build the kernels, then run only the MPMD pipeline's phase "
             "((g4) on one card; with --cards 4, the four-card MPMD run)")
    parser.add_argument(
        "--only-rl", action="store_true",
        help="build the kernels, then run only the RL phase ((i1)-(i4) on "
             "one card)")
    parser.add_argument(
        "--only-data", action="store_true",
        help="build the kernels, then run only the data and tune phase "
             "((k1)-(k2) on one card; with --cards 4, only (k3))")
    parser.add_argument(
        "--only-serve", action="store_true",
        help="build the paged decode kernel, then run only its timing at "
             "the serving cell's shape and the serving phase ((e1)-(e3) "
             "on one card)")
    parser.add_argument(
        "--only-cluster", action="store_true",
        help="build the kernels, then run only the cluster surface's phase "
             "((l1)-(l4) on one card, with (k1) as its reference)")
    args = parser.parse_args()
    n_layers = args.layers

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train import default_optimizer, make_train_step

    # ---- (a) header and build ----------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reports = _build.build(
        tuple(_build.DEFINES) if args.only_serve else tuple(_build.SOURCES))
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'cached'})")
    print_ptxas(reports)
    # Each library's nvcc build as the compile watch recorded it.
    from ray_tpu_torch._private import compile_watch

    nvcc_ms = {name[len("kernel."):]: row["total_ms"]
               for name, row in compile_watch.snapshot().items()
               if name.startswith("kernel.")}

    if args.only_rl:
        dev = torch.device("cuda")
        record = {"rl": rl_phase(torch, llama, card, dev,
                                 rl_decode_delta(torch, llama, dev))}
        print(json.dumps(record))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    if args.only_serve:
        serve, _ = serve_phase(torch, llama, attn, card, args.serve_layers,
                               torch.device("cuda"))
        print(json.dumps({"serve": serve}))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    if args.only_cluster:
        record = {"cluster": cluster_phase(torch, llama, attn, card,
                                           n_layers, torch.device("cuda"))}
        print(json.dumps(record))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    if args.only_data:
        if args.cards == 4:
            record = {"four_cards": {"data": cards4_data_run(
                torch, card, n_layers)}}
        else:
            record = {"data": data_phase(torch, llama, attn, card, n_layers,
                                         torch.device("cuda"))}
        print(json.dumps(record))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    if args.cards == 4 or args.only_mpmd:
        if args.cards == 4 and args.only_mpmd:
            record = {"four_cards": {"mpmd": cards4_mpmd_run(torch, card)}}
        elif args.cards == 4:
            record = {"four_cards": four_card_phase(torch, card, n_layers,
                                                    args.profile)}
        else:
            record = {"train_mpmd": mpmd_phase(
                torch, llama, attn, card, torch.device("cuda"))}
        print(json.dumps(record))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(bf16)

    # ---- (b) each kernel against its plain version --------------------
    # (label, bh, t, tk, d, causal, q_len, kv_len): t and tk are padded
    # to the kernels' tile; rows/columns past q_len/kv_len are padding.
    # The kernels work in 128-row tiles of q and KV: t 192 ends in half
    # a tile, t 64 is half of one, kv_len 200 ends inside a KV tile.
    edge_cases = [
        ("t192", 64, 192, 192, 128, True, 192, 192),
        ("t64", 64, 64, 64, 128, True, 64, 64),
        ("q128k384", 64, 128, 384, 128, False, 128, 384),
        ("kvlen200", 64, 256, 256, 128, False, 256, 200),
        ("bh1", 1, 256, 256, 128, True, 256, 256),
    ]
    fwd_cases = [
        ("main", 64, 4096, 4096, 128, True, 4096, 4096),
        ("cross", 64, 512, 2048, 128, False, 512, 2048),
        ("ragged", 64, 320, 320, 128, True, 300, 300),
        ("d64", 64, 1024, 1024, 64, True, 1024, 1024),
    ] + edge_cases
    bwd_cases = [
        ("main", 64, 4096, 4096, 128, True, 4096, 4096),
        ("causal2048", 64, 2048, 2048, 128, True, 2048, 2048),
        ("cross", 64, 512, 2048, 128, False, 512, 2048),
        ("ragged", 64, 320, 320, 128, True, 300, 300),
        ("d64", 64, 1024, 1024, 64, True, 1024, 1024),
    ] + edge_cases

    def inputs(bh, t, tk, d, q_len, kv_len):
        """q pre-scaled for the kernels, k, v, and q itself."""
        q, k, v = randn(bh, t, d), randn(bh, tk, d), randn(bh, tk, d)
        q[:, q_len:] = 0
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
        return attn.prescale(q, 1.0 / math.sqrt(d)), k, v, q

    def backward(q2, k, v, out, lse, do, causal, kv_len, q_len):
        """(kernels, plain version) of the backward op under upstream
        `do`."""
        args = (q2, k, v, out, do, lse, 1.0 / math.sqrt(q2.shape[-1]),
                causal, kv_len, q_len)
        got = attn.flash_backward(*args)
        torch.cuda.synchronize()
        return got, attn.flash_backward_plain(*args)

    results = {}
    for label, bh, t, tk, d, causal, q_len, kv_len in fwd_cases:
        q2, k, v, _ = inputs(bh, t, tk, d, q_len, kv_len)
        out, lse = attn.flash_forward(q2, k, v, causal, kv_len)
        torch.cuda.synchronize()
        p_out, p_lse = attn.flash_forward_plain(q2, k, v, causal, kv_len)
        print(f"fwd {label} {(bh, t, tk, d)} causal={causal}:")
        ok, e_out = held("out", out[:, :q_len], p_out[:, :q_len], OUT_TOL)
        e_lse = max_err(lse[:, :q_len], p_lse[:, :q_len])
        print(f"  lse: max err {e_lse:.3g} (bar {LSE_TOL})")
        assert ok and e_lse <= LSE_TOL, (label, e_out, e_lse)
        results[("fwd", label)] = (e_out, e_lse)
        del out, lse, p_out, p_lse
    for label, bh, t, tk, d, causal, q_len, kv_len in bwd_cases:
        q2, k, v, _ = inputs(bh, t, tk, d, q_len, kv_len)
        out, lse = attn.flash_forward(q2, k, v, causal, kv_len)
        do = randn(bh, t, d)
        do[:, q_len:] = 0
        print(f"bwd {label} {(bh, t, tk, d)} causal={causal}, random do:")
        got, ref = backward(q2, k, v, out, lse, do, causal, kv_len, q_len)
        ok, errs = grads_held(got, ref, q_len, kv_len)
        assert ok, (label, "random do", errs)
        results[("bwd", label)] = max(errs)
        if label == "main":
            # Negative controls: the bars reject a backward that wrote no
            # dq, and the kernel given `do` shifted by one row.
            print("  negative control, dq = 0 (must be outside the bars):")
            assert not grads_held((torch.zeros_like(got[0]),) + got[1:],
                                  ref, q_len, kv_len)[0]
            print("  negative control, do shifted one row (must be "
                  "outside the bars):")
            shifted, _ = backward(q2, k, v, out, lse, do.roll(1, dims=1),
                                  causal, kv_len, q_len)
            assert not grads_held(shifted, ref, q_len, kv_len)[0]
            del shifted
        del got, ref
        # The verify recipe's upstream gradient: d(sum(out * 0.01))/d(out).
        do = torch.full_like(out, 0.01)
        do[:, q_len:] = 0
        print(f"bwd {label}, recipe do = 0.01:")
        got, ref = backward(q2, k, v, out, lse, do, causal, kv_len, q_len)
        ok, errs = grads_held(got, ref, q_len, kv_len, GRAD_TOL)
        assert ok, (label, "recipe do", errs)
        del out, lse, do, got, ref
    torch.cuda.empty_cache()

    # sp4_long's shape under `--cards 4`: Ulysses gives each of the 4
    # ranks 8 of the 32 heads over all CARDS4_LONG_SEQ positions. The
    # plain version runs a head at a time (its f32 scores are 1 GiB a
    # head).
    bh, t, d = 8, CARDS4_LONG_SEQ, 128
    q2, k, v, _ = inputs(bh, t, t, d, t, t)
    out, lse = attn.flash_forward(q2, k, v, True, t)
    do = randn(bh, t, d)
    got = attn.flash_backward(q2, k, v, out, do, lse, 1.0 / math.sqrt(d),
                              True, t, t)
    torch.cuda.synchronize()
    heads = [slice(i, i + 1) for i in range(bh)]
    p_out, p_lse = (torch.cat(parts) for parts in zip(*(
        attn.flash_forward_plain(q2[i], k[i], v[i], True, t)
        for i in heads)))
    print(f"fwd sp4_long {(bh, t, t, d)} causal=True:")
    ok, e_out = held("out", out, p_out, OUT_TOL)
    e_lse = max_err(lse, p_lse)
    print(f"  lse: max err {e_lse:.3g} (bar {LSE_TOL})")
    assert ok and e_lse <= LSE_TOL, ("sp4_long", e_out, e_lse)
    results[("fwd", "sp4_long")] = (e_out, e_lse)
    del p_out, p_lse
    ref = [torch.cat(parts) for parts in zip(*(
        attn.flash_backward_plain(q2[i], k[i], v[i], out[i], do[i], lse[i],
                                  1.0 / math.sqrt(d), True, t, t)
        for i in heads))]
    print(f"bwd sp4_long {(bh, t, t, d)} causal=True, random do:")
    ok, errs = grads_held(got, ref, t, t)
    assert ok, ("sp4_long", "random do", errs)
    results[("bwd", "sp4_long")] = max(errs)
    del q2, k, v, out, lse, do, got, ref
    torch.cuda.empty_cache()

    # The public op (padding, reshapes, autograd) against mha_reference
    # in f32 on the same bf16 inputs, at the verify recipe's shapes, under
    # a random upstream gradient. t_q == t_k wherever causal, where the
    # reference's bottom-right mask equals the kernels' top-left one.
    for tq, tkv, causal in [(2048, 2048, True), (512, 2048, False),
                            (300, 300, True)]:
        q = randn(1, 2, tq, 128).requires_grad_()
        k = randn(1, 2, tkv, 128).requires_grad_()
        v = randn(1, 2, tkv, 128).requires_grad_()
        do = randn(1, 2, tq, 128)
        out = attn.flash_attention(q, k, v, causal=causal)
        grads = torch.autograd.grad(out, (q, k, v), do)
        qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
        ref = attn.mha_reference(qf, kf, vf, causal=causal)
        ref_grads = torch.autograd.grad(ref, (qf, kf, vf), do.float())
        print(f"flash_attention vs mha_reference (f32) tq={tq} tk={tkv} "
              f"causal={causal}:")
        checks = [held("out", out, ref)] + [
            held(name, g, r)
            for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads)]
        assert all(ok for ok, _ in checks), (tq, tkv, causal)

    # Times at the slice's shape: b 2 x h 32 = bh 64, t 4096, d 128.
    bh, t, d = BATCH * 32, SEQ, 128
    scale = 1.0 / math.sqrt(d)
    q2, k, v, q = inputs(bh, t, t, d, t, t)
    do = randn(bh, t, d)
    out, lse = attn.flash_forward(q2, k, v, True, t)
    bwd_args = (q2, k, v, out, do, lse, scale, True, t, t)
    fwd_ms = cuda_ms(torch, lambda: attn.flash_forward(q2, k, v, True, t), 20)
    fwd_plain_ms = cuda_ms(
        torch, lambda: attn.flash_forward_plain(q2, k, v, True, t), 3)
    # The backward op is every launch of it, as the train step runs it
    # (outputs and dq's accumulator allocated, delta, the fused kernel,
    # dq's scale and cast): the same work as SDPA's backward share.
    bwd_ms = cuda_ms(torch, lambda: attn.flash_backward(*bwd_args), 10)
    delta, dq_acc = attn.flash_backward_pre(out, do)
    bwd_launch_ms = {
        "flash_bwd_pre": cuda_ms(
            torch, lambda: attn.flash_backward_pre(out, do), 20),
        "flash_bwd": cuda_ms(torch, lambda: attn.flash_backward_main(
            q2, k, v, do, lse, delta, dq_acc, True, t, t), 10),
        "flash_bwd_dq": cuda_ms(torch, lambda: attn.flash_backward_dq(
            dq_acc, q2.shape, scale), 20),
    }
    bwd_plain_ms = cuda_ms(
        torch, lambda: attn.flash_backward_plain(*bwd_args), 2)
    q4, k4, v4, do4 = (x.view(BATCH, 32, t, d) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd_ms = cuda_ms(
        torch, lambda: sdpa(q4, k4, v4, is_causal=True, scale=scale), 20)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
    sdpa_fwd_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        sdpa(qg, kg, vg, is_causal=True, scale=scale), (qg, kg, vg), do4), 10)
    sdpa_bwd_ms = sdpa_fwd_bwd_ms - sdpa_fwd_ms
    # Two products of 2*d FLOP per unmasked pair forward, five backward;
    # each input read once and each output written once (the backward's
    # outputs dq, dk and dv in bf16).
    pairs = bh * valid_pairs(True, t, t)
    fwd_bound, fwd_by = bound_ms(4 * d * pairs, nbytes(q2, k, v, out, lse))
    bwd_bound, bwd_by = bound_ms(
        10 * d * pairs, nbytes(q2, k, v, out, do, lse) + 3 * nbytes(q2))
    print(f"flash_fwd {fwd_ms:.3f} ms (plain {fwd_plain_ms:.2f}, sdpa "
          f"{sdpa_fwd_ms:.3f}, bound {fwd_bound:.3f} by {fwd_by})")
    print(f"flash_bwd op {bwd_ms:.3f} ms (launches "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in bwd_launch_ms.items())
          + f"; plain {bwd_plain_ms:.2f}, sdpa bwd {sdpa_bwd_ms:.3f}, "
          f"bound {bwd_bound:.3f} by {bwd_by})")
    del (q2, k, v, q, do, out, lse, bwd_args, delta, dq_acc, q4, k4, v4, do4,
         qg, kg, vg)
    torch.cuda.empty_cache()
    any_results = any_kernel_checks(torch, attn)
    any_times = any_kernel_times(torch, attn)

    # ---- (c) the slice ------------------------------------------------
    # A small bf16 model first: flash against reference attention on
    # the same weights.
    small = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                              n_heads=4, n_kv_heads=2, intermediate=512,
                              max_seq_len=256, dtype=bf16)
    m_flash = llama.init_params(small, gen, device=dev)
    m_ref = llama.Llama(dataclasses.replace(small, attention="reference"),
                        device=dev)
    m_ref.load_state_dict(m_flash.state_dict())
    toks = torch.randint(0, small.vocab_size, (2, 200), generator=gen,
                         device=dev)
    with torch.no_grad():
        lf = llama.forward(m_flash, toks)
        lr = llama.forward(m_ref, toks)
    assert lf.shape == (2, 200, small.vocab_size) and torch.isfinite(lf).all()
    e_logits = max_err(lf, lr)
    print(f"small model logits, flash vs reference: err {e_logits:.3g}")
    assert e_logits <= LOGITS_TOL, e_logits
    del m_flash, m_ref, lf, lr

    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
    model = llama.init_params(cfg, gen, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=gen,
                          device=dev)
    tokens, targets = batch[:, :-1], batch[:, 1:]
    # (h1)'s inputs: the runtime up, and the weights and batch in its
    # object store before the first step changes them.
    import ray_tpu_torch as rt

    rt.init(num_cpus=2, num_gpus=1)
    t0 = time.perf_counter()
    weights_ref = rt.put(model.state_dict())
    weights_put_ms = (time.perf_counter() - t0) * 1e3
    batch_ref = rt.put(batch)
    digest = weights_digest(torch, model.state_dict())
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=3e-4, total_steps=20),
        device=dev)
    state = init_fn(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    losses, norms, step_s = [], [], []
    attn.reset_launch_counts()
    compile_watch.reset()  # (j2)'s window: (c)'s steps
    watch_c = {}
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens, targets)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        watch_c.setdefault("after_step_1", watch_counts(["train."]))
    watch_c["after_last_step"] = watch_counts(["train."])
    launches = dict(attn.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    print("losses", [round(x, 4) for x in losses])
    print("grad norms", [round(x, 4) for x in norms])
    assert all(math.isfinite(x) for x in losses + norms), losses
    assert losses[-1] < losses[0], losses
    assert launches["flash_fwd"] == TRAIN_STEPS * n_layers * 2, launches
    for name in BWD_LAUNCHES:
        assert launches[name] == TRAIN_STEPS * n_layers, launches
    steady = statistics.median(step_s[1:])
    tokens_per_s = BATCH * SEQ / steady
    mfu = train_flops_per_token(cfg, SEQ) * tokens_per_s / PEAK_BF16_FLOPS
    # (j4): the watch's hot path on the step's own arguments.
    watch_c.update(hot_path_us=hot_path_us((state, tokens, targets)),
                   step_ms=steady * 1e3)

    if args.profile:
        profile = profile_step(
            torch, lambda: step_fn(state, tokens, targets))
        print(json.dumps({"profile": profile}))
    del model, state, batch, tokens, targets, step_fn, init_fn
    torch.cuda.empty_cache()

    # ---- (h1) the runtime on the card --------------------------------
    try:
        runtime = runtime_phase(torch, card, weights_ref, batch_ref, digest,
                                losses, [x * 1e3 for x in step_s], n_layers)
        runtime["weights_put_ms"] = weights_put_ms
    finally:
        del weights_ref, batch_ref
        rt.shutdown()

    # ---- (h2) Gemma-2B at full width on the d 256 kernels -------------
    gemma = gemma_phase(torch, llama, attn, card, dev, args.profile)

    # ---- (h3) head_dim above 256 on the "wide" kernels ------------------
    wide = wide_phase(torch, llama, attn, card, dev)
    wide["f32"] = wide_phase(torch, llama, attn, card, dev, torch.float32,
                             WIDE_F32_STEPS)

    # ---- (h4) f32 at Gemma-2B's head_dim 256 on the "any" kernels -------
    f32_any = wide_phase(torch, llama, attn, card, dev, torch.float32,
                         WIDE_F32_STEPS, head_dim=F32_ANY_HEAD_DIM,
                         label="(h4)")

    # ---- (f) remat policies, the mesh step, trainer and checkpoints ----
    sharded = train_sharded_phase(torch, llama, attn, card, n_layers, dev,
                                  args.profile)
    by_policy = sharded["f1"]["launches"]

    # ---- (g) the pipeline step, MoE, and expert parallelism -----------
    f1_full = sharded["f1"]["policies"]["full"]
    pp = pp_phase(torch, llama, attn, card, n_layers, dev,
                  f1_full["losses"][0], args.profile,
                  f1_full.get("alive_at_peak"))

    # ---- (g4) the MPMD pipeline's stage actors on the card -------------
    t0 = time.perf_counter()
    mpmd = mpmd_phase(torch, llama, attn, card, dev)
    print(f"(g4): {time.perf_counter() - t0:.1f} s")

    # ---- (e) serving ---------------------------------------------------
    t0 = time.perf_counter()
    serve, serve_requests = serve_phase(torch, llama, attn, card,
                                        args.serve_layers, dev, args.profile)
    print(f"serve (e1)-(e3): {time.perf_counter() - t0:.1f} s")

    # ---- (e4) the LLM app over HTTP on the card -----------------------
    t0 = time.perf_counter()
    serve_app = serve_app_phase(torch, llama, card, args.serve_layers,
                                serve, serve_requests, dev)
    print(f"serve (e4): {time.perf_counter() - t0:.1f} s")
    serve_launches = serve["flash_launches_while_serving"]

    # ---- (i) the RL slice ---------------------------------------------
    t0 = time.perf_counter()
    rl = rl_phase(torch, llama, card, dev, serve["delta"])
    print(f"(i): {time.perf_counter() - t0:.1f} s")

    # ---- (j) the compile watch on the card ----------------------------
    watch = watch_phase(torch, llama, _build, card, dev, {
        "c": watch_c, "e3": serve["compile_watch"],
        "g4": {label: r["compiles"] for label, r in mpmd["g4b"].items()},
        "i2": rl["i2"]["compile_watch"], "i3": rl["i3"]["compile_watch"]})
    print(f"(j): {watch['wall_s']:.1f} s")

    # ---- (k) data and tune on the card --------------------------------
    t0 = time.perf_counter()
    data = data_phase(torch, llama, attn, card, n_layers, dev,
                      sharded["f2"]["steady_step_ms"])
    print(f"(k): {time.perf_counter() - t0:.1f} s")

    # ---- (l) the cluster surface on the card --------------------------
    t0 = time.perf_counter()
    cluster = cluster_phase(torch, llama, attn, card, n_layers, dev,
                            data["k1"])
    print(f"(l): {time.perf_counter() - t0:.1f} s")

    kernels = [
        {
            "name": "flash_fwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/attention.py:136",
            "launches": launches["flash_fwd"],
            "max_abs_err": results[("fwd", "main")][0],
            "lse_max_abs_err": results[("fwd", "main")][1],
            "sp4_long_max_abs_err": results[("fwd", "sp4_long")][0],
            "ms": fwd_ms, "plain_ms": fwd_plain_ms,
            "bound_ms": fwd_bound, "bound_by": fwd_by,
            "library_ms": sdpa_fwd_ms,
            "serve_launches": serve_launches["flash_fwd"],
            "launches_by_policy": {p: n["flash_fwd"]
                                   for p, n in by_policy.items()},
            "launches_mesh_step": sharded["f2"]["launches"]["flash_fwd"],
            "launches_data": data["k1"]["launches"]["flash_fwd"],
            "launches_per_step_pp": {
                g: pp[g]["launches_per_step"]["flash_fwd"]
                for g in ("g1", "g2")},
            "launches_mpmd": {
                label: [n["flash_fwd"] for n in r["launches"]]
                for label, r in mpmd["g4b"].items()},
            "bound_share": fwd_bound / fwd_ms,
            "vs_library": fwd_ms / sdpa_fwd_ms,
            "shape": [bh, t, d], "causal": True,
        },
        {
            # The op: its three launches, timed together (`ms`) and one
            # by one (`launch_ms`); `launches` counts the fused kernel.
            "name": "flash_bwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "ray_tpu/ops/attention.py:302",
            "launches": launches["flash_bwd"],
            "launches_by_kernel": {n: launches[n] for n in BWD_LAUNCHES},
            "max_abs_err": results[("bwd", "main")],
            "sp4_long_max_abs_err": results[("bwd", "sp4_long")],
            "ms": bwd_ms, "launch_ms": bwd_launch_ms,
            "kernel_ms": bwd_launch_ms["flash_bwd"],
            "plain_ms": bwd_plain_ms,
            "bound_ms": bwd_bound, "bound_by": bwd_by,
            # The backward share of one SDPA forward+backward.
            "library_ms": sdpa_bwd_ms,
            "library_fwd_bwd_ms": sdpa_fwd_bwd_ms,
            "serve_launches": serve_launches["flash_bwd"],
            "launches_by_policy": {p: n["flash_bwd"]
                                   for p, n in by_policy.items()},
            "launches_mesh_step": sharded["f2"]["launches"]["flash_bwd"],
            "launches_data": data["k1"]["launches"]["flash_bwd"],
            "launches_per_step_pp": {
                g: pp[g]["launches_per_step"]["flash_bwd"]
                for g in ("g1", "g2")},
            "launches_mpmd": {
                label: [n["flash_bwd"] for n in r["launches"]]
                for label, r in mpmd["g4b"].items()},
            "bound_share": bwd_bound / bwd_ms,
            "vs_library": bwd_ms / sdpa_bwd_ms,
            "shape": [bh, t, d], "causal": True,
        },
    ]
    main_rec = any_times["bf16_d256"]
    # The "any" pair on (h2)'s path, the "wide" pair on (h3)'s; each timed
    # at its ANY_TIMED shape.
    for name, source, timed_key, replaces, label, path in (
            ("flash_fwd_any", "flash_fwd_any", "fwd",
             "ray_tpu/ops/attention.py:136", "bf16_d256", gemma),
            ("flash_bwd_any", "flash_bwd_any", "bwd",
             "ray_tpu/ops/attention.py:302", "bf16_d256", gemma),
            ("flash_fwd_wide", "flash_fwd_any", "fwd",
             "ray_tpu/ops/attention.py:136", "bf16_d512", wide),
            ("flash_bwd_wide", "flash_bwd_any", "bwd",
             "ray_tpu/ops/attention.py:302", "bf16_d512", wide)):
        rec = any_times[label]
        entry = {
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": path["launches"][name],
            "max_abs_err": rec[f"{timed_key}_max_abs_err"],
            "ms": rec[f"{timed_key}_ms"],
            "plain_ms": rec[f"{timed_key}_plain_ms"],
            "bound_ms": rec[f"{timed_key}_bound_ms"],
            "bound_by": rec[f"{timed_key}_bound_by"],
            "library_ms": rec[f"{timed_key}_library_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"], "causal": True,
            "bound_share": rec[f"{timed_key}_bound_ms"]
            / rec[f"{timed_key}_ms"],
            "vs_library": rec[f"{timed_key}_ms"]
            / rec[f"{timed_key}_library_ms"],
            "launches_per_step": path["launches_per_step"][name],
        }
        # The same kernel's other dtypes at their ANY_TIMED shapes.
        others = (("f32", "f32_d128"), ("f32_d256", "f32_d256")) if (
            label == "bf16_d256") else (("f16", "f16_d512"),
                                        ("f32", "f32_d512"))
        for key, other in others:
            entry[key] = {k: v for k, v in any_times[other].items()
                          if k.startswith(timed_key) or k in (
                              "shape", "pair", "library_max_abs_err")}
        # The f32 kernels' own paths: f32 (h3) for the "wide" pair, (h4)
        # for the "any" pair.
        f32_path = wide["f32"] if path is wide else f32_any
        entry["f32"]["launches"] = f32_path["launches"][name]
        entry["f32"]["launches_per_step"] = (
            f32_path["launches_per_step"][name])
        if label == "bf16_d256":
            entry["checks"] = dict(any_results)
        kernels.append(entry)
    # The f32 "wide" kernels on their own path, f32 (h3), timed at f32 d
    # 512 (the same counters as the 16-bit "wide" pair's).
    for name, source, timed_key, replaces in (
            ("flash_fwd_wide_tf32", "flash_fwd_any", "fwd",
             "ray_tpu/ops/attention.py:136"),
            ("flash_bwd_wide_tf32", "flash_bwd_any", "bwd",
             "ray_tpu/ops/attention.py:302")):
        rec = any_times["f32_d512"]
        counter = f"flash_{timed_key}_wide"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": wide["f32"]["launches"][counter],
            "max_abs_err": rec[f"{timed_key}_max_abs_err"],
            "ms": rec[f"{timed_key}_ms"],
            "plain_ms": rec[f"{timed_key}_plain_ms"],
            "bound_ms": rec[f"{timed_key}_bound_ms"],
            "bound_by": rec[f"{timed_key}_bound_by"],
            "library_ms": rec[f"{timed_key}_library_ms"],
            "split_bound_ms": rec[f"{timed_key}_split_bound_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"], "causal": True,
            "bound_share": rec[f"{timed_key}_bound_ms"]
            / rec[f"{timed_key}_ms"],
            "vs_library": rec[f"{timed_key}_ms"]
            / rec[f"{timed_key}_library_ms"],
            "launches_per_step": wide["f32"]["launches_per_step"][counter],
            "library_max_abs_err": rec["library_max_abs_err"],
        })
    # The paged decode kernel, timed alone in (e) at the serving cell's
    # shape; its launches a decode step in (e2) and (e3).
    paged = serve["paged_decode"]
    kernels.append({
        "name": "paged_decode", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_decode.cu",
        "library": "paged_decode_bf16_d128",
        "replaces": None,  # the JAX package's paged decode is plain jnp
        **{k: paged[k] for k in (
            "ms", "launch_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_share",
            "library_ms", "vs_library", "max_abs_err", "shape", "dtype",
            "lengths_mean")},
        "launches": serve["paged_decode_launches_e3"],
        "launches_per_step": serve["paged_decode_launches_per_step"],
    })
    # (a)'s nvcc build of each kernel's library, as the compile watch
    # recorded it (None: the library was cached).
    for entry in kernels:
        entry["nvcc_ms"] = nvcc_ms.get(entry.get("library") or
                                       os.path.splitext(os.path.basename(
                                           entry["source"]))[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"any_softmax_data": main_rec["softmax_data"]}))
    print(json.dumps({"slice": {
        "config": f"llama2_7b width, {n_layers} layers, bf16, flash, "
                  "remat full",
        "batch": BATCH, "seq": SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "grad_norms": norms,
        "step_ms": [s * 1e3 for s in step_s],
        "steady_step_ms": steady * 1e3, "tokens_per_s": tokens_per_s,
        "mfu": mfu, "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
        "max_memory_allocated": peak_bytes,
        "memory_allocated_at_start": start_bytes, "launches": launches,
        "card": card,
    }}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"serve_app": serve_app}))
    print(json.dumps({"train_sharded": sharded}))
    print(json.dumps({"train_pp": pp}))
    print(json.dumps({"train_mpmd": mpmd}))
    print(json.dumps({"runtime": runtime}))
    print(json.dumps({"gemma": gemma}))
    print(json.dumps({"wide": wide}))
    print(json.dumps({"f32_any": f32_any}))
    print(json.dumps({"rl": rl}))
    print(json.dumps({"compile_watch": watch}))
    print(json.dumps({"data": data}))
    print(json.dumps({"cluster": cluster}))
    if args.against:
        print(json.dumps({"against": against(
            torch, attn, args.against, randn, n_layers)}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
