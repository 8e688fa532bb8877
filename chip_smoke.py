#!/usr/bin/env python3
"""Drive the PyTorch port (scaling_tpu_torch) on one CUDA card.

Phases, each of which must pass:

1. print the card (nvidia-smi name and power limit) and require compute
   capability 9.0;
2. build every kernel of the serving and the training path from this
   checkout's sources (nvcc for the CUDA kernels, one process per source,
   all started together; Triton's compiler for the Triton ones) and print
   the build time, and each CUDA kernel's registers, spills and dynamic
   shared memory from ``ptxas -v``: a flash, paged or RMSNorm-backward
   kernel that spills fails;
3. hold each kernel against its plain PyTorch version on the same inputs
   at the shapes its path gives it, and print the max error beside the
   tolerance: K1 (native and int8) at the serving tick's shape, on one
   row of 2048 slots and on the separate decode forward's 16 rows at
   s = 1 (contexts up to 2047), each also repeated, which must give the
   same bits; K2 at serving shapes; K4 in whole-prompt prefills of one
   row at buckets 128 and 1024, the pads in segment 1; K3 (RMSNorm
   backward), with dw and dx-only, at the training rows, an odd row count,
   7 rows of 8192 and 3 of 32768 (the chunked walk), in bf16, and at the
   training rows also with an f32 gain and in f16; K4 and K5 (flash
   attention forward and backward) at the training shape, unsegmented,
   with 3 packed documents, and with 4 local heads of window 256. K5's
   gradients and both K3 variants' outputs must repeat bitwise, and the
   dx-only variant's dx must be the full one's;
4. serve the full-width 0.5B model (random weights from a seed) with
   native and with int8 KV: every request must finish with its token
   count, the kernel launch counters must be > 0 and the plain-version
   counter 0, and one tick recomputed on the CPU in f32 with the plain
   versions, from a copy of the pools taken before the tick, must agree
   with the card's logits; print tokens/s, TTFT and ITL;
   a profiled window of steady ticks gives the device's busy time, its
   idle share and the device time by kernel;
5. train the same model (bench.py's first rung: micro-batch 4, seq 2048,
   bf16, no remat): the first row's logits before any update, recomputed
   on the CPU in f32 through the plain versions from a copy of the
   weights, must agree with the card's (a tolerance that constant logits
   per position could not meet); then, counters reset, 3 warm-up and 10
   timed steps: losses finite, K2-K5 launched and no plain version run;
   print step ms, tokens/s, MFU, peak memory and the losses; one profiled
   step gives the device's busy time, its idle share and the device time
   by kernel group;
6. generate with two models at full width, cut to 2 of their 8 layers
   (``GEN["layers"]``; random weights from seed 0): (a) the same 0.5B model, (b) its widths in the JAX default
   architecture (layernorm, GELU MLP x4, tied head, key/query norm), bf16
   with flash. 8 prompts of 256-1024 tokens (the longest exactly 1024, so
   the left-padded prefill runs K4) and 128 greedy tokens each, four times
   (every row returns its tokens, the same in every run), and one 1-D
   prompt; K4 launched on both and K2 on (a), no plain version run; the
   most-padded row recomputed on the CPU in f32 with the port's
   ``logits()``: every generated position's logits within 0.05 of max
   |logit| of the card's (not constant per position), and every token whose
   CPU top-2 margin exceeds twice that error is the CPU's argmax; print the
   prefill ms, the median decode ms a token, output tokens/s, peak memory,
   and the busy ms and idle share of a profiled window of 32 decode steps;
   then AtMan controls on (a) at a 4 x 1024 batch in both variants, counters
   reset just before and read just after (K2, no K4: a manipulation runs
   unfused): factor 1 gives the uncontrolled unfused logits (bitwise
   log-additive, within 0.1 of max |logit| multiplicative), factor 0 on
   token 300 leaves positions before it bitwise and moves every later one;
   each call's ms beside K4's and the unfused logits';
7. time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call: device time from
   ``torch.profiler``, and the per-call time with CUDA events;
8. the Trainer (``models/transformer/train.py:main``) trains the same
   model at full width, cut to 2 of its 8 layers (as are phases 9-12 and
   10 (a)), from token datasets the port's builder
   writes from seed 0 (two blended prefixes of ~2M tokens, documents of
   64-4096 tokens, and a ~64k-token validation prefix), micro-batch 4,
   seq 2048, 6 iterations saving and evaluating at 3 and 6: losses finite,
   6 step records with ``palm_mfu``, two checkpoints that verify; a
   second ``main`` resumes from step 3 with the first run's parameters and
   f32 optimizer state, bitwise, and its step-4 batch; its step-4 loss is
   the first run's, bitwise, and steps 5-6 within rtol 1e-4; the
   checkpoint (``TransformerInferenceModule.from_checkpoint``) serves 4
   greedy requests with the tokens of an engine on the trainer's own
   weights; ``evaluate`` scores the step-6 checkpoint on 2 batches of the
   validation prefix read in order: finite, within 1e-5 nats of the
   trainer's forward on its in-memory step-6 weights over the same batches
   (a limit the step-3 checkpoint must miss) and within 0.05 nats of the
   trainer's step-6 eval loss, launching K2 and K4 and no plain version;
   K1-K5 launched
   and no plain version run; print the steady
   step ms beside phase 5's (8 layers), and checkpoint save and load seconds, GB/s
   and size. The checkpoints go to a temporary directory outside the
   checkout, removed at the end;
9. supervision: the same training, from the same seed and token
   datasets, in child processes of this script (``--supervise-child``)
   with ``save_checkpoint_async``, ``dataloader_prefetch_factor: 2``,
   ``step_timeout_seconds: 120`` and ``max_consecutive_nonfinite: 2``.
   Run A installs the SIGTERM handler and gets a real SIGTERM once its
   step-4 record is written: it must exit 0 at the boundary it reached
   (k = 4 or 5) with no record after k, ``global_step3`` and
   ``global_step{k}`` verifying with a ``MESH.json``, ``latest`` naming k,
   the losses of steps 1-k bitwise equal to phase 8's, the npz files of
   ``global_step3`` carrying the crc32s of phase 8's synchronous step-3
   save (an async snapshot that missed a host copy fails here), and no
   watchdog stall. Run B resumes through ``run_with_resume`` to step 6:
   at k, steps k+1-6 within rtol 1e-4 of phase 8's, ``global_step6``
   verifying, the older checkpoints' optimizer files pruned after its
   commit; K2-K5 launched and no plain version run. Print each async
   save's hold of the loop and its time until durable beside phase 8's
   synchronous saves, the peak host RSS in each save's window, and the
   step ms with prefetch apart from writes (beside phase 8's and the
   bench step) and during a write. Both children write their metrics and
   events into one run directory, where this script, in the relaunching
   supervisor's role, records the SIGTERM it sends (``preempt-relay``) and
   run B's start (``relaunch``);
10. observability: (a) after the kernel times, a 5-step Trainer run of
   phase 8's model and data with the events file on and a profiler window
   at steps 2-3 with ``capture_xla_trace``: its observations JSON holds
   the 2 steps, its ``torch.profiler`` trace names K4's and K5's kernels,
   K2-K5 launched and no plain version; each step record's ``mfu`` equals
   ``achieved_tflops / 989.4`` and lies within 1e-6 of its ``palm_mfu``;
   then one more step is left in flight while a span's emission,
   ``telemetry.on_step`` and ``telemetry.flush`` run under
   ``torch.cuda.set_sync_debug_mode("error")`` with
   ``torch.cuda.synchronize`` trapped; the host cost of a span and of
   ``on_step`` + ``flush``; and the run trains on in turns with all of
   obs, without the events file and ``on_step``, and with every obs call
   stubbed out. (b) ``serve bench --run-dir`` at phase 4's native
   traffic: K1 and K2 launched, no plain version; ``obs report``'s
   serving section counts the 32 requests and gives the bench's tokens/s
   within 0.1 %; then the bench once more in each kind: with a run
   directory, without one, and with every obs call stubbed out. The
   Trainer run of (a) carries the training tuner's prediction for it
   (phase 18 (c)), and its report prints the tuner section with the
   calibration error. (c) after phase 9, ``obs
   report`` over its run directory shows the step-time and MFU sections
   (the mfu check again), the asynchronous saves' ``ckpt.*`` spans and,
   in the timeline, the SIGTERM and the relaunch; then the turns' Trainer
   step ms beside phase 8's, and their serving tokens/s and wall clock a
   tick beside phase 4's. With ``CHIP_SMOKE_REPORTS=DIR`` in the
   environment the reports are also written under DIR;
11. supervised relaunch: phase 8's config with ``load_dir`` = ``save_dir``,
   ``assert_checkpoint_loaded: false`` and a ``runner`` section
   (``supervise``, this host, one slot, ``script: chip_smoke``) goes to
   ``runner_main(config.runner, payload)`` in a process of its own
   (``--supervise-runner``), whose workers run this script as a module
   (``--payload=...``: the port's ``worker_main``, a record at the start
   with the card's free memory and one after each step with the loss and
   the launch counters, and phase 9's pause), under
   ``SCALING_TPU_FAULTS="host.kill=kill@5@epoch=0,host.hang=hang@2@epoch=1"``
   (heartbeat timeout 20 s, startup grace 35 s, worker grace 2 s, backoff
   0.25 s doubling):
   epoch 0 trains steps 1-4 (saving at 3) and is SIGKILLed, epoch 1
   resumes at 3, trains step 4 and hangs, epoch 2 resumes at 3 and, once
   its step-5 record is written, the supervisor gets a real SIGTERM: the
   worker saves at its boundary k (5 or 6) and exits 0. Its events must be
   ``host-dead`` (exit, -9), ``teardown-complete``, ``relaunch``; then
   ``host-dead`` (``heartbeat-stale``), ``teardown-complete`` with the
   hung pid SIGKILLed, ``relaunch``; then ``preempt-relay`` and
   ``epoch-clean-exit`` (preempted), and exit 0. A second supervisor
   without faults over the same control root (wiping the stale
   ``epoch-0`` directory) resumes at k and ends at 6 with
   ``global_step6`` verifying. Losses: epoch 0 and each resumed epoch's
   first step bitwise equal to phase 8's, later steps within rtol 1e-4;
   each epoch launches K2-K5 and no plain version, and finds the card's
   free memory of epoch 0 within 1 GiB; neither supervisor initialises
   CUDA; ``obs report`` counts 2 relaunches and passes
   ``--assert-max-resizes 0``. Prints the time to recover from the crash
   and from the hang, split into detection, teardown, backoff, the
   worker's start to its first heartbeat (with the checkpoint's load) and
   the step replayed, and the timeouts beside what they budget;

12. finetune: phase 8's step-6 checkpoint (kept, its optimizer files
   pruned) LoRA-finetuned (rank 16, alpha 32, LoRA dropout 0.05 on query,
   key, value and dense) with dropout 0.1 after the embedding, the
   attention and the MLP, ``training.finetune`` on, phase 8's data,
   micro-batch 4, seq 2048, 6 steps saving at 3 and 6: (a) losses finite,
   every LoRA B moved, every frozen leaf bitwise the checkpoint's, one
   no-decay group holding the LoRA leaves alone (as
   ``tests/test_torch_peft.py`` pins against the JAX package), optimizer
   state for them alone; prints step ms, tokens/s, peak memory beside
   phase 8's and the checkpoint's bytes; (b) a resume from step 3: steps
   4-6 and the final LoRA state bitwise (a)'s, then one step without remat,
   with ``every_layer`` and with ``every_layer_save_dots`` from the same
   state: the losses bitwise, the f32 LoRA masters within 1e-6 of the run
   without remat, and where a step's time goes (the host's
   dispatch against the step with its sync, one profiled step's device
   busy time, idle share and kernel groups); (c) 2 steps at
   ``dropout_attention_probs`` 0.1: finite, and no flash kernel (nor its
   plain version) ran; (d) the step-6 checkpoint merged on load
   (``merge_lora_after_loading_checkpoint``): every B zero, one row's
   logits (1024 tokens) within 0.05 of max |logit| of the unmerged model
   in f32 on the CPU (constant logits cannot pass); the unmerged
   checkpoint served at phase 4's native traffic for 8 requests, whose
   greedy tokens equal ``generate``'s or part from them first at a near
   tie (the two candidates within 0.05 of max |logit| in the card's
   ``logits()`` there); K2-K5 on the finetune, K1 and K2 serving, no
   plain version; (e) one dropout of a (4, 2048, 2048) bf16 tensor at 0.1:
   the zero share within 5 sigma, the kept values x / 0.9 in bf16, the
   same mask for the same site and step and another for another step;
13. serving modes and resilience, on phase 4's model: (a) spec_k 4 and
   spec off on 16 of phase 4's arrivals with prompts of a random
   16-64-token segment repeated to 128-1024 tokens: every request its
   token count, K1 and K2 launched, no plain version, drafts accepted,
   greedy tokens equal or parting first at a near tie; then phase 4's
   engine again on the first 16 requests of its traffic, the run the next
   three are held against (tokens, and
   tokens/s, TTFT and ms a tick as ratios within this call): spec_k 4 on
   that traffic; (b) whole-prompt prefill: K4, K1 and K2, one 1000-token
   prompt's first-token logits within 0.05 of max |logit| of the f32 CPU
   forward; (c) ``fused_tick=False``: K1 at s = 1 and at the chunk, ms
   and launches a tick, on the first 8 requests; (d) ``serve bench`` children at
   phase 4's traffic: a wedged tick (``serve.tick=hang@40``, the watchdog
   at 5x the longest tick measured and 5 s at least, ``--restarts 1``),
   a SIGTERM drain (arrivals at 8 req/s) and an overload run (4x the
   rate, ``--max-waiting 4``, a TTFT deadline of half phase 4's p50) side
   by side, then the crash replay (``serve.tick=kill@40``, ``--restarts
   2``) alone: exit codes, journals whose completed + shed + timeout
   requests are every offered one, the crash's tokens against phase 10's
   fault-free bench (equal or a near tie), the relaunch's free memory
   within 1 GiB of the first child's, each exiting child's launch
   counters (from its stats), ``obs report`` gates and counts, and the
   time to recover split into detection, process start, model build,
   replay and the first token;
14. the serving fleet on the card, phase 4's engine on workload F (32
   requests at 128 req/s, 4 families of a 256-token shared prefix before
   128-1024 random tokens, 64-256 output tokens): (a) one engine in this
   process, the reference; (b) ``serve bench --replicas 2`` (two engines,
   a tick thread and a CUDA stream each, in one child); (c) ``serve bench
   --replicas-proc 2`` (two worker processes, one CUDA context each, the
   host without CUDA); (d) as (c) with ``serve.replica.kill=kill@40@host=1``;
   (e) a SIGTERM to a ``--replicas-proc 2`` fleet at 8 req/s, 2 s after both
   workers are ready; (b) and (c) without a run directory, as (a) (no
   events file), (d) and (e) with one. (b)-(d): tokens equal to (a)'s,
   (d)'s to (c)'s, or
   parting first at a near tie; both replicas dispatched to, affinity
   dispatches; each replica launched K1 and K2 and no plain version (its
   tick thread's counts in (b), its stats in (c) and (d)); tokens/s, TTFT
   and ITL beside (a)'s; the longest tick-loop age and stats round trip, no
   hung verdict. (d): every offered request ended once by the journals
   and the failover harvest, one ``serve-replica-restart``, ``obs report
   --assert-max-replica-restarts 1`` passes, the card's free memory with
   both replicas up after the relaunch within 1 GiB of the first start's
   and this process's before and after the run within 1 GiB, and the time
   to recover from the killed worker's last tick to the dead verdict, the
   relaunch's spawn, its ready event and the first token of a
   re-dispatched request. (e): exit 0, drained with work unsubmitted, both
   workers exit 0;
15. mixture-of-experts and muP, after phase 6: ``0.5b-moe`` (the 0.5B
   widths, 8 routed SwiGLU experts, top-2, capacity 1.25, aux 0.01, muP
   from a 256-wide base: attention scale 1/32, the head's output_mult 2,
   its 1/8 learning rate by fan-in) at full width, cut to 2 of its 8 layers
   (``MOE["layers"]``), from seed 0.
   (a) one MoE layer at b 4, s 2048 in f32 on the card and on the CPU:
   at least 0.999 of the tokens routed alike (expert set and kept
   flags), their outputs within 1e-4 of max |y|, the aux losses within
   1e-3; (b) phase 5 on this model: its first row's routing captured by
   forward hooks on the card and on the CPU, at most 5 % of the (token,
   layer) decisions differing, the logits of the positions routed alike
   in every layer within 0.05 of max |logit| (constant logits cannot
   pass); ``moe_aux_loss`` finite and positive at every step; MFU printed
   with N all parameters and with N the parameters a token touches; the
   routing and dispatch ops timed as a group of the profiled step; (c)
   phase 4 on this model with native KV, its recomputed tick's routing
   held to the same 5 %; (d) K1-K5 all launched on (b) and (c), no plain
   version run. ``generate`` on this model is left to the CPU tests;
16. the last one-device model features, after phase 15, at the 0.5B widths
   cut to 2 layers (``FEATURES``): (a) a multimodal finetune with the ViT
   image encoder at its defaults (768 wide, 6 blocks, 12 heads), micro-batch
   4, seq 2048, 2 seeded 384 x 384 images a sample (144 tokens each at 64
   and 1024), 6 steps on one batch: the loss falls, K2-K5 launched and no
   plain version, the logits before position 64 bitwise the same under
   other images; step ms and peak memory; (b) the CLIP backbones: RN50x16
   forward and backward on 8 images (the BatchNorm statistics without a
   gradient), a CLIP ViT from a state dict drawn in the CLIPVisionModel
   layout (a 7 x 7 grid, interpolated to 12 x 12) forward on 8; one image
   of each against an f32 CPU copy within 0.1 of max |y|; ms; (c) 4 of 16
   heads local with window 256: K4 prefills 4 prompts of 1024 tokens with
   its local heads, 128 greedy tokens cached against ``use_cache=False``,
   equal or parting first at a near tie, K2 and K4, no plain version; (d)
   phase 5's step (8 layers) without remat, with ``every_layer`` and with
   ``every_layer_save_dots``: ms a step, peak memory, launches a step,
   save_dots launching each of K2-K5 as often as every_layer;
17. tooling, after phase 12, at phase 8's model (``TOOLING``): (a) ~2M tokens
   in each Megatron layout (MMIDIDX by the port's writer, TNTIDX by numpy)
   from seed 0, 3 Trainer steps over their blend with ``legacy_dataset``
   and ``only_full_sequences``: the C++ builder's windows equal to the
   plain loop's, K2-K5 launched, no plain version, step ms; (b) the pack
   builder over 2,000,000 document sizes of 16-8192 tokens at sequence
   2048, every_n 0 and 4: C++ and the plain loop, equal spans, both times;
   (c) phase 8's step-6 checkpoint exported to the reference's ``.pt``
   format and imported back, bit-equal, seconds and GB/s, then served for
   8 requests against ``generate`` (equal or parting first at a near tie),
   K1 and K2, no plain version; (d) phase 8's kept steps 3 and 6 restored
   with ``restore.assemble`` failing once (retried), failing each try
   (step 6 demoted to 3), and a copy of step 6 whose ``MESH.json`` names
   two devices (``ckpt.reshard`` fires once); (e) ``python -m
   scaling_tpu_torch.train.bench --model 0.5b --mbs-plan 4,8,16,32
   --steps 3`` in a child process: each rung's tokens/s, the winner, its
   MFU, no plain version; a rung out of memory is reported as such;
18. the tuner, the analyzer's dispatch audit and the serving config, after
   phase 14 (``TUNE``): (a) K1 alone at each block size the serving tuner
   searches (8, 16, 32) at phase 4's tick shape over one 16384-slot pool,
   held against its plain version, device ms beside its bound, and the fit
   ``t = c (1 + O / bs)`` whose O is the tuner's ``PAGED_BLOCK_OVERHEAD``;
   (b) ``python -m scaling_tpu_torch.tune --serve --devices 1`` calibrated
   from phase 10's serve run directory emits a config, and ``serve bench
   --config`` serves 16 requests of phase 4's traffic with it in this
   process (the pool and longest context given explicitly), counters reset
   just before and read just after: K1 and K2 launched, no plain version;
   the chosen point, its predicted tick beside the measured mean
   ``serve.mixed`` tick, and the calibration factor; (c) the training tuner
   over the micro-batch ladder at the 0.5B, calibrated from phase 5's MFU:
   each rung's predicted memory and step time beside phase 17's measured
   rung, the tuner's pick beside the ladder's winner (printed, not gated);
   before phase 10, its prediction for phase 10's run, exported to it;
   (d) the dispatch audit (``scaling_tpu_torch.analysis.dispatch_audit``)
   of phase 5's step: K2 and K3 2L+1, K4 and K5 L launches a step, no plain
   version; and of a tick of phase 4's engine after its run: K1 and K2, no
   plain version; host syncs and device-to-host copies of each, and the
   distinct forward shapes phase 4's run produced;
19. data and tensor parallelism, after phase 17 (``DIST``): ``runner_main``
   with 4 local slots starts 4 ``train run`` workers of phase 8's model and
   data at dp 2 x mp 2 with ZeRO-1 (micro-batch 2 a data rank, phase 8's
   global batch), saving every 2 steps; they share the one card through
   gloo (NCCL refuses two ranks on one device; ``dist_probe.py``). Beside
   them a one-rank run of the same config for 2 steps. Rank 3 gets SIGTERM
   once its step-3 record is written. Checks, each failing the phase: (a)
   the step-1 and step-2 losses within 0.02 of the one-rank run's, all
   finite; (b) the probe row's (512 tokens) logits of the four ranks'
   forward at the step-4 weights within 0.05 of max |logit| of a CPU f32
   forward of the merged step-4 checkpoint (constant logits cannot pass);
   (c) each rank's step-2 launches of K2-K5 equal to the one-rank run's
   (K4/K5 on 8 query and 2 kv heads), no plain version on any rank; (d) a
   one-rank child, started with the SIGTERM beside the four ranks' step 4,
   resumes the step-2 checkpoint (``MESH.json``: dp 2 x mp 2, ZeRO 1) to
   step 4, its losses within 0.02 of the four ranks'; (e)
   every rank stops at step 4 and exits 0, ``latest`` names step 4, which
   verifies. Prints each rank's ``max_memory_allocated`` beside the
   one-rank run's and the shares the layout predicts, the backend and the
   ranks a device (gloo runs every collective on the CUDA tensors, so no
   byte is staged through the host), rank 0's collective bytes in a step,
   and the step time, taken with four ranks sharing one card (not a
   scaling figure);
20. pipeline parallelism, beside phase 19 (``PIPE``; its lines follow
   phase 19's): ``runner_main`` with
   4 local slots starts 4 ``train run`` workers of phase 8's data and the
   0.5B model at full width cut to 4 of its 8 layers, at pp 2 x vpp 2 x dp
   2 (each stage holds two round-robin chunks of one layer) with ZeRO-1,
   ``every_pipe_stage`` and accumulation 4 (micro-batch 1 a data rank),
   saving every 2 steps, sharing the card through gloo; activations and
   their gradients cross by the stage transport (a broadcast over a
   two-rank group a direction). Once the step-2 checkpoint is durable a
   one-rank child of the same model and global batch (micro-batch 2, the
   same remat mode) starts beside the four ranks and resumes it to step 4;
   rank 3 (the last stage of data rank 1) gets SIGTERM once its step-3
   record is written. Checks,
   each failing the phase: (a) the child's step-3 and step-4 losses within
   0.02 of the four ranks', all finite, and the pipelined backward of
   those steps against the child's from the same weights: the global
   gradient norm and each logical layer's Adam first moment (its norm
   over the ranks' pieces, each counted once) within a relative 0.01;
   (b) the probe row's logits of the
   four ranks' forward (the last stage's) at the step-4 weights within
   0.05 of max |logit| of a CPU f32 forward of the merged step-4
   checkpoint (constant logits cannot pass); (c) the step-2 launches of
   K2-K5 summed over the two stages of each data rank equal to the one-rank
   child's step-4 launches, no plain version on any rank; (d) every rank
   stops at step 4 and exits 0, ``latest`` names step 4, which verifies,
   and ``MESH.json`` of step 2 names pp 2 x vpp 2; (e) each rank's
   ``max_memory_allocated`` and parameter bytes printed beside the
   child's. Prints the transport's bytes a step beside the schedule's
   count, ``obs report``'s pipeline section over the four ranks' run
   directory (the predicted bubble) beside each rank's measured share of a
   step spent waiting for the transport (a reading: four ranks share one
   card), and the step times;
21. sequence splitting, beside phases 19 and 20 (``SPLIT``; its lines
   follow phase 20's; (a) and (b) start once every process of phase 19 has
   ended, for the card's memory): ``runner_main`` starts (a) 4 workers of phase 19's
   model and data at context_parallel_size 2 x dp 2, ring attention, ZeRO-1
   (micro-batch 2 a data rank, each context rank its 1024 tokens of each
   sequence) and (b) 2 workers at context_parallel_size 2, Ulysses
   attention, for 2 steps, both held to phase 19's one-rank run; and (c),
   started with phase 20's child once phase 20's step-2 checkpoint is
   durable, 2 workers of phase 20's model at pp 2 x pipe_token_slices 2
   with every_pipe_stage (micro-batch 2, accumulation 4: the child's global
   batch) that resume it to step 4, held to the child. Checks, each
   failing the phase: the losses of the run's steps within 0.02 of the
   reference's, all finite; the global gradient norm and each logical
   layer's Adam first moment (its norm over the ranks' pieces, each
   counted once) within a relative 0.01; K2-K5 a step against the layout's
   count from the reference's: each context rank launches K2/K3 as often as
   one rank, the ring no K4/K5 (unfused, as JAX's), Ulysses K4/K5 as often
   as one rank (the whole 2048-token sequence of 8 query and 2 kv heads),
   the two stages under S slices S times one rank's K2/K3 and no K4/K5
   (the slice cache is unfused in both packages); no plain version on any
   rank; the collective bytes of a step equal to their count from the
   shapes: the ring's K/V and segment hops and its f32 dK/dV hops,
   Ulysses's four all-to-alls a layer each way and its segment gather, the
   slice transport's hops (each 1/S of an unsliced micro-batch's). Prints
   each rank's ``max_memory_allocated`` beside the reference's and the
   step times;
22. ZeRO-3 and sequence parallelism, after phase 21 (a) and (b) (``ZERO3``;
   its lines follow phase 21's; its workers start once every process of 21
   (a) and (b) has ended, for the card's memory): ``runner_main`` starts 4
   workers of phase 19's model and data at dp 2 x mp 2 with ``zero: true,
   zero_stage: 3`` (each rank's
   parameters its data slice of its model slice, gathered over the data
   group at each use and released after it) and ``sequence_parallel: true``
   (the activations between the tensor-parallel regions are each model
   rank's 1024 tokens of the sequence), for 3 steps saving at step 2; each
   rank writes the probe row's logits at the save. Checks, each failing
   the phase: (a) the step-1 and step-2 losses within 0.02 of phase 19's
   one-rank run, all finite; (b) the global gradient norm and each logical
   layer's Adam first moment (its norm over the ranks' pieces, each counted
   once) within a relative 0.01 of that run's; (c) the merged step-2
   checkpoint's ``MESH.json`` names zero stage 3 and ``sequence_parallel``,
   and a CPU f32 forward of it matches the four ranks' probe-row logits
   within 0.05 of max |logit|; (d) K2-K5 in step 3 on each rank as often as
   the one-rank run's step, no plain version on any rank; (e) each rank's
   collective bytes in step 3 equal to their count from the shapes: the
   per-use parameter gathers (each sliced leaf in the forward, and again in
   the backward where autograd keeps it: the matrices but the embedding
   table, the norm gains), the f32 reduce-scatters of their gradients, and
   sequence parallelism's gathers and reduce-scatters (2L + 1 each way and
   direction); (f) each rank's parameter bytes at rest equal to their count
   from the shapes. Prints each rank's ``max_memory_allocated`` beside
   phase 19's ZeRO-1 rank and the tuner's prediction
   (``tune.costmodel.memory_gb_per_device``), and the step times, taken
   with four ranks sharing one card (not a scaling figure);

then print one ``{"kernels": [...]}`` line (K4 and K5 also with their
achieved ``tflops``: the bound's operations over the device time; K1 with
its achieved ``gbps``: the bound's bytes over the device time), the
card line, and as the last line ``{"ok": true, "device": {...}}``. Any
failure exits non-zero, and nothing is printed as a result without a card.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import importlib
import io
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

K1_ROWS, K1_S, K1_HEADS, K1_KV_HEADS, K1_HEAD_DIM = 16, 32, 16, 4, 128
K1_NUM_BLOCKS, K1_BLOCK_SIZE, K1_MAX_BLOCKS = 1024, 16, 128
K1_LONG_ROW = ((2048 - 32, 32),)  # one row: a 32-token chunk ending the 2048-slot window
# the separate decode forward's 16 rows at s = 1: an idle slot, a first
# decode, one at the 2048-slot window's end and 13 contexts of 1-2046
K1_DECODE_ROWS = ((0, 0), (0, 1), (2047, 1)) + tuple(
    (int(c), 1) for c in np.random.default_rng(5).integers(1, 2047, size=13))
# K4 in whole-prompt prefill: (bucket, prompt length), the bucket's pads in
# segment 1; the smallest bucket that launches K4 and phase 13's 1000-token prompt's
K4_PREFILLS = ((128, 100), (1024, 1000))
K2_SHAPES = ((512, 2048), (333, 2048))
KERNEL_TOL = 1e-2  # atol and rtol: bf16 outputs, one rounding apart
TICK_TOL = 0.05    # max |logit error| / max |logit|: bf16 through 8 layers vs f32
SERVE = dict(num_slots=16, block_size=16, num_blocks=1024, max_blocks_per_seq=128,
             prefill_chunk=32)
WORKLOAD = dict(n_requests=32, rate=64.0, prompt_len=(128, 1024),
                output_len=(64, 256), seed=0)
RECOMPUTE_TICK = 12  # which measured tick is recomputed with the plain versions
# the training path: bench.py's first rung on the 0.5B model
TRAIN_MBS, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 4, 2048, 3, 10
FLASH_SHAPE = dict(b=TRAIN_MBS, s=TRAIN_SEQ, n=16, n_kv=4, d=128)
FLASH_CASES = (  # name, packed documents, local heads, window
    ("causal", 1, 0, None), ("packed3", 3, 0, None), ("local4", 1, 4, 256))
K3_SHAPES = ((TRAIN_MBS * TRAIN_SEQ, 2048), (8191, 2048), (7, 8192), (3, 32768))
# (x, w) dtypes of K3's cases beyond bf16, at the training rows: an f32 gain, f16
K3_DTYPES = ((torch.bfloat16, torch.float32), (torch.float16, torch.float16))
FLASH_OUT_TOL = 1e-2    # atol and rtol: bf16 output, one rounding apart
LSE_TOL = 1e-3          # atol: f32 from the same bf16 products
FLASH_GRAD_TOL = 2e-2   # max |err| / max |ref|: P and dS enter the products as bf16
K3_DW_TOL = 1e-2        # max |err| / max |ref|: a bf16 dw summed over 8192 rows
TRAIN_LOGIT_TOL = 0.05  # max |logit error| / max |logit|: bf16 through 8 layers vs f32
# the Trainer: token datasets from seed 0, 6 iterations saving and evaluating at 3;
# phases 8-12 cut the model to 2 of its layers at full width, to keep the
# script's checkpoint I/O (~0.3 GB/s on an H100 host) inside its time limit
# (at 4 layers, with phase 14 added, a run on a slow host took 1233 s)
# the 0.5B model's parameters (495,110,144 at 8 layers): its embedding with
# its untied head, and one layer
PARAMS_05B = dict(embedding_and_head=134_217_728, layer=45_111_552)
TRAINER = dict(model="0.5b", layers=2, seq=TRAIN_SEQ, mbs=TRAIN_MBS, tokens=2_000_000,
               valid_tokens=64_000, doc_len=(64, 4096), iterations=6, interval=3,
               eval_iterations=2, serve_requests=4, serve_prompt=(64, 256), serve_output=32)
RESUME_RTOL = 1e-4  # steps 5-6 after the resume: the embedding backward adds with atomics
# phase 9: phase 8's run with the supervision keys on, in child processes; run
# A gets SIGTERM once its step-4 record is written, each child pausing after
# each logged step so that the signal lands within steps 4-5
SUPERVISE = dict(keys={"save_checkpoint_async": True, "dataloader_prefetch_factor": 2,
                       "step_timeout_seconds": 120, "max_consecutive_nonfinite": 2},
                 sigterm_after=4, pause_s=0.3, child_timeout_s=420)
# phase 11: phase 8's run under the supervisor, its SIGTERM once epoch 2's
# step-5 record is written. The timeouts are near twice the longest of what
# they budget on an H100 at 2 layers (this phase's own prints in six runs):
# a worker's longest gap between two heartbeats, a synchronous save with its
# eval, 7.6-10.7 s; its start to its first heartbeat, a verified load with
# it, 8.2-18.6 s. The hang is found once both have passed, ~20 s after it
# hangs (at 30 / 50 s it took 29-37 s; at 100 / 50 s 86.7 s). A hung worker
# runs its SIGTERM handler and goes on hanging, so its teardown waits the
# worker grace out, then SIGKILLs
RELAUNCH = dict(faults="host.kill=kill@5@epoch=0,host.hang=hang@2@epoch=1", drain_after=5,
                runner={"heartbeat_timeout_seconds": 20.0, "startup_grace_seconds": 35.0,
                        "restart_budget": 2, "restart_backoff_seconds": 0.25,
                        "worker_grace_seconds": 2.0, "supervisor_poll_seconds": 0.05},
                timeout_s=600, resume_timeout_s=300, free_tol=1 << 30)
# phase 12: a LoRA finetune of phase 8's step-6 checkpoint with dropout on, 6
# steps saving at 3 and 6; 2 steps with probability dropout; 8 served requests
FINETUNE = dict(lora={"name": "lora", "rank": 16, "alpha": 32, "dropout": 0.05},
                dropout=0.1, prob_dropout=0.1, iterations=6, interval=3, prob_steps=2,
                serve_requests=8, merge_tokens=1024, dropout_shape=(4, 2048, 2048))
REMAT_TOL = 1e-6  # the f32 LoRA masters after one step with and without remat (both modes)
MERGE_TOL = 0.05  # max |logit error| / max |logit|: merged bf16 on the card vs unmerged f32
EVAL_NATS = 0.05  # evaluate's loss on the step-6 checkpoint vs the trainer's step-6 eval loss
# evaluate vs the trainer's forward on its in-memory weights, same batches: they
# agree within 1.5e-7-2.2e-7 nats on an H100, and at 2 layers the step-3
# checkpoint, which must miss the limit, lies 7.5e-5 away (1e-4 could not tell it)
EVAL_REF_NATS = 1e-5
# generation: 8 prompts of 256-1024 tokens (the longest exactly 1024, so the
# left-padded prefill is 1024 wide and K4 runs), 128 greedy tokens each
# at 2 of the 8 layers, as phases 8-12 (a depth cut: phase 20's time came out
# of phases 6 and 15)
GEN = dict(batch=8, prompt_len=(256, 1024), max_tokens=128, seed=0, profile=(16, 48), layers=2)
GEN_LOGIT_TOL = 0.05  # max |logit error| / max |logit|: bf16 through the layers vs f32
# phase 10: a 5-step observed Trainer run, profiler window at steps 2-3; the
# repetitions of the host-cost measurement
# turns in mirrored order, so that a drift over the turns weighs on each kind
# alike; the serving turns, one of each kind, follow the checked run with a
# run directory (phase 18's room in the time limit)
OBSERVE = dict(iterations=5, profile=(2, 2), span_reps=200, telemetry_reps=50,
               serve_turns=("none", "stub", "run_dir"),
               train_turns=("stub", "no_events", "on", "on", "no_events", "stub"),
               turn_steps=3)
MFU_RTOL = 1e-6  # the telemetry's mfu vs the record's palm_mfu: one formula, two roundings
# where the reports, too long for the log, are kept; unset: nowhere
KEEP_DIR = os.environ.get("CHIP_SMOKE_REPORTS")
# phase 13: spec_k 4 on prompts of a 16-64-token segment repeated to 128-1024
# tokens; the fault drills' tick; the overload run at 4x phase 4's rate with a
# queue cap of 4; the watchdog at 5x the longest tick measured, 5 s at least
# (the longest tick of (a)-(c) was 0.16-0.45 s in six runs);
# the drain's arrivals at 8 req/s (at 64 they all arrive before a request can
# complete its 64 tokens, and a drain would find nothing left to refuse)
# (a) and (b) run on ``requests`` requests (the repeating traffic, and the
# first of phase 4's), (c)'s separate forwards on the first
# ``separate_requests`` (part of the time phase 19 costs came out of them:
# each still checks rates a tick, acceptance and equal tokens)
MODES = dict(spec_k=4, segment=(16, 64), seed=1, first_token_prompt=1000, fault_tick=40,
             requests=16, separate_requests=8,
             overload_x=4, max_waiting=4, min_tick_timeout_s=5.0, child_timeout_s=300,
             free_tol=1 << 30, drain_rate=8.0)
# phase 14: the serving fleet on one card. Workload F: 32 requests at 128
# req/s (each of two replicas sees phase 4's rate of 64), 4 families of a
# 256-token system prompt before 128-1024 random tokens, 64-256 output
# tokens; the
# kill at the 40th tick with work of replica 1; the drain's arrivals at 8
# req/s, its SIGTERM 2 s after both workers are ready
FLEET = dict(n_requests=32, rate=128.0, prompt_len=(128, 1024), output_len=(64, 256),
             shared_prefix_len=256, prefix_families=4, seed=0, replicas=2, kill_tick=40,
             drain_rate=8.0, drain_after_s=2.0, child_timeout_s=300, free_tol=1 << 30,
             heartbeat_timeout_s=10.0)
# phase 15: the 0.5B widths with 8 routed SwiGLU experts (top-2, capacity 1.25,
# aux 0.01) under muP from a 256-wide base (serve/bench.py MODELS["0.5b-moe"]).
# (a) one MoE layer at b 4, s 2048 in f32, card against CPU: the share of
# tokens routed alike (expert set and kept flags) and, on those, y within
# layer_tol of max |y| (f32 sums in another order: ~1e-6) and the aux loss
# within aux_rtol (a token whose top-1 flips moves it by ~1/(b s)); (b) phase
# 5's training and (c) phase 4's serving with routing captured on the card
# and on the CPU: at most flip_share of the (token, layer) decisions differ
MOE = dict(model="0.5b-moe", layer_shape=(4, 2048), route_agree=0.999, layer_tol=1e-4,
           aux_rtol=1e-3, flip_share=0.05, layers=2)
# phase 6: AtMan controls on the 0.5B model at a 4 x 1024 batch, both variants.
# Factor 1 against the uncontrolled unfused logits: bitwise under the
# log-additive variant (its offset is 0), within tol of max |logit| under the
# multiplicative one (each shifted score is rounded to bf16 once more, which
# the softmax cancels only in exact arithmetic: twice TICK_TOL; constant logits
# would sit near 0.5-1); factor 0 on position j: every earlier position
# bitwise the factor-1 run's (a causal query never sees j), the later ones moved
ATMAN = dict(batch=4, seq=1024, seed=2, token=300, tol=0.1, reps=3)
# phase 16: the last one-device model features at the 0.5B widths cut to 2
# layers. (a) a multimodal finetune, the ViT encoder at its defaults (768
# wide, 6 blocks, 12 heads; a 384 x 384 image gives 144 tokens), 2 seeded
# images a sample at 64 and 1024, micro-batch 4, seq 2048, 6 steps on one
# batch: the loss falls; the logits before the first image are bitwise the
# same under other images; (b) the CLIP backbones: RN50x16 forward and
# backward on 8 images, a CLIP ViT (a 7 x 7 grid drawn in the CLIPVisionModel
# layout, imported with its positions interpolated to 12 x 12) forward on 8,
# one image of each against the CPU in f32 within encoder_tol of max |y|
# (bf16 through 50 convolutions or 6 blocks); (c) 4 of 16 heads local with
# window 256: 4 prompts of 1024 tokens (K4 prefills them with its local
# heads), 128 greedy tokens, cached against use_cache=False, equal or parting
# first at a near tie; (d) phase 5's step (8 layers) without remat, with
# every_layer and with every_layer_save_dots: step ms, peak memory, launches
# (the tests run it on the CPU at toy size through ``model``, ``encoder``,
# ``resnet`` and ``vit``: an empty dict keeps the defaults)
FEATURES = dict(model="0.5b", layers=2, mbs=TRAIN_MBS, seq=TRAIN_SEQ, image_starts=(64, 1024),
                steps=6, lr=3e-4, seed=16, encoder={}, clip_images=8, resnet={}, vit={},
                clip_source_grid=7, encoder_tol=0.1, local_heads=4, window=256,
                local_prompts=4, local_prompt_len=1024, local_tokens=128, remat_model="0.5b",
                remat_steps=5)
# phase 17: the data, checkpoint and bench tooling at phase 8's model (the 0.5B
# widths cut to 2 layers). (a) ~2M tokens in each Megatron layout (MMIDIDX by the
# port's writer, TNTIDX by numpy), documents of 64-4096 tokens from seed 0, 3
# Trainer steps over their blend with legacy_dataset and only_full_sequences;
# (b) the pack builder over 2,000,000 document sizes of 16-8192 tokens from seed
# 0 (~8.2B tokens) at seq 2048, every_n 0 and 4, C++ against the plain loop;
# (c) phase 8's step-6 checkpoint exported, imported, served for 8 requests;
# (d) the restore's fault points on phase 8's steps 3 and 6; (e) the train
# bench's ladder at phase 5's model (8 layers) in a child process
TOOLING = dict(tokens=2_000_000, doc_len=(64, 4096), steps=3, pack_docs=2_000_000,
               pack_doc_len=(16, 8192), pack_every_n=(0, 4), serve_requests=8, model="0.5b",
               mbs_plan="4,8,16,32", ladder_steps=3, ladder_seq=TRAIN_SEQ,
               ladder_timeout_s=600)
# the bench 0.5B model in the JAX default architecture: its widths, other keys
# phase 18: the tuner and the dispatch audit on the card. (a) K1 alone at
# each block size the serving tuner searches, 20 profiled calls each; (b) the
# serving tuner's emitted config served for 16 requests of phase 4's
# traffic; (c) the training tuner over the train bench's micro-batch ladder
TUNE = dict(block_sizes=(8, 16, 32), reps=20, requests=16, ladder="4,8,16,32")
# phase 19: phase 8's model and data at dp 2 x mp 2 with ZeRO-1, four worker
# processes of ``runner_main`` sharing the one card through gloo; rank 3 gets
# SIGTERM once its step-3 record is written (each rank pausing after each
# step), so every rank stops and saves at step 4; a one-rank run of the same
# config beside it for steps 1-2, and a one-rank child, started with the
# SIGTERM, resuming the step-2 checkpoint to step 4; a probe row of 512
# tokens for the logits check
DIST = dict(dp=2, mp=2, steps=8, save_interval=2, sigterm_rank=3, sigterm_after=3,
            stop_step=4, ref_steps=2, pause_s=0.5, loss_tol=0.02, logit_tol=0.05,
            probe_tokens=512, timeout_s=420, script="chip_smoke")
# phase 20: phase 8's data and the 0.5B model at full width, 4 of its 8
# layers (pp * vpp = 4 needs 4), at pp 2 x vpp 2 x dp 2 with ZeRO-1,
# every_pipe_stage and accumulation 4, four worker processes of runner_main
# sharing the card through gloo; a one-rank child of the same model and
# global batch, started once the step-2 checkpoint is durable, resumes it to
# step 4; rank 3 gets SIGTERM once its step-3 record is written, so every
# rank stops and saves at step 4; phase 19's tolerances and probe row
PIPE = dict(pp=2, vpp=2, dp=2, layers=4, mbs=1, gas=4, steps=8, save_interval=2,
            sigterm_rank=3, sigterm_after=3, stop_step=4, pause_s=0.5, timeout_s=480,
            remat="every_pipe_stage", update_rtol=0.01)
# phase 21: sequence splitting. (a) ring at cp 2 x dp 2 with ZeRO-1 and (b)
# Ulysses at cp 2, phase 19's model, data and global batch, each held to
# phase 19's one-rank run (the same config from the same initialisation);
# (c) token slices at pp 2 x S 2 with every_pipe_stage, phase 20's model and
# global batch, resuming phase 20's step-2 checkpoint beside phase 20's
# one-rank child, and held to it; phase 19's and 20's tolerances
SPLIT = dict(cp=2, dp=2, steps=2, ts=2, timeout_s=480)
# phase 22: ZeRO-3 and sequence parallelism, phase 19's model, data and global
# batch at dp 2 x mp 2, 3 steps saving at step 2, held to phase 19's one-rank
# run; phase 19's and 20's tolerances
ZERO3 = dict(dp=2, mp=2, steps=3, save_interval=2, timeout_s=480)
DEFAULT_ARCH = dict(norm_type="layernorm", layernorm={"optimization_type": "torch"},
                    mlp_type="default", mlp_factor=4.0, activation_function="gelu",
                    weight_tying=True, key_query_norm=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs
def k1_inputs(gen: torch.Generator, quantized: bool, dev, contexts=None, s: int = K1_S,
              block_size: int = K1_BLOCK_SIZE):
    """Serving-shaped K1 operands: one mixed tick of 16 rows of width 32
    over a pool of 16384 slots (1024 blocks of 16), rows of every kind
    (idle, fresh decode, a short chunk, decode and chunk at the full
    2048-slot context); or, with ``contexts``, one row of width ``s`` per
    (context, new tokens) pair. ``block_size`` cuts the same pool and
    window into other blocks (phase 18 (a)); the draws are the same."""
    from scaling_tpu_torch.nn.attention import kv_quantize_int8

    rows = K1_ROWS if contexts is None else len(contexts)
    num_blocks = K1_NUM_BLOCKS * K1_BLOCK_SIZE // block_size
    max_blocks = K1_MAX_BLOCKS * K1_BLOCK_SIZE // block_size
    pool_shape = (num_blocks, block_size, K1_KV_HEADS, K1_HEAD_DIM)
    q = torch.randn(rows, s, K1_HEADS, K1_HEAD_DIM, generator=gen, device=dev)
    pk = torch.randn(pool_shape, generator=gen, device=dev)
    pv = torch.randn(pool_shape, generator=gen, device=dev)
    if contexts is None:
        ctx = torch.randint(0, 2048 - K1_S, (rows,), generator=gen, device=dev)
        new = torch.randint(1, K1_S + 1, (rows,), generator=gen, device=dev)
        fixed = [(0, 0), (0, 1), (0, 17), (2047, 1), (2048 - K1_S, K1_S)]
    else:
        ctx = torch.zeros(rows, dtype=torch.int64, device=dev)
        new = torch.zeros(rows, dtype=torch.int64, device=dev)
        fixed = contexts
    for row, (c, n) in enumerate(fixed):
        ctx[row], new[row] = c, n
    valid = ctx + new
    nblk = (valid + block_size - 1) // block_size
    table = torch.randint(1, num_blocks, (rows, max_blocks), generator=gen, device=dev)
    table = torch.where(torch.arange(max_blocks, device=dev)[None] < nblk[:, None],
                        table, 0)
    scales = {}
    if quantized:
        pk, sk = kv_quantize_int8(pk)
        pv, sv = kv_quantize_int8(pv)
        scales = dict(scale_k=sk, scale_v=sv)
    else:
        pk, pv = pk.bfloat16(), pv.bfloat16()
    args = (q.bfloat16(), pk, pv, table.int(), valid.int(), ctx.int())
    kw = dict(sm_scale=K1_HEAD_DIM ** -0.5, num_repeat_kv=K1_HEADS // K1_KV_HEADS,
              **scales)
    return args, kw


def k1_bound_ms(args, kw) -> tuple:
    """Least time for the work these inputs need: every visible K/V slot
    read once (plus q, tables, scales, and the output written once), and
    two dot products of head_dim per visible slot and query head."""
    q, pk, _, table, valid, base = args
    rows, s, n, h = q.shape
    n_kv = pk.shape[2]
    v = valid.long().cpu()
    b = base.long().cpu()
    kv_bytes = int(v.sum()) * n_kv * h * pk.element_size() * 2
    if "scale_k" in kw:
        kv_bytes += int(v.sum()) * n_kv * 4 * 2
    moved = (kv_bytes + 2 * q.numel() * q.element_size()
             + (table.numel() + 2 * rows) * 4)
    steps = torch.arange(s)
    visible = torch.minimum(v[:, None], b[:, None] + steps[None] + 1).clamp_min(0)
    flops = int(visible.sum()) * n * h * 2 * 2
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k2_bound_ms(x: torch.Tensor) -> tuple:
    d = x.shape[-1]
    moved = 2 * x.numel() * x.element_size() + d * x.element_size()
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 4 * x.numel() / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound(moved_bytes: float, flops: float) -> tuple:
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k3_bound_ms(x: torch.Tensor, need_dw: bool = True) -> tuple:
    """Read x, g and w, write dx and dw (dx alone without ``need_dw``): what
    the function needs, not the kernel's own f32 dw partials; about ten
    operations an element."""
    d = x.shape[-1]
    moved = 3 * x.numel() * x.element_size() + (2 if need_dw else 1) * d * x.element_size()
    return bound(moved, 10 * x.numel())


def flash_flops(b: int, s: int, n: int, d: int) -> int:
    """The causal forward's products over the pairs it needs (k <= q):
    2 products x 2 operations x d for each of b*n*s*(s+1)/2 pairs, about
    2*b*n*d*s^2 (the causal half of 4*b*n*d*s^2)."""
    return 4 * d * b * n * s * (s + 1) // 2


def k4_bound_ms(q, k) -> tuple:
    b, s, n, d = q.shape
    moved = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() + b * n * s * 4
    return bound(moved, flash_flops(b, s, n, d))


def k5_bound_ms(q, k) -> tuple:
    """Read q, k, v, out, dO and the lse; write dq, dk, dv. Five products
    (S, dP, dV, dK, dQ): 2.5x the forward's operations."""
    b, s, n, d = q.shape
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    moved = 4 * qb + 4 * kb + b * n * s * 4
    return bound(moved, 2.5 * flash_flops(b, s, n, d))


def time_ms(fn, reps: int = 20) -> tuple:
    """(device ms, launch ms) of one call of ``fn``. Device ms: the sum of
    the CUDA kernels and copies the call runs, from ``torch.profiler``
    (CUPTI), averaged over ``reps`` calls. The profiler now and then
    hands back no device events, or only some; it is asked up to 3 times,
    and only then do CUDA events around ``reps`` back-to-back calls stand
    in, which for a kernel shorter than its launch measure the host (a
    line says so).
    Launch ms: CUDA events around one call at a time (median), which for a
    small kernel is the host's launch cost, not the kernel's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    launch_ms = statistics.median(samples)
    parts = device_ms_by_kernel(fn, reps)
    if parts:
        return sum(parts.values()), launch_ms
    print("  (the profiler missed device events: CUDA events around back-to-back calls)")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, launch_ms


def device_ms_by_kernel(fn, reps: int = 20) -> dict:
    """Device ms one call of ``fn`` spends in each CUDA kernel or copy it
    runs, by short name (``torch.profiler``, CUPTI, over ``reps`` calls
    after ``reps`` traced and dropped: a window's first calls lose device
    events, and on an H100 a window without that step saw 15-19 of 20
    launches of each kernel). The profiler now and then hands back no
    device events, or only some of them: it is asked up to 3 times, and
    the result is empty if it never saw every call's."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        by_name = kernel_ms(prof.key_averages(), reps)
        if by_name:
            return by_name
    return {}


def kernel_ms(averages, reps: int) -> dict:
    """Device ms a call by kernel or copy short name, from ``key_averages()``
    over ``reps`` calls; empty when the events seen fewer than ``reps``
    times hold more than a tenth of the device time, the mark of a profile
    that dropped device events (on an H100 such a profile read K4 at 41 %
    of its time, above the card's peak rate). Each refusal prints the
    short-counted events."""
    by_name, launches = {}, Counter()
    for e in averages:
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            short = re.search(r"(\w+_kernel)", e.key)
            name = short.group(1) if short else e.key[:40]
            by_name[name] = by_name.get(name, 0.0) + us / reps / 1e3
            launches[name] += e.count
    short = {n: launches[n] for n in by_name if launches[n] < reps}
    if sum(by_name[n] for n in short) > 0.1 * sum(by_name.values()):
        print(f"  (a profile of {reps} calls saw these events fewer times: {short})")
        return {}
    return by_name


# ---------------------------------------------------------------- phases
def build_kernels() -> float:
    """Build every kernel of the serving and training paths; returns seconds."""
    from scaling_tpu_torch.ops import cuda_build, rms_norm

    t0 = time.monotonic()
    sources = ("paged_attention", "flash_attention", "rms_norm_bwd")
    for name in sources:
        cuda_build.start(name)  # one nvcc per source, all in the background
    dev = torch.device("cuda")
    for rows, d in K2_SHAPES + K3_SHAPES[:1]:  # Triton compiles at first launch
        x = torch.ones(rows, d, device=dev, dtype=torch.bfloat16)
        w = torch.ones(d, device=dev, dtype=torch.bfloat16)
        rms_norm(x, w, 1e-5)
    for name in sources:
        cuda_build.load(name)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    for name in sources:
        for r in kernel_resources(cuda_build.build_log(name)):
            print(f"  ptxas {name}: {r['kernel']} registers={r['registers']} "
                  f"spill={r['spill']} bytes, dynamic smem={r['smem']} bytes")
            if r["kernel"].startswith(("flash_", "paged_", "rms_")) and r["spill"] > 0:
                raise AssertionError(f"{r['kernel']} spills {r['spill']} bytes")
    return seconds


FLASH_SMEM_INDEX = {"flash_fwd_kernel": 0, "flash_bwd_dkdv_kernel": 1, "flash_bwd_dq_kernel": 2}
K3_DTYPE_NAMES = ("f32", "bf16", "f16")  # the dtype codes of csrc/rms_norm_bwd.cu


def kernel_resources(log: str) -> list:
    """Each entry function of a ``ptxas -v`` log: its short name, registers
    and spill bytes (stores + loads); for a flash kernel, also the dynamic
    shared memory its launcher requests (0 where it requests none), and for
    K3 the most its ring takes at the training rows' dtypes (its x and g
    dtypes and variant in the label)."""
    from scaling_tpu_torch.ops.flash_attention import _library
    from scaling_tpu_torch.ops.rms_norm import plan_bwd

    rows = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            kernel = re.search(r"((?:flash|paged|rms_norm_bwd)_[a-z_]*kernel)I", mangled)
            dim = re.search(r"Li(\d+)E", mangled)
            name = kernel.group(1) if kernel else mangled
            k3 = re.search(r"ILi(\d)ELi(\d)ELb([01])E", mangled)
            if name == "rms_norm_bwd_kernel" and k3:
                xt, gt = (K3_DTYPE_NAMES[int(k3.group(i))] for i in (1, 2))
                label = f"x {xt}, g {gt}, " + ("dx and dw" if k3.group(3) == "1" else "dx only")
            else:
                label = f"{dim.group(1)}, int8" if dim and "Lb1E" in mangled else (
                    dim.group(1) if dim else None)
            rows.append({"kernel": f"{name}<{label}>" if label else name, "spill": 0,
                         "registers": None, "smem": 0})
            if name in FLASH_SMEM_INDEX and dim:
                rows[-1]["smem"] = _library().flash_attention_smem_bytes(
                    int(dim.group(1)), FLASH_SMEM_INDEX[name])
            if name == "rms_norm_bwd_kernel" and k3:
                rows_k3, d = K3_SHAPES[0]
                sizes = [4 if int(k3.group(i)) == 0 else 2 for i in (1, 2)]
                rows[-1]["smem"] = plan_bwd(rows_k3, d, *sizes, 132).smem_bytes
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and rows:
            rows[-1]["spill"] = int(spill.group(1)) + int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and rows:
            rows[-1]["registers"] = int(regs.group(1))
    if not rows:
        raise AssertionError("no ptxas -v lines in the build log")
    return rows


def check_kernels(device: str = "cuda") -> dict:
    """Each kernel against its plain version at serving shapes: K1 in the
    mixed tick, on one 2048-slot row and in the separate decode forward's
    rows at s = 1; K2; K4 in whole-prompt prefills. On the CPU each wrapper
    runs its plain version, which checks the cases' inputs alone."""
    from scaling_tpu_torch.ops import (
        flash_attention_fwd,
        flash_attention_plain,
        paged_attention,
        paged_attention_plain,
        rms_norm,
        rms_norm_plain,
    )

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    errs = {}
    for name, quantized in (("paged_attention", False), ("paged_attention_int8", True)):
        errs[name] = 0.0
        for case, contexts, s in (("serving tick", None, K1_S),
                                  ("one 2048-slot row", K1_LONG_ROW, K1_S),
                                  ("decode rows at s = 1", K1_DECODE_ROWS, 1)):
            args, kw = k1_inputs(gen, quantized, dev, contexts, s)
            out = paged_attention(*args, **kw)
            again = paged_attention(*args, **kw)
            ref = paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"{name} {case}: non-finite output")
            if not bool((out[args[4] == 0] == 0).all()):
                raise AssertionError(f"{name} {case}: a valid_len 0 row is not zeros")
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {case}: repeats differ")
            err = (out.float() - ref.float()).abs().max().item()
            errs[name] = max(errs[name], err)
            print(f"  {name} {case}: max_abs_err={err:.3e} (atol=rtol={KERNEL_TOL}); "
                  "repeats bitwise equal")
            torch.testing.assert_close(out.float(), ref.float(), atol=KERNEL_TOL,
                                       rtol=KERNEL_TOL)
    err = 0.0
    for rows, d in K2_SHAPES:
        x = torch.randn(rows, d, generator=gen, device=dev).bfloat16()
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
        out, ref = rms_norm(x, w, 1e-5), rms_norm_plain(x, w, 1e-5)
        torch.cuda.synchronize()
        err = max(err, (out.float() - ref.float()).abs().max().item())
        torch.testing.assert_close(out.float(), ref.float(), atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)
    errs["rms_norm"] = err
    print(f"  rms_norm {K2_SHAPES}: max_abs_err={err:.3e} (atol=rtol={KERNEL_TOL})")
    errs["flash_attention_fwd"] = 0.0
    for bucket, prompt_len in K4_PREFILLS:
        q, k, v, seg = prefill_inputs(gen, bucket, prompt_len, dev)
        out, lse = flash_attention_fwd(q, k, v, seg)
        ref, ref_lse = flash_attention_plain(q, k, v, seg)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], err)
        print(f"  flash_attention_fwd whole-prompt prefill, bucket {bucket} ({prompt_len} "
              f"tokens, {bucket - prompt_len} pads in segment 1): out max_abs_err={err:.3e} "
              f"(atol=rtol={KERNEL_TOL}) lse max_abs_err={lse_err:.3e} (atol {LSE_TOL})")
        torch.testing.assert_close(out.float(), ref.float(), atol=KERNEL_TOL, rtol=KERNEL_TOL)
        torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
    return errs


def flash_inputs(gen, documents: int, dev):
    """Training-shaped K4/K5 operands: q already scaled (the wrapper's job),
    k and v unrepeated, segment ids of ``documents`` packed documents."""
    b, s, n, n_kv, d = (FLASH_SHAPE[k] for k in ("b", "s", "n", "n_kv", "d"))
    q = (torch.randn(b, s, n, d, generator=gen, device=dev) * d ** -0.5).bfloat16()
    k = torch.randn(b, s, n_kv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, n_kv, d, generator=gen, device=dev).bfloat16()
    seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
    for cut in sorted(torch.randint(1, s, (documents - 1,), generator=gen, device=dev).tolist()):
        seg[:, cut:] += 1
    return q, k, v, seg


def prefill_inputs(gen, bucket: int, prompt_len: int, dev):
    """K4's operands in one whole-prompt prefill of the serving model: one
    row of the bucket's width, q already scaled, the prompt in segment 0
    and the bucket's pads in segment 1."""
    n, n_kv, d = (FLASH_SHAPE[k] for k in ("n", "n_kv", "d"))
    q = (torch.randn(1, bucket, n, d, generator=gen, device=dev) * d ** -0.5).bfloat16()
    k = torch.randn(1, bucket, n_kv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(1, bucket, n_kv, d, generator=gen, device=dev).bfloat16()
    seg = (torch.arange(bucket, device=dev) >= prompt_len).to(torch.int32)[None]
    return q, k, v, seg


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def check_k3(x, w, g, kernel, plain) -> float:
    """Both K3 variants against the plain version on one case: dx within
    KERNEL_TOL, dw within K3_DW_TOL of its largest value, each output equal
    to itself on a repeat, and the dx-only variant's dx the full one's.
    Returns dx's max |error|."""
    (dx, dw), (dx2, dw2) = kernel(x, w, g, 1e-5), kernel(x, w, g, 1e-5)
    (dx_only, none), (dx_only2, _) = (kernel(x, w, g, 1e-5, need_dw=False),
                                      kernel(x, w, g, 1e-5, need_dw=False))
    ref_dx, ref_dw = plain(x, w, g, 1e-5)
    torch.cuda.synchronize()
    case = f"{tuple(x.shape)} x {str(x.dtype)[6:]} w {str(w.dtype)[6:]}"
    if none is not None or dx.dtype != x.dtype or dw.dtype != w.dtype:
        raise AssertionError(f"rms_norm_bwd {case}: outputs {dx.dtype} {dw.dtype} {none}")
    if not (torch.equal(dw, dw2) and torch.equal(dx, dx2) and torch.equal(dx_only, dx_only2)):
        raise AssertionError(f"rms_norm_bwd {case}: repeats differ")
    if not torch.equal(dx_only, dx):
        raise AssertionError(f"rms_norm_bwd {case}: the dx-only variant's dx differs")
    torch.testing.assert_close(dx.float(), ref_dx.float(), atol=KERNEL_TOL, rtol=KERNEL_TOL)
    dx_err = (dx.float() - ref_dx.float()).abs().max().item()
    dw_err = rel_err(dw, ref_dw)
    print(f"  rms_norm_bwd {case}: dx max_abs_err={dx_err:.3e} (atol=rtol={KERNEL_TOL}) "
          f"dw max_err/max|dw|={dw_err:.3e} (tol {K3_DW_TOL}); repeats bitwise equal, "
          "dx-only's dx the same bits")
    if not dw_err <= K3_DW_TOL:
        raise AssertionError(f"rms_norm_bwd {case}: dw disagrees: {dw_err}")
    return dx_err


def check_training_kernels() -> dict:
    """K2, K3, K4 and K5 against their plain versions at training shapes;
    K5's gradients and K3's outputs must repeat bitwise."""
    from scaling_tpu_torch.ops import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
        rms_norm,
        rms_norm_bwd,
        rms_norm_bwd_plain,
        rms_norm_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    errs = {"rms_norm": 0.0, "rms_norm_bwd": 0.0, "flash_attention_fwd": 0.0,
            "flash_attention_bwd": 0.0}
    for rows, d in K3_SHAPES:
        x = (3 * torch.randn(rows, d, generator=gen, device=dev)).bfloat16()
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
        g = torch.randn(rows, d, generator=gen, device=dev).bfloat16()
        if d == 2048:  # K2 at the training rows (the model's width)
            y, y_ref = rms_norm(x, w, 1e-5), rms_norm_plain(x, w, 1e-5)
            torch.cuda.synchronize()
            errs["rms_norm"] = max(errs["rms_norm"],
                                   (y.float() - y_ref.float()).abs().max().item())
            print(f"  rms_norm ({rows}, {d}): max_abs_err={errs['rms_norm']:.3e} "
                  f"(atol=rtol={KERNEL_TOL})")
            torch.testing.assert_close(y.float(), y_ref.float(), atol=KERNEL_TOL,
                                       rtol=KERNEL_TOL)
        cases = [(x, w, g)]
        if (rows, d) == K3_SHAPES[0]:
            cases += [(x.to(xt), w.to(wt), g.to(xt)) for xt, wt in K3_DTYPES]
        for xc, wc, gc in cases:
            dx_err = check_k3(xc, wc, gc, rms_norm_bwd, rms_norm_bwd_plain)
            errs["rms_norm_bwd"] = max(errs["rms_norm_bwd"], dx_err)
    for name, documents, n_local, window in FLASH_CASES:
        q, k, v, seg = flash_inputs(gen, documents, dev)
        out, lse = flash_attention_fwd(q, k, v, seg, n_local, window)
        ref_out, ref_lse = flash_attention_plain(q, k, v, seg, n_local, window)
        torch.cuda.synchronize()
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"  flash_attention_fwd {name}: out max_abs_err={out_err:.3e} "
              f"(atol=rtol={FLASH_OUT_TOL}) lse max_abs_err={lse_err:.3e} (atol {LSE_TOL})")
        torch.testing.assert_close(out.float(), ref_out.float(), atol=FLASH_OUT_TOL,
                                   rtol=FLASH_OUT_TOL)
        torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
        dout = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
        grads = flash_attention_bwd(q, k, v, out, lse, dout, seg, n_local, window)
        again = flash_attention_bwd(q, k, v, out, lse, dout, seg, n_local, window)
        refs = flash_attention_bwd_plain(q, k, v, out, lse, dout, seg, n_local, window)
        torch.cuda.synchronize()
        gerrs, gabs = {}, 0.0
        for gname, got, rep, ref in zip(("dq", "dk", "dv"), grads, again, refs):
            if not torch.equal(got, rep):
                raise AssertionError(f"flash_attention_bwd {name}: {gname} repeats differ")
            gerrs[gname] = rel_err(got, ref)
            gabs = max(gabs, (got.float() - ref.float()).abs().max().item())
        print(f"  flash_attention_bwd {name}: max_err/max|ref| "
              + " ".join(f"{g}={e:.3e}" for g, e in gerrs.items())
              + f" (tol {FLASH_GRAD_TOL}); repeats bitwise equal")
        if not max(gerrs.values()) <= FLASH_GRAD_TOL:
            raise AssertionError(f"flash_attention_bwd {name} disagrees: {gerrs}")
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], out_err)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], gabs)
        del q, k, v, out, lse, ref_out, ref_lse, dout, grads, again, refs
        torch.cuda.empty_cache()
    return errs


def cpu_f32_copy(inf):
    """The inference module's weights in f32 on the CPU, where its layers
    run the kernels' plain versions."""
    from scaling_tpu_torch.models.transformer import TransformerInferenceModule

    arch32 = dataclasses.replace(inf.architecture, precision="float32")
    state = {k: v.float().cpu() for k, v in inf.model.state_dict().items()}
    return TransformerInferenceModule.from_state_dict(arch32, state, device="cpu")


def recompute_on_cpu(inf, captured) -> dict:
    """The captured tick once more on the CPU in f32, through the plain
    versions, from the pool copy taken before the card ran it. A MoE
    model's routing is captured on the CPU too and held against the card's
    (``routing_flips``); the logit error is then taken over the rows whose
    sampled position was routed alike in every layer."""
    from scaling_tpu_torch.serve.kvcache import PagedKVPools

    cpu_inf = cpu_f32_copy(inf)
    pools, inp, card_logits, card_routing = captured
    cpu_pools = PagedKVPools(*[
        None if p is None else [t.cpu() for t in p]
        for p in (pools.pool_k, pools.pool_v, pools.scale_k, pools.scale_v)
    ], block_size=pools.block_size)
    width = inp.tokens.shape[1]
    tokens, ctx = torch.from_numpy(inp.tokens), torch.from_numpy(inp.ctx)
    new_lens = torch.from_numpy(inp.new_lens)
    pos = ctx[:, None] + torch.arange(width, dtype=torch.int32)
    gather = (new_lens - 1).clamp(0, width - 1)
    cpu_routing = []
    with routing_recorder(cpu_inf.model, cpu_routing):
        logits = cpu_inf._run_layers(
            cpu_inf._make_batch(tokens, pos),
            cpu_pools.views(torch.from_numpy(inp.tables), ctx, new_lens),
            gather_start=gather, gather_width=1,
        )
    card = card_logits.float().cpu()
    flips, alike = routing_flips(card_routing, cpu_routing, tokens.shape)
    rows = alike.gather(1, gather.long()[:, None])[:, 0]
    diff = (card - logits).abs().flatten(1).amax(-1)
    return {"err": diff[rows].max().item() if rows.any() else math.inf,
            "scale": logits.abs().max().item(),
            "agree": (card.argmax(-1) == logits.argmax(-1)).float().mean().item(),
            "flips": flips, "rows": rows.float().mean().item()}


def profile_ticks(engine, vocab: int, n_ticks: int = 30) -> dict:
    """Where a steady tick's time goes: 16 requests of 256-512 prompt
    tokens, ``n_ticks`` ticks traced with ``torch.profiler`` (device
    activity only, to keep the tracer's host cost low) after 8 ticks of
    warm-up. Device busy time is the sum of the kernels' device time
    (one stream: they do not overlap); the idle share is the rest of the
    host's wall clock over those ticks."""
    from torch.profiler import ProfilerActivity, profile

    from scaling_tpu_torch.serve.bench import sample_workload

    for _, prompt, olen in sample_workload(16, 1000.0, (256, 512), (64, 64), vocab, 5):
        engine.submit(prompt, olen)
    for _ in range(8):
        engine.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n_ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    engine.run_until_done()
    groups = {"paged_attention": 0.0, "rms_norm": 0.0, "gemm": 0.0, "other": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        name = e.key.lower()
        if "paged_attention" in name:
            groups["paged_attention"] += us
        elif "rms_norm" in name:
            groups["rms_norm"] += us
        elif any(k in name for k in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    busy_ms = sum(groups.values()) / 1e3
    return {
        "tick_ms": wall_ms / n_ticks,
        "device_busy_ms_per_tick": busy_ms / n_ticks,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_per_tick": {k: v / 1e3 / n_ticks for k, v in groups.items()},
    }


def serve(kv_dtype: str, model: str = "0.5b", audit: bool = False) -> dict:
    """The 0.5B model through the engine, counters reset just before the
    measured run and read just after; the forward shapes of the run are
    recorded (phase 18 (d)), and with ``audit`` one more tick after it runs
    under the dispatch audit (``audit_tick``). A MoE model (phase 15) has
    the recomputed tick's routing captured on the card and held against
    the CPU's."""
    from scaling_tpu_torch.analysis.dispatch_audit import record_forward_shapes
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import build_inference, run_bench, sample_workload

    dev = torch.device("cuda")
    inf = build_inference(model, seed=0, device=dev)
    n_params = sum(p.numel() for p in inf.model.parameters())
    engine = ServeEngine(inf, EngineConfig(kv_dtype=kv_dtype, **SERVE), device=dev)
    engine.submit(list(range(1, 41)), 4)  # warm-up request, off the books
    engine.run_until_done()

    captured = {}
    forward = engine._forward_mixed
    calls = [0]

    def capture(inp):
        calls[0] += 1
        if calls[0] != RECOMPUTE_TICK:
            return forward(inp)
        snapshot = type(engine.pools)(*[
            None if p is None else [t.clone() for t in p]
            for p in (engine.pools.pool_k, engine.pools.pool_v,
                      engine.pools.scale_k, engine.pools.scale_v)
        ], block_size=engine.pools.block_size)
        routing = []
        with routing_recorder(inf.model, routing):
            logits, sampled = forward(inp)
        captured["tick"] = (snapshot, inp, logits.clone(), routing)
        return logits, sampled

    engine._forward_mixed = capture
    work = sample_workload(WORKLOAD["n_requests"], WORKLOAD["rate"],
                           WORKLOAD["prompt_len"], WORKLOAD["output_len"],
                           inf.architecture.vocab_size, WORKLOAD["seed"])
    launches.reset()
    with record_forward_shapes(engine) as shapes:
        stats = run_bench(engine, work)
    torch.cuda.synchronize()
    kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    engine._forward_mixed = forward
    stats["forward_shapes"] = sorted(shapes)

    finished = {s.request.req_id: s for s in engine.finished}
    for i, (_, _, olen) in enumerate(work):
        seq = finished.get(i + 1)  # id 0 was the warm-up request
        if seq is None or len(seq.generated) != olen or seq.finish_status != "completed":
            raise AssertionError(f"{kv_dtype}: request {i} did not complete {olen} tokens")
    stats["tokens"] = {i: list(finished[i + 1].generated) for i in range(len(work))}
    paged = "paged_attention_int8" if kv_dtype == "int8" else "paged_attention"
    if kernel.get(paged, 0) <= 0 or kernel.get("rms_norm", 0) <= 0:
        raise AssertionError(f"{kv_dtype}: kernels not launched on the main path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"{kv_dtype}: plain versions ran on the card: {plain}")
    rec = recompute_on_cpu(inf, captured["tick"])
    err, scale, agree = rec["err"], rec["scale"], rec["agree"]
    print(f"  {kv_dtype}: params={n_params} requests={stats['completed']}/"
          f"{stats['requests']} ticks={stats['ticks']} preemptions={stats['preemptions']} "
          f"wall={stats['wall_s']:.3f}s")
    print(f"  {kv_dtype}: output tokens/s={stats['tokens_per_s']:.1f} "
          f"ttft p50={stats['ttft_p50_s']:.4f}s p99={stats['ttft_p99_s']:.4f}s "
          f"itl p50={stats['itl_p50_s']:.4f}s p99={stats['itl_p99_s']:.4f}s")
    print(f"  {kv_dtype}: launches kernel={kernel} plain={plain} "
          f"per tick: {paged}={kernel[paged] / stats['ticks']:.2f} "
          f"rms_norm={kernel['rms_norm'] / stats['ticks']:.2f}")
    print(f"  {kv_dtype}: tick {RECOMPUTE_TICK} recomputed on CPU f32: "
          f"max_abs_err={err:.4e} max|logit|={scale:.4e} "
          f"(tol {TICK_TOL} x max|logit|) argmax agreement={agree:.3f}")
    if inf.architecture.is_moe:
        print(f"  {kv_dtype}: the tick's routing, card vs cpu: {rec['flips']:.4f} of the "
              f"(token, layer) decisions differ (tol {MOE['flip_share']}); the logit error "
              f"is over the {rec['rows']:.3f} of the rows whose sampled position was routed "
              "alike in every layer")
        if not rec["flips"] <= MOE["flip_share"]:
            raise AssertionError(f"{kv_dtype}: the tick's routing disagrees: {rec}")
    if not err <= TICK_TOL * scale:
        raise AssertionError(f"{kv_dtype}: tick recompute disagrees: {err} > {TICK_TOL * scale}")
    prof = profile_ticks(engine, inf.architecture.vocab_size)
    print(f"  {kv_dtype}: steady ticks (torch.profiler): tick={prof['tick_ms']:.3f}ms "
          f"device busy={prof['device_busy_ms_per_tick']:.3f}ms "
          f"idle share={prof['device_idle_share']:.3f} device ms/tick by kernel: "
          + " ".join(f"{k}={v:.3f}" for k, v in prof["device_ms_per_tick"].items()))
    if audit:
        stats["tick_audit"] = audit_tick(engine, inf.architecture.vocab_size)
    stats["launches"] = kernel
    del engine, inf
    torch.cuda.empty_cache()
    return stats


def routing_decisions(layer, x: torch.Tensor) -> torch.Tensor:
    """Each token's routing by a MoE layer, on the CPU: its ``top_k``
    experts in ascending order and whether each kept its slot, (b, s, 2k)."""
    from scaling_tpu_torch.nn.moe import capacity

    with torch.no_grad():
        _, experts, positions, _ = layer.route(x, with_aux=False)
    kept = positions < capacity(layer.capacity_factor, layer.top_k, x.shape[1],
                                layer.num_experts)
    experts, order = experts.sort(dim=-1)
    return torch.cat([experts, kept.gather(-1, order).long()], dim=-1).cpu()


@contextlib.contextmanager
def routing_recorder(model, out: list):
    """While open, each forward of a MoE layer of ``model`` appends its
    ``routing_decisions`` to ``out`` (in layer order); no-op for a dense
    model."""
    from scaling_tpu_torch.nn.moe import ParallelMoEMLP

    hooks = [m.register_forward_hook(lambda mod, args, _: out.append(
        routing_decisions(mod, args[0]))) for m in model.modules()
        if isinstance(m, ParallelMoEMLP)]
    try:
        yield out
    finally:
        for h in hooks:
            h.remove()


def routing_flips(card: list, cpu: list, shape) -> tuple:
    """(share of the (token, layer) decisions that differ, (b, s) mask of
    the positions routed alike in every layer)."""
    if not card:
        return 0.0, torch.ones(shape, dtype=torch.bool)
    same = torch.stack([(a == b).all(-1) for a, b in zip(card, cpu)])
    return 1.0 - same.float().mean().item(), same.all(0)


def recompute_train_row(module, batch) -> dict:
    """The first row of the first micro-batch, before any update, on the
    card (bf16, the kernels) and on the CPU in f32 through the plain
    versions, from a copy of the weights. One row, not the micro-batch's
    four: the CPU's f32 forward of the 0.5B model costs ~2 TFLOP a row.

    The logits are compared, not the loss: at random weights the loss sits
    near ln(vocab) whatever the forward does. ``err`` is max |card - cpu|
    over max |cpu|; ``uniform_err`` is the least ``err`` a forward giving
    each position constant logits could reach (half the widest row's range),
    which the tolerance must stay below for the check to tell. For a MoE
    model the routing of each layer is captured on both sides: ``flips`` is
    the share of (token, layer) decisions that differ, and ``err`` is taken
    over the positions routed alike in every layer (``alike``, their
    share)."""
    from scaling_tpu_torch.models.transformer import TransformerModel, loss_function
    from scaling_tpu_torch.parallel import ParallelModule

    row = {k: v[0, :1] for k, v in batch.items()}
    card_routing, cpu_routing = [], []
    with torch.no_grad():
        with routing_recorder(module.model, card_routing):
            card_out = module.forward(row)
        card_loss = loss_function(card_out, row)[0].item()
        card = card_out["activations"].float().cpu()
        del card_out
        arch32 = dataclasses.replace(module.model.architecture, precision="float32")
        cpu_model = TransformerModel(arch32, device="cpu")
        cpu_model.load_state_dict({k: v.float().cpu() for k, v in
                                   module.model.state_dict().items()})
        cpu_module = ParallelModule(cpu_model, module.topology)
        cpu_row = {k: v.cpu() for k, v in row.items()}
        with routing_recorder(cpu_model, cpu_routing):
            cpu_out = cpu_module.forward(cpu_row)
        cpu_loss = loss_function(cpu_out, cpu_row)[0].item()
        cpu = cpu_out["activations"]
        del cpu_model, cpu_module
    scale = cpu.abs().max().item()
    # a MoE model: positions routed otherwise on the card take other experts
    flips, alike = routing_flips(card_routing, cpu_routing, cpu.shape[:2])
    return {
        "card_loss": card_loss, "cpu_loss": cpu_loss, "scale": scale,
        "err": ((card - cpu).abs().amax(-1)[alike].max().item() / scale if alike.any()
                else math.inf),
        "uniform_err": ((cpu.amax(-1) - cpu.amin(-1)) / 2).max().item() / scale,
        "agree": (card.argmax(-1) == cpu.argmax(-1)).float().mean().item(),
        "flips": flips, "alike": alike.float().mean().item(),
    }


TRAIN_GROUPS = (("flash_fwd", ("flash_fwd",)), ("flash_bwd", ("flash_bwd",)),
                ("rms_fwd", ("rms_norm_fwd",)), ("rms_bwd", ("rms_norm_bwd_kernel",)),
                ("gemm", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
                ("optimizer_foreach", ("multi_tensor_apply", "foreach")))


# a MoE step's routing and dispatch: the router's sort and one-hots, the
# position scan, the buffer's scatter and gathers and their backward
MOE_GROUPS = (("moe_routing", ("sort", "scatter", "gather", "index", "scan", "softmax",
                               "one_hot", "argmax", "cumsum")),)


def profile_train_step(step, batch, extra_groups=()) -> dict:
    """One training step under ``torch.profiler`` (device activity only):
    the device's busy time (the kernels' sum; one stream), its idle share
    of the host's wall clock, and the device time by kernel group
    (``extra_groups`` after phase 5's)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kinds = TRAIN_GROUPS + tuple(extra_groups)
    groups = {name: 0.0 for name, _ in kinds}
    groups["other"] = 0.0
    other = []
    for e in prof.key_averages():
        ms = (getattr(e, "self_device_time_total", 0) or 0) / 1e3
        key = e.key.lower()
        group = next((g for g, pats in kinds if any(p in key for p in pats)), "other")
        groups[group] += ms
        if group == "other" and ms > 0:
            other.append((ms, e.count, e.key[:90]))
    busy = sum(groups.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms, "device_ms": groups,
            "top_other": sorted(other, reverse=True)[:8]}


def check_train_row(rec: dict, moe: bool, seconds: float = 0.0) -> None:
    """Print ``recompute_train_row``'s result and hold it to its limits."""
    print(f"  first row before any update, card bf16 vs cpu f32 (plain versions): logits "
          f"max_abs_err={rec['err'] * rec['scale']:.4e} max|logit|={rec['scale']:.4e} "
          f"err/max|logit|={rec['err']:.3e} (tol {TRAIN_LOGIT_TOL}; constant logits would "
          f"give >= {rec['uniform_err']:.3e}) argmax agreement={rec['agree']:.3f}; "
          f"loss card={rec['card_loss']:.5f} cpu={rec['cpu_loss']:.5f} ({seconds:.1f}s)")
    if moe:
        print(f"  routing of the row, card vs cpu: {rec['flips']:.4f} of the (token, layer) "
              f"decisions differ (tol {MOE['flip_share']}); the logit error is over the "
              f"{rec['alike']:.4f} of the positions routed alike in every layer")
        if not rec["flips"] <= MOE["flip_share"]:
            raise AssertionError(f"train routing disagrees with the CPU's: {rec}")
    if not rec["uniform_err"] > TRAIN_LOGIT_TOL:
        raise AssertionError(f"constant logits would pass the logit check: {rec}")
    if not rec["err"] <= TRAIN_LOGIT_TOL:
        raise AssertionError(f"train logits recompute disagrees: {rec}")


def train(model: str = "0.5b") -> dict:
    """The 0.5B training step (bench.py's first rung), counters reset just
    before the warm-up and timed steps and read just after. A MoE model
    (phase 15) also has its routing held against the CPU's, its aux loss
    printed at each step, its MFU counted twice and its routing and
    dispatch ops timed as a group of their own."""
    from scaling_tpu_torch.models.transformer import loss_function
    from scaling_tpu_torch.models.transformer.utils.get_tflops import (
        get_model_parameter_count,
        get_palm_mfu,
        moe_parameter_counts,
    )
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.train.bench import build, synth_batch

    dev = torch.device("cuda")
    config, module, optimizer = build(model, TRAIN_SEQ, TRAIN_MBS, device=dev, seed=0)
    arch = config.transformer_architecture
    n_params = sum(p.numel() for p in module.model.parameters())
    step = module.build_train_step(optimizer, loss_function)
    batch = synth_batch(np.random.default_rng(0), TRAIN_MBS, TRAIN_SEQ, arch.vocab_size, 1, dev)
    t0 = time.monotonic()
    check_train_row(recompute_train_row(module, batch), arch.is_moe, time.monotonic() - t0)

    launches.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    outs = [step(batch)[:2] for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    outs += [step(batch)[:2] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize(dev)
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [float(loss) for loss, _ in outs]
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    needed = ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd")
    if any(kernel.get(k, 0) <= 0 for k in needed):
        raise AssertionError(f"training kernels not launched on the main path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"plain versions ran on the card in training: {plain}")
    tokens_per_s = TRAIN_MBS * TRAIN_SEQ / step_s
    counts = (moe_parameter_counts(module.model) if arch.is_moe else
              (get_model_parameter_count(arch.hidden_size, arch.num_layers, arch.vocab_size,
                                         arch.mlp_factor, glu=True),))
    mfu = [get_palm_mfu(n, arch.num_layers, arch.hidden_size, arch.sequence_length,
                        tokens_per_s) for n in counts]
    mfu_text = (f"mfu={mfu[0]:.4f}" if len(mfu) == 1 else
                f"mfu={mfu[0]:.4f} (6N + 12LHS, N all {counts[0]} parameters) "
                f"mfu={mfu[1]:.4f} (N the {counts[1]} a token's work touches)")
    print(f"  params={n_params} mbs={TRAIN_MBS} seq={TRAIN_SEQ} steps={TRAIN_WARMUP} warm-up "
          f"+ {TRAIN_STEPS} timed: step={step_s * 1e3:.2f}ms tokens/s={tokens_per_s:.1f} "
          f"{mfu_text} peak max_memory_allocated={peak_gb:.2f}GB")
    print(f"  losses: first={losses[0]:.5f} last={losses[-1]:.5f} all finite")
    if arch.is_moe:
        aux = [float(metrics["moe_aux_loss"]) for _, metrics in outs]
        print("  moe_aux_loss by step: " + " ".join(f"{a:.6f}" for a in aux))
        if not all(np.isfinite(aux)) or min(aux) <= 0:
            raise AssertionError(f"moe_aux_loss not finite and positive: {aux}")
    print(f"  launches kernel={kernel} plain={plain} per step: "
          + " ".join(f"{k}={kernel[k] / n_steps:.2f}" for k in needed))
    prof = profile_train_step(step, batch, MOE_GROUPS if arch.is_moe else ())
    print(f"  profiled step (torch.profiler): wall={prof['wall_ms']:.3f}ms device busy="
          f"{prof['device_busy_ms']:.3f}ms idle share={prof['device_idle_share']:.3f} "
          "device ms by group: " + " ".join(f"{k}={v:.3f}" for k, v in prof["device_ms"].items()))
    for ms, count, name in prof["top_other"]:
        print(f"    other: {ms:.3f}ms in {count} launches: {name}")
    del module, optimizer, step, batch, outs
    torch.cuda.empty_cache()
    return {"launches": kernel, "step_ms": step_s * 1e3, "peak_gb": peak_gb, "mfu": mfu[0]}


# ------------------------------------------------------------ generation
def generation_models() -> dict:
    """(a) the bench 0.5B model; (b) the same widths in the JAX default
    architecture (layernorm, GELU MLP x4, tied head, key/query norm); both
    cut to ``GEN["layers"]`` layers."""
    from scaling_tpu_torch.serve.bench import MODELS

    cut = dict(MODELS["0.5b"], num_layers=GEN["layers"])
    return {"0.5b": cut, "0.5b_default_arch": dict(cut, **DEFAULT_ARCH)}


def cut_model(name: str, layers: int) -> str:
    """``name`` of the serving and training benches' model tables cut to
    ``layers`` layers, registered in both tables of this process under a
    name of its own, which it returns."""
    from scaling_tpu_torch.serve import bench as serve_bench
    from scaling_tpu_torch.train import bench as train_bench

    cut = f"{name}-{layers}l"
    for table in (serve_bench.MODELS, train_bench.MODELS):
        table[cut] = dict(table[name], num_layers=layers)
    return cut


def generation_prompts(vocab: int) -> list:
    """``GEN["batch"]`` prompts of token ids from ``GEN["seed"]``, lengths in
    ``GEN["prompt_len"]`` with the first exactly the longest and the last
    exactly the shortest."""
    rng = np.random.default_rng(GEN["seed"])
    lo, hi = GEN["prompt_len"]
    lengths = rng.integers(lo, hi + 1, size=GEN["batch"])
    lengths[0], lengths[-1] = hi, lo
    return [rng.integers(1, vocab, size=int(n)).tolist() for n in lengths]


def recompute_generation(inf, prompt: list, out) -> dict:
    """One row's generation once more on the CPU in f32 through the plain
    versions: the port's ``logits()`` over the prompt and the generated
    tokens, read at each generated position, against the card's per-step
    logits. ``err`` is max |card - cpu| over max |cpu|; ``uniform_err`` the
    least ``err`` that constant logits per position could reach; where the
    CPU's top-2 margin exceeds twice the measured error, the generated
    token must be the CPU's argmax (``disagree`` counts those that are not)."""
    ids = out.completion_ids
    cpu = cpu_f32_copy(inf).logits(prompt + ids[:-1])[0, len(prompt) - 1:]
    card = out.logits.float().cpu()
    scale = cpu.abs().max().item()
    err_abs = (card - cpu).abs().max().item()
    top2 = cpu.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * err_abs
    argmax = cpu.argmax(-1)
    tokens = torch.tensor(ids)
    return {
        "err": err_abs / scale, "err_abs": err_abs, "scale": scale,
        "uniform_err": ((cpu.amax(-1) - cpu.amin(-1)) / 2).max().item() / scale,
        "sure": int(sure.sum()), "disagree": int((sure & (tokens != argmax)).sum()),
        "argmax_agree": (tokens == argmax).float().mean().item(),
    }


class GenerateProbe:
    """CUDA events around the prefill and each decode step of the
    ``generate`` calls made while it is installed on ``inf`` (no host
    sync); with ``profile=(a, b)``, ``torch.profiler`` over decode steps
    a..b-1, synchronised at both ends."""

    def __init__(self, inf, profile=None):
        self.inf, self.profile = inf, profile
        self.prefill, self.steps = [], []
        self.prof = self.window_ms = None

    def __enter__(self):
        inf, probe = self.inf, self
        prefill, decode_step = inf._prefill, inf._decode_step

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed_prefill(*a, **kw):
            start = event()
            out = prefill(*a, **kw)
            probe.prefill.append((start, event()))
            return out

        def timed_step(*a, **kw):
            if probe.profile is not None:
                t = len(probe.steps) + 1
                if t in probe.profile:
                    torch.cuda.synchronize()
                    if t == probe.profile[0]:
                        from torch.profiler import ProfilerActivity, profile

                        probe.prof = profile(activities=[ProfilerActivity.CUDA])
                        probe.prof.start()
                        probe.t0 = time.monotonic()
                    else:
                        probe.window_ms = (time.monotonic() - probe.t0) * 1e3
                        probe.prof.stop()
            probe.steps.append(event())
            return decode_step(*a, **kw)

        inf._prefill, inf._decode_step = timed_prefill, timed_step
        return self

    def __exit__(self, *exc):
        del self.inf._prefill, self.inf._decode_step  # the class's methods again
        return False

    def times(self) -> dict:
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(self.steps, self.steps[1:])]
        return {"prefill_ms": statistics.median(a.elapsed_time(b) for a, b in self.prefill),
                "decode_ms": statistics.median(step_ms)}

    def window(self) -> dict:
        """The profiled steps' wall clock, device busy time, idle share, and
        the kernels that took the most device time, a step each."""
        steps = self.profile[1] - self.profile[0]
        kernels = sorted(((getattr(e, "self_device_time_total", 0) or 0) / 1e3 / steps,
                          e.count // steps, e.key[:70]) for e in self.prof.key_averages())
        busy = sum(ms for ms, _, _ in kernels) * steps
        return {"steps": steps, "wall_ms": self.window_ms, "busy_ms": busy,
                "idle_share": 1.0 - busy / self.window_ms,
                "top": [k for k in reversed(kernels) if k[0] > 0][:6]}


def time_generation(inf, prompts: list) -> dict:
    """A timed ``generate`` of the batch (host clock to the last token's
    fetch; CUDA events for the prefill and per decode step) and one with a
    profiled window of decode steps."""
    dev = inf.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    with GenerateProbe(inf) as probe:
        t0 = time.monotonic()
        outs = inf.generate(prompts, max_tokens=GEN["max_tokens"])
        wall = time.monotonic() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
    timing = probe.times()
    with GenerateProbe(inf, profile=GEN["profile"]) as probe:
        profiled = inf.generate(prompts, max_tokens=GEN["max_tokens"])
    tokens = sum(len(o.completion_ids) for o in outs)
    return {**timing, "wall_s": wall, "tokens_per_s": tokens / wall, "peak_gb": peak,
            "weights_gb": sum(p.numel() * p.element_size() for p in inf.model.parameters()) / 1e9,
            "window": probe.window(), "outs": [outs, profiled]}


def check_generation_launches(name: str, kernel: dict, plain: dict, needed: tuple) -> None:
    if any(kernel.get(k, 0) <= 0 for k in needed):
        raise AssertionError(f"generate {name}: kernels not launched on its path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"generate {name}: plain versions ran on the card: {plain}")


def generation_phase(name: str, arch_dict: dict, device: str = "cuda") -> dict:
    """``generate`` with one model at full width (random weights from seed
    0; ``GEN["layers"]`` deep): the batch of ``generation_prompts`` four times (tokens
    checked, repeated bitwise, timed, profiled) and one 1-D prompt, launch
    counters reset just before and read just after; then the most-padded
    row recomputed on the CPU. Returns the counters."""
    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.ops import launches

    arch = TransformerArchitectureConfig.from_dict(arch_dict)
    inf = TransformerInferenceModule.random_init(arch, seed=0, device=device)
    n_params = sum(p.numel() for p in inf.model.parameters())
    prompts = generation_prompts(arch.vocab_size)
    inf.generate(prompts[0][:128], max_tokens=4)  # warm-up, off the books
    launches.reset()
    first = inf.generate(prompts, max_tokens=GEN["max_tokens"])
    again = inf.generate(prompts, max_tokens=GEN["max_tokens"])
    timing = time_generation(inf, prompts)
    single = inf.generate(prompts[-1], max_tokens=GEN["max_tokens"])
    if device == "cuda":
        torch.cuda.synchronize()
    kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    runs = [first, again] + timing.pop("outs")
    for outs in runs:
        if [len(o.completion_ids) for o in outs] != [GEN["max_tokens"]] * len(prompts):
            raise AssertionError(f"generate {name}: a row did not return its "
                                 f"{GEN['max_tokens']} tokens")
    if any([o.completion_ids for o in outs] != [o.completion_ids for o in first]
           for outs in runs[1:]):
        raise AssertionError(f"generate {name}: a repeated generate gave other tokens")
    logits_equal = all(torch.equal(a.logits, b.logits) for a, b in zip(first, again))
    if len(single.completion_ids) != GEN["max_tokens"]:
        raise AssertionError(f"generate {name}: the 1-D prompt did not return its tokens")
    same = sum(a == b for a, b in zip(single.completion_ids, first[-1].completion_ids))
    rec = recompute_generation(inf, prompts[-1], first[-1])
    print(f"  {name}: params={n_params} prompts={len(prompts)} of "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"{GEN['max_tokens']} greedy tokens each; 4 batch runs give the same tokens "
          f"(logits bitwise equal: {logits_equal}); the 1-D prompt alone matches its batch "
          f"row in {same}/{GEN['max_tokens']} tokens")
    print(f"  {name}: most-padded row recomputed on CPU f32 (plain versions): logits "
          f"max_abs_err={rec['err_abs']:.4e} max|logit|={rec['scale']:.4e} "
          f"err/max|logit|={rec['err']:.3e} (tol {GEN_LOGIT_TOL}; constant logits would give "
          f">= {rec['uniform_err']:.3e}); tokens where the CPU's top-2 margin exceeds 2x the "
          f"error: {rec['sure']}, of which not the CPU argmax: {rec['disagree']}; argmax "
          f"agreement {rec['argmax_agree']:.3f}")
    if not rec["uniform_err"] > GEN_LOGIT_TOL:
        raise AssertionError(f"generate {name}: constant logits would pass: {rec}")
    if not rec["err"] <= GEN_LOGIT_TOL:
        raise AssertionError(f"generate {name}: logits recompute disagrees: {rec}")
    if rec["disagree"]:
        raise AssertionError(f"generate {name}: a token is not the CPU's clear argmax: {rec}")
    print(f"  {name}: launches kernel={kernel} plain={plain}")
    needed = ("flash_attention_fwd", "rms_norm") if arch.fused_norm else ("flash_attention_fwd",)
    check_generation_launches(name, kernel, plain, needed)
    if "window" in timing:
        w = timing["window"]
        print(f"  {name}: prefill (b {len(prompts)}, s {max(map(len, prompts))})="
              f"{timing['prefill_ms']:.3f}ms median decode step={timing['decode_ms']:.3f}ms "
              f"a token; output tokens/s={timing['tokens_per_s']:.1f} "
              f"(wall {timing['wall_s']:.3f}s); peak memory of the call "
              f"{timing['peak_gb']:.3f}GB above what was allocated before it (the weights: "
              f"{timing['weights_gb']:.3f}GB)")
        print(f"  {name}: profiled decode steps {GEN['profile'][0]}-{GEN['profile'][1] - 1} "
              f"(torch.profiler): wall={w['wall_ms'] / w['steps']:.3f}ms a step, device busy="
              f"{w['busy_ms'] / w['steps']:.3f}ms a step, idle share={w['idle_share']:.3f}")
        for ms, count, op in w["top"]:
            print(f"    {ms:.4f}ms a step in {count} launches: {op}")
    del inf
    if device == "cuda":
        torch.cuda.empty_cache()
    return kernel


@contextlib.contextmanager
def unfused_attention(inf):
    """The model's attention on its unfused path, as ``masked_softmax.kernel:
    torch`` would build it."""
    layers = inf.model.transformer_layers
    saved = [layer.attention.use_flash for layer in layers]
    for layer in layers:
        layer.attention.use_flash = False
    try:
        yield
    finally:
        for layer, flag in zip(layers, saved):
            layer.attention.use_flash = flag


def timed_ms(fn, reps: int) -> float:
    """Median wall ms of ``reps`` calls of ``fn``, each ended by a device sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def atman_phase(arch_dict: dict, device: str = "cuda") -> dict:
    """Phase 6's AtMan check on the 0.5B model (random weights from seed 0):
    ``logits(controls=...)`` of a ``ATMAN`` batch in both variants, counters
    reset just before the controlled calls and read just after (the
    controls run unfused: K2, no K4); factor 1 against the uncontrolled
    unfused logits, factor 0 on one token against factor 1 (see ATMAN);
    each call's ms beside the plain (K4) and the unfused logits'. Returns
    the controlled calls' counters."""
    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.models.transformer.attention_control import Control
    from scaling_tpu_torch.ops import launches

    arch = TransformerArchitectureConfig.from_dict(arch_dict)
    inf = TransformerInferenceModule.random_init(arch, seed=0, device=device)
    tokens = torch.from_numpy(np.random.default_rng(ATMAN["seed"]).integers(
        1, arch.vocab_size, size=(ATMAN["batch"], ATMAN["seq"]))).to(device)
    j = ATMAN["token"]
    with unfused_attention(inf):
        unfused = inf.logits(tokens).float()
    launches.reset()
    runs = {}
    for log_additive in (True, False):
        one = inf.logits(tokens, [Control(j, 1.0)], log_additive).float()
        zero = inf.logits(tokens, [Control(j, 0.0)], log_additive).float()
        runs[log_additive] = (one, zero)
    if device == "cuda":
        torch.cuda.synchronize()
    kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    scale = unfused.abs().max().item()
    for log_additive, (one, zero) in runs.items():
        name = "log-additive" if log_additive else "multiplicative"
        err = (one - unfused).abs().max().item() / scale
        moved = (zero[:, j:] - one[:, j:]).abs().amax(-1)
        before_equal = torch.equal(zero[:, :j], one[:, :j])
        print(f"  atman {name}: factor 1 vs the uncontrolled unfused logits max_abs_err/"
              f"max|logit|={err:.3e} (bitwise: {torch.equal(one, unfused)}; tol "
              f"{'bitwise' if log_additive else ATMAN['tol']}); factor 0 on token {j}: "
              f"positions < {j} bitwise the factor-1 run's: {before_equal}, positions >= {j} "
              f"moved by {moved.min().item():.3e}-{moved.max().item():.3e}")
        if log_additive and not torch.equal(one, unfused):
            raise AssertionError(f"atman {name}: factor 1 is not the unfused logits bitwise")
        if not err <= ATMAN["tol"]:
            raise AssertionError(f"atman {name}: factor 1 off the unfused logits by {err}")
        if not before_equal or not moved.min().item() > 0:
            raise AssertionError(f"atman {name}: factor 0 did not keep the earlier positions "
                                 "or move every later one")
    ran = kernel if device == "cuda" else plain  # the CPU runs the plain versions
    if ran.get("rms_norm", 0) <= 0 or ran.get("flash_attention_fwd", 0) != 0:
        raise AssertionError(f"atman: the controlled logits must run K2 and not K4: {ran}")
    if device == "cuda" and sum(plain.values()) != 0:
        raise AssertionError(f"atman: plain versions ran on the card: {plain}")
    flash = inf.logits(tokens).float()
    floor = (flash - unfused).abs().max().item() / scale
    print(f"  atman: the bf16 floor, K4's logits vs the unfused path's: max_abs_err/max|logit|="
          f"{floor:.3e}")
    del flash
    if device == "cuda":
        controls = [Control(j, 0.0)]
        ms = {"plain (K4)": timed_ms(lambda: inf.logits(tokens), ATMAN["reps"])}
        with unfused_attention(inf):
            ms["unfused"] = timed_ms(lambda: inf.logits(tokens), ATMAN["reps"])
        ms["log-additive"] = timed_ms(lambda: inf.logits(tokens, controls), ATMAN["reps"])
        ms["multiplicative"] = timed_ms(lambda: inf.logits(tokens, controls, False),
                                        ATMAN["reps"])
        print(f"  atman logits of {ATMAN['batch']} x {ATMAN['seq']} tokens, ms (median of "
              f"{ATMAN['reps']}, host clock to a device sync): "
              + " ".join(f"{k}={v:.2f}" for k, v in ms.items()))
    print(f"  atman launches kernel={kernel} plain={plain}")
    del inf, runs, unfused
    if device == "cuda":
        torch.cuda.empty_cache()
    return kernel


def write_token_datasets(root: Path, vocab: int) -> dict:
    """Two training prefixes of ~``tokens`` tokens and a validation prefix,
    documents of ``doc_len`` tokens ending in EOD 0, uint16, from seed 0,
    written by the port's builder."""
    from scaling_tpu_torch.data import MemoryMapDatasetBuilder

    rng = np.random.default_rng(0)
    prefixes = {}
    for name, tokens in (("a", TRAINER["tokens"]), ("b", TRAINER["tokens"]),
                         ("valid", TRAINER["valid_tokens"])):
        written = 0
        with MemoryMapDatasetBuilder(root / name, dtype=np.uint16) as builder:
            while written < tokens:
                doc = rng.integers(1, vocab, size=int(rng.integers(*TRAINER["doc_len"])) - 1)
                builder.add(np.append(doc, 0))
                written += doc.size + 1
        prefixes[name] = str(root / name)
    return prefixes


def trainer_arch() -> dict:
    """The trainer phases' model: phase 5's at its widths, cut to at most
    TRAINER["layers"] layers."""
    from scaling_tpu_torch.train.bench import MODELS

    arch = MODELS[TRAINER["model"]]
    return dict(arch, sequence_length=TRAINER["seq"],
                num_layers=min(arch["num_layers"], TRAINER["layers"]))


def checkpoint_need(n: int) -> int:
    """Disk for ``n`` checkpoints of the trainer phases' model: 4 bytes a
    parameter for the weights and 12 for the optimizer, and 1 GiB more."""
    if TRAINER["model"] != "0.5b":
        return 1 << 30
    params = PARAMS_05B["embedding_and_head"] + trainer_arch()["num_layers"] * PARAMS_05B["layer"]
    return n * 16 * params + (1 << 30)


def trainer_config(prefixes: dict, log_dir: Path, save_dir=None, load_dir=None) -> dict:
    """The JAX-shaped training config of the trainer phase: ``trainer_arch``
    and phase 5's optimizer, blended token data, eval and checkpoints."""
    from scaling_tpu_torch.train.bench import LR_SCHEDULE, OPTIMIZER

    return {
        "topology": {"model_parallel_size": 1, "pipe_parallel_size": 1,
                     "data_parallel_size": 1, "micro_batch_size": TRAINER["mbs"],
                     "gradient_accumulation_steps": 1},
        "transformer_architecture": trainer_arch(),
        "optimizer": OPTIMIZER,
        "learning_rate_scheduler": LR_SCHEDULE,
        "trainer": {"seed": 0, "train_iterations": TRAINER["iterations"],
                    "save_dir": None if save_dir is None else str(save_dir),
                    "save_interval": TRAINER["interval"],
                    "load_dir": None if load_dir is None else str(load_dir),
                    "eval_interval": TRAINER["interval"],
                    "eval_iterations": TRAINER["eval_iterations"],
                    "delete_past_optimizer_states": False},
        "data": {"data_prefixes": [prefixes["a"], prefixes["b"]],
                 "validation_data_prefixes": [prefixes["valid"]]},
        "logger": {"log_dir": str(log_dir)},
    }


def trainer_state(trainer) -> dict:
    """A host copy of the trainer's parameters and f32 optimizer state."""
    opt = trainer.optimizer.state
    state = {f"param.{n}": p.detach().to("cpu", copy=True)
             for n, p in trainer.module.model.named_parameters()}
    for field in ("master", "exp_avg", "exp_avg_sq"):
        state.update({f"{field}.{n}": t.to("cpu", copy=True)
                      for n, t in getattr(opt, field).items()})
    return state


class TrainerProbe:
    """Watches ``TransformerTrainer`` for one run: the host batch of each
    step, the state at the save of step ``interval`` (a host copy, taken
    before the save and outside its time), and the seconds of each save and
    load. Installed around one ``main`` and removed after it."""

    def __init__(self, snapshot_at=None, on_load=None):
        self.batches, self.saves, self.loads = [], [], []
        self.snapshot, self.snapshot_at, self.on_load = None, snapshot_at, on_load

    def __enter__(self):
        from scaling_tpu_torch.models.transformer.train import TransformerTrainer

        self.cls = TransformerTrainer
        self.orig = {k: getattr(TransformerTrainer, k)
                     for k in ("_assemble_micro_batches", "save_checkpoint", "load_checkpoint")}
        probe, orig = self, self.orig

        def assemble(trainer):
            batch = orig["_assemble_micro_batches"](trainer)
            probe.batches.append(batch)
            return batch

        def save(trainer, *a, **kw):
            if trainer.context.iterations == probe.snapshot_at:
                probe.snapshot = trainer_state(trainer)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            step_dir = orig["save_checkpoint"](trainer, *a, **kw)
            probe.saves.append((step_dir, time.monotonic() - t0))
            return step_dir

        def load(trainer, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            loaded = orig["load_checkpoint"](trainer, *a, **kw)
            torch.cuda.synchronize()
            probe.loads.append(time.monotonic() - t0)
            if probe.on_load is not None:
                probe.on_load(trainer)
            return loaded

        TransformerTrainer._assemble_micro_batches = assemble
        TransformerTrainer.save_checkpoint = save
        TransformerTrainer.load_checkpoint = load
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.cls, k, fn)
        return False


def metric_records(path: Path) -> list:
    """The step records of a metrics JSONL (its registry snapshots left out)."""
    records = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in records if r.get("kind") == "step"]


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def serve_greedy(inf, vocab: int) -> dict:
    """4 greedy requests (prompts of 64-256 tokens, 32 output tokens each)
    through an engine with native KV; tokens by request id."""
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine

    engine = ServeEngine(inf, EngineConfig(kv_dtype="native", **SERVE), device=inf.device)
    rng = np.random.default_rng(6)
    for _ in range(TRAINER["serve_requests"]):
        n = int(rng.integers(TRAINER["serve_prompt"][0], TRAINER["serve_prompt"][1] + 1))
        engine.submit(rng.integers(1, vocab, size=n).tolist(), TRAINER["serve_output"])
    return {s.request.req_id: list(s.generated) for s in engine.run_until_done()}


def check_trainer_launches(kernel: dict, plain: dict) -> None:
    needed = ("paged_attention", "rms_norm", "rms_norm_bwd", "flash_attention_fwd",
              "flash_attention_bwd")
    if any(kernel.get(k, 0) <= 0 for k in needed):
        raise AssertionError(f"trainer phase: kernels not launched on its path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"trainer phase: plain versions ran on the card: {plain}")


def keep_base(step_dir: Path, prefixes: dict, keep: Path, earlier: tuple = ()) -> dict:
    """Phase 8's ``global_step6`` (its optimizer files pruned: a finetune
    takes none), ``latest`` naming it, and training prefixes moved under
    ``keep`` for phase 12; the ``earlier`` steps beside it, pruned alike,
    for phase 17's restores."""
    from scaling_tpu_torch.resilience import prune_manifest_entries

    base = keep / "base"
    base.mkdir(parents=True)
    for d in (*earlier, step_dir):
        shutil.move(str(d), str(base / d.name))
        removed = [f.name for f in (base / d.name).glob("optimizer_state_*")]
        for name in removed:
            (base / d.name / name).unlink()
        prune_manifest_entries(base / d.name, removed)
    (base / "latest").write_text(step_dir.name)
    kept = {}
    for name in ("a", "b"):
        for f in Path(prefixes[name]).parent.glob(f"{name}.*"):
            shutil.move(str(f), str(keep / f.name))
        kept[name] = str(keep / name)
    return {"ckpt": base, "prefixes": kept}


def trainer_phase(bench_step_ms: float, device: str = "cuda", keep=None) -> dict:
    """The Trainer end to end (phase 8 of the module's docstring); the
    launch counters reset just before and read just after. Returns them
    (``launches``) with what phase 9 is held against: the first run's
    losses, the crc32 of each npz file of its synchronous step-3 save, the
    save seconds, the steady step ms and the first run's peak
    ``max_memory_allocated``; with ``keep`` a directory, also ``base``:
    the step-6 checkpoint and the training prefixes kept there for phase 12."""
    from scaling_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerInferenceModule,
        TransformerModel,
    )
    from scaling_tpu_torch.models.transformer.train import main
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.resilience import verify_checkpoint
    from scaling_tpu_torch.train.bench import MODELS

    vocab = MODELS[TRAINER["model"]]["vocab_size"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    try:
        free = shutil.disk_usage(root).free
        # a checkpoint: 4 bytes a parameter for the weights, 12 for the optimizer
        need = checkpoint_need(2)
        print(f"  temporary directory {root}: {free / 1e9:.1f} GB free, two checkpoints need "
              f"~{need / 1e9:.1f} GB")
        if free < need:
            raise AssertionError(f"not enough disk for two checkpoints under {root}")
        t0 = time.monotonic()
        prefixes = write_token_datasets(root, vocab)
        print(f"  token datasets written in {time.monotonic() - t0:.1f}s: "
              + " ".join(f"{k}={Path(v).with_suffix('.bin').stat().st_size // 2} tokens"
                         for k, v in prefixes.items()))
        save_dir = root / "ckpt"
        launches.reset()

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with TrainerProbe(snapshot_at=TRAINER["interval"]) as first:
            trainer = main(TransformerConfig.from_dict(
                trainer_config(prefixes, root / "logs", save_dir=save_dir)), device=device)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        arch = trainer.context.config.transformer_architecture
        weights = {k: v.clone() for k, v in trainer.module.model.state_dict().items()}
        in_memory_loss = in_memory_eval_loss(trainer, prefixes["valid"])
        del trainer
        torch.cuda.empty_cache()
        records = metric_records(root / "logs" / "metrics_rank_0.jsonl")
        steps = [r for r in records if "loss" in r["metrics"]]
        losses = [r["metrics"]["loss"] for r in steps]
        if [r["step"] for r in steps] != list(range(1, TRAINER["iterations"] + 1)):
            raise AssertionError(f"step records: {[r['step'] for r in steps]}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite trainer loss: {losses}")
        check_step_records(steps)
        step_dirs = [d for d, _ in first.saves]
        if [d.name for d in step_dirs] != ["global_step3", "global_step6"]:
            raise AssertionError(f"checkpoints: {step_dirs}")
        for d in step_dirs:
            problems = verify_checkpoint(d)
            if problems:
                raise AssertionError(f"{d.name} fails verification: {problems}")

        def check_loaded(trainer):
            ctx = trainer.context
            if (ctx.iterations, ctx.consumed_samples) != (3, 3 * TRAINER["mbs"]):
                raise AssertionError(f"resumed at {ctx.iterations} / {ctx.consumed_samples}")
            now = trainer_state(trainer)
            if now.keys() != first.snapshot.keys():
                raise AssertionError("the resumed state has other tensors than step 3's")
            differ = [k for k, v in now.items() if not torch.equal(v, first.snapshot[k])]
            if differ:
                raise AssertionError(f"resumed state differs from step 3's: {differ[:5]}")

        with TrainerProbe(on_load=check_loaded) as second:
            resumed = main(TransformerConfig.from_dict(
                trainer_config(prefixes, root / "logs2", load_dir=save_dir / "global_step3")),
                device=device)
        del resumed
        torch.cuda.empty_cache()
        step4_first, step4_again = first.batches[3], second.batches[0]
        for field in vars(step4_first):
            if not np.array_equal(getattr(step4_first, field), getattr(step4_again, field)):
                raise AssertionError(f"the resumed step-4 batch differs in {field}")
        again = [r["metrics"]["loss"] for r in metric_records(root / "logs2" /
                                                              "metrics_rank_0.jsonl")
                 if "loss" in r["metrics"]]
        print(f"  losses: first run {losses}; resumed at 3: {again}")
        if again[0] != losses[3]:
            raise AssertionError(f"step-4 loss after the resume {again[0]!r} != {losses[3]!r}")
        rel = [abs(a - b) / abs(b) for a, b in zip(again[1:], losses[4:])]
        print(f"  step 4 bitwise equal; steps 5-6 rel. diff {rel} (rtol {RESUME_RTOL})")
        if len(again) != 3 or not max(rel) <= RESUME_RTOL:
            raise AssertionError(f"resumed losses {again} vs {losses[3:]}")

        evaluate_checkpoint(save_dir, prefixes["valid"], records, in_memory_loss, device)
        served = TransformerInferenceModule.from_checkpoint(save_dir, device=device)
        differ = [k for k, v in served.model.state_dict().items() if not torch.equal(v, weights[k])]
        if differ:
            raise AssertionError(f"bf16 -> f32 npz -> bf16 is not exact: {differ[:5]}")
        tokens = serve_greedy(served, vocab)
        del served
        model = TransformerModel(arch, device=device)
        model.load_state_dict(weights)
        in_memory = serve_greedy(TransformerInferenceModule(arch, model), vocab)
        if tokens != in_memory or any(len(t) != TRAINER["serve_output"] for t in tokens.values()):
            raise AssertionError("the checkpoint serves other tokens than the trainer's weights")
        torch.cuda.synchronize()
        kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
        print(f"  checkpoint served: {len(tokens)} greedy requests, tokens equal to the "
              f"trainer's in-memory weights'")
        print(f"  launches kernel={kernel} plain={plain}")
        check_trainer_launches(kernel, plain)

        durations = [r["metrics"]["step_duration"] for r in steps[1:]]
        step_ms = statistics.median(durations) * 1e3
        tokens_per_s = TRAINER["mbs"] * TRAINER["seq"] / (step_ms / 1e3)
        size = dir_bytes(step_dirs[0])
        mfus = [r["metrics"].get("palm_mfu") for r in steps[1:]]
        mfu = "not measured" if None in mfus else f"{statistics.median(mfus):.4f}"
        print(f"  trainer steady step (median of steps 2-{TRAINER['iterations']}, host clock "
              f"to the loss's fetch): {step_ms:.2f}ms tokens/s={tokens_per_s:.1f} mfu={mfu}; "
              f"phase 5's bench step at {MODELS[TRAINER['model']]['num_layers']} layers "
              f"{bench_step_ms:.2f}ms")
        for (d, sec) in first.saves:
            print(f"  checkpoint save {d.name}: {sec:.2f}s {dir_bytes(d) / sec / 1e9:.2f}GB/s")
        for sec in second.loads:
            print(f"  checkpoint load (verify crc32 + read): {sec:.2f}s "
                  f"{size / sec / 1e9:.2f}GB/s")
        opt_bytes = sum(f.stat().st_size for f in step_dirs[0].glob("optimizer_state*"))
        print(f"  checkpoint size: {size} bytes ({size / 1e9:.2f} GB): {size - opt_bytes} "
              f"weights and the rest, {opt_bytes} optimizer state")
        if peak is not None:
            print(f"  first run's peak max_memory_allocated: {peak / 1e9:.2f}GB")
        out = {"launches": kernel, "losses": losses, "step3_crcs": npz_crcs(step_dirs[0]),
               "saves": [(d.name, sec) for d, sec in first.saves], "step_ms": step_ms,
               "peak_bytes": peak}
        if keep is not None:
            out["base"] = {**keep_base(step_dirs[1], prefixes, Path(keep), step_dirs[:1]),
                           "step_ms": step_ms, "peak_bytes": peak}
        return out
    finally:
        reset_logger()
        shutil.rmtree(root, ignore_errors=True)


def npz_crcs(step_dir: Path) -> dict:
    """The crc32 the manifest records for each npz file of a checkpoint."""
    from scaling_tpu_torch.resilience import read_manifest

    return {name: entry["crc32"] for name, entry in read_manifest(step_dir)["files"].items()
            if name.endswith(".npz")}


def check_evaluate_launches(kernel: dict, plain: dict) -> None:
    if any(kernel.get(k, 0) <= 0 for k in ("rms_norm", "flash_attention_fwd")):
        raise AssertionError(f"evaluate: kernels not launched on its path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"evaluate: plain versions ran on the card: {plain}")


def in_memory_eval_loss(trainer, valid_prefix: str) -> float:
    """The trainer's own forward and loss function on its in-memory weights
    (step 6) over ``evaluate``'s batches: the validation prefix read in
    order, ``eval_iterations`` batches of the micro-batch size. The batch
    means are weighted by the batches' loss weights, as ``evaluate`` weighs
    its tokens."""
    from scaling_tpu_torch.models.transformer.data.text_dataset import TextDataset

    mbs = TRAINER["mbs"]
    arch = trainer.context.config.transformer_architecture
    dataset = TextDataset(valid_prefix, sequence_length=arch.sequence_length, shuffle=False)
    trainer.module.model.eval()
    total = weight = 0.0
    with torch.no_grad():
        for b in range(TRAINER["eval_iterations"]):
            items = [dataset[i] for i in range(b * mbs, min((b + 1) * mbs, len(dataset)))]
            batch = trainer.batch_to_model_input(dataset.collate(items), trainer.device)
            loss, _ = trainer.loss_function(trainer.module.forward(batch), batch)
            w = float(batch["loss_weights"].float().sum())
            total, weight = total + float(loss) * w, weight + w
    return total / weight


def evaluate_checkpoint(save_dir: Path, valid_prefix: str, records: list,
                        in_memory_loss: float, device: str) -> dict:
    """``evaluate`` on the checkpoint ``latest`` names (step 6) over the
    validation prefix, 2 batches of the trainer's micro-batch size; its
    launches are the counters' growth over the call. It must give the loss
    of the trainer's forward on its in-memory step-6 weights over the same
    batches within ``EVAL_REF_NATS``, a limit the step-3 checkpoint must
    miss, and lie within ``EVAL_NATS`` of the trainer's own step-6 eval
    loss (other, shuffled batches)."""
    from scaling_tpu_torch.models.transformer.evaluate import evaluate
    from scaling_tpu_torch.ops import launches

    def run(checkpoint: Path) -> dict:
        return evaluate(checkpoint, valid_prefix, batch_size=TRAINER["mbs"],
                        max_batches=TRAINER["eval_iterations"], device=device)

    before = Counter(launches.KERNEL), Counter(launches.PLAIN)
    t0 = time.monotonic()
    stats = run(save_dir)
    seconds = time.monotonic() - t0
    kernel = dict(Counter(launches.KERNEL) - before[0])
    plain = dict(Counter(launches.PLAIN) - before[1])
    step3 = run(save_dir / f"global_step{TRAINER['interval']}")
    eval_loss = [r["metrics"]["eval_loss"] for r in records
                 if r["step"] == TRAINER["iterations"] and "eval_loss" in r["metrics"]][0]
    gap, gap3 = abs(stats["loss"] - in_memory_loss), abs(step3["loss"] - in_memory_loss)
    print(f"  evaluate (step {TRAINER['iterations']} checkpoint, validation prefix, "
          f"{stats['batches']} batches of {TRAINER['mbs']}): loss={stats['loss']} "
          f"accuracy={stats['accuracy']} tokens={stats['tokens']} in {seconds:.2f}s; "
          f"launches kernel={kernel} plain={plain}")
    print(f"  the trainer's forward on its in-memory step-{TRAINER['iterations']} weights over "
          f"the same batches: {in_memory_loss:.6f}, gap {gap:.3g} (tol {EVAL_REF_NATS} nats); "
          f"the step-{TRAINER['interval']} checkpoint: {step3['loss']}, gap {gap3:.3g} (must "
          f"exceed the tol); the trainer's step-{TRAINER['iterations']} eval loss on its own "
          f"batches {eval_loss:.6f} (tol {EVAL_NATS} nats)")
    if not np.isfinite(stats["loss"]) or not gap <= EVAL_REF_NATS:
        raise AssertionError(f"evaluate: loss {stats['loss']} vs in-memory {in_memory_loss}")
    if not gap3 > EVAL_REF_NATS:
        raise AssertionError(f"evaluate cannot tell the step-{TRAINER['interval']} checkpoint: "
                             f"{step3['loss']} vs in-memory {in_memory_loss}")
    if not abs(stats["loss"] - eval_loss) <= EVAL_NATS:
        raise AssertionError(f"evaluate: loss {stats['loss']} vs eval loss {eval_loss}")
    check_evaluate_launches(kernel, plain)
    return stats


def check_step_records(steps: list) -> None:
    if not all("palm_mfu" in r["metrics"] for r in steps):
        raise AssertionError("a step record has no palm_mfu")


# ------------------------------------------------------------ supervision
def supervise_config(prefixes: dict, run_dir: Path, name: str, save_dir: Path,
                     resume: bool) -> dict:
    """Phase 8's config with the trainer's supervision keys on, logging into
    ``run_dir/logs_<name>`` and the run directory's one events file. Run B,
    the resume, also prunes past optimizer states, after its commit."""
    config = trainer_config(prefixes, run_dir / f"logs_{name}", save_dir=save_dir,
                            load_dir=save_dir if resume else None)
    config["trainer"].update(SUPERVISE["keys"], delete_past_optimizer_states=resume)
    config["logger"]["events_path"] = str(run_dir / "events.jsonl")
    return config


def supervise_child_command(spec_file: Path) -> list:
    """The command of one of phase 9's child runs."""
    return [sys.executable, str(Path(__file__).resolve()), "--supervise-child", str(spec_file)]


def supervise_child(spec_file: str) -> int:
    """One supervised Trainer run in a process of its own (phase 9): the
    spec's ``config`` through ``run_with_resume``, SIGTERM handled by
    ``install_preemption_handler``, a pause of ``pause_s`` after each
    logged step. Writes to ``result_path`` the iterations, where it
    resumed, the watchdog's stalls, its launch counters, and timed events
    (wall clock): each step, each save's start and return, each commit
    made durable (``latest`` written), each pruning, and the peak resident
    memory inside each save's window."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import build_trainer
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.resilience import CheckpointCommit, run_with_resume
    from scaling_tpu_torch.trainer import BaseTrainer

    spec = json.loads(Path(spec_file).read_text())
    events, rss, stop = [], [], threading.Event()

    def sample_rss():
        page = os.sysconf("SC_PAGE_SIZE")
        while not stop.wait(0.02):
            with open("/proc/self/statm") as f:
                rss.append((time.time(), int(f.read().split()[1]) * page))

    threading.Thread(target=sample_rss, name="rss-sampler", daemon=True).start()
    update_latest, prune = CheckpointCommit.update_latest, BaseTrainer._prune_past_optimizer_states

    def timed_latest(commit):
        update_latest(commit)
        events.append({"event": "durable", "step": commit.step, "t": time.time()})

    def timed_prune(base, step_dir):
        prune(base, step_dir)
        events.append({"event": "pruned", "step": int(step_dir.name[len("global_step"):]),
                       "t": time.time()})

    CheckpointCommit.update_latest = timed_latest
    BaseTrainer._prune_past_optimizer_states = staticmethod(timed_prune)
    resumed_from = []

    def factory():
        trainer = build_trainer(TransformerConfig.from_dict(spec["config"]),
                                device=spec["device"])
        trainer.install_preemption_handler()
        save, train_step = trainer.save_checkpoint, trainer.train_step

        def timed_save(*a, **kw):
            it, t0 = trainer.context.iterations, time.time()
            step_dir = save(*a, **kw)
            events.append({"event": "save", "step": it, "t": t0, "returned": time.time()})
            return step_dir

        def timed_step():
            t0 = time.time()
            out = train_step()
            events.append({"event": "step", "step": trainer.context.iterations, "t": t0,
                           "end": time.time()})
            return out

        trainer.save_checkpoint, trainer.train_step = timed_save, timed_step
        trainer.metrics_hooks.append(lambda metrics, step: time.sleep(spec["pause_s"]))
        resumed_from.append(trainer.context.iterations)
        return trainer

    trainer = run_with_resume(factory, restart_budget=0)
    stop.set()
    durable = {e["step"]: e["t"] for e in events if e["event"] == "durable"}
    for e in events:
        if e["event"] == "save":
            window = [b for t, b in rss if e["t"] <= t <= durable.get(e["step"], e["returned"])]
            e["peak_rss"] = max(window, default=None)
            e["rss_before"] = max((b for t, b in rss if t <= e["t"]), default=None)
            e["durable"] = durable.get(e["step"])
    Path(spec["result_path"]).write_text(json.dumps({
        "iterations": trainer.context.iterations, "resumed_from": resumed_from,
        "stall_count": trainer.watchdog.stall_count, "events": events,
        "kernel": dict(launches.KERNEL), "plain": dict(launches.PLAIN)}))
    return 0


def check_supervise_launches(kernel: dict, plain: dict) -> None:
    needed = ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd")
    if any(kernel.get(k, 0) <= 0 for k in needed):
        raise AssertionError(f"supervise phase: kernels not launched on its path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"supervise phase: plain versions ran on the card: {plain}")


def step_records(log_dir: Path) -> dict:
    """Step -> its metrics record, from a run's ``metrics_rank_0.jsonl``."""
    f = log_dir / "metrics_rank_0.jsonl"
    records = metric_records(f) if f.is_file() else []
    return {r["step"]: r["metrics"] for r in records if "loss" in r["metrics"]}


def run_child(root: Path, name: str, config: dict, device: str, sigterm_after=None,
              on_sigterm=lambda: None) -> dict:
    """One child run; with ``sigterm_after`` the parent sends it SIGTERM once
    that step's record is written, after calling ``on_sigterm``. Fails
    unless it exits 0; returns its result. The child never outlives the
    call."""
    spec = root / f"{name}.json"
    spec.write_text(json.dumps({"config": config, "device": device, "pause_s": SUPERVISE[
        "pause_s"], "result_path": str(root / f"{name}_result.json")}))
    log_file = root / f"{name}.log"
    with open(log_file, "w") as log:
        proc = subprocess.Popen(supervise_child_command(spec), cwd=Path(__file__).resolve().parent,
                                stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + SUPERVISE["child_timeout_s"]
        log_dir = Path(config["logger"]["log_dir"])
        if sigterm_after is not None:
            while sigterm_after not in step_records(log_dir):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"{name}: no step-{sigterm_after} record before the "
                                         f"child ended:\n{log_file.read_text()[-4000:]}")
                time.sleep(0.01)
            on_sigterm()
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"{name}: child exited {rc}:\n{log_file.read_text()[-4000:]}")
    return json.loads((root / f"{name}_result.json").read_text())


def overlap_steps(result: dict, records: dict) -> tuple:
    """The steady steps' ``step_duration`` ms (each child's first step left
    out), split by whether an asynchronous save was still writing while the
    step ran: (apart, during a write), each as {step: ms}."""
    steps = [e for e in result["events"] if e["event"] == "step"][1:]
    writes = [(e["returned"], e["durable"]) for e in result["events"]
              if e["event"] == "save" and e["durable"] is not None]
    apart, during = {}, {}
    for e in steps:
        ms = records[e["step"]]["step_duration"] * 1e3
        busy = any(e["t"] < end and e["end"] > start for start, end in writes)
        (during if busy else apart)[e["step"]] = ms
    return apart, during


def supervise_phase(trainer_run: dict, bench_step_ms: float, device: str = "cuda") -> dict:
    """Phase 9: the supervised Trainer in child processes, held against
    phase 8's run (``trainer_run``). Both children write their events and
    metrics into one run directory, where this process, in the role of the
    relaunching supervisor, records the SIGTERM it relays (``preempt-relay``)
    and the relaunch of run B (``relaunch``) under the JAX supervisor's
    event names. Returns the children's launch counts and a copy of the run
    directory (``run_dir``, a temporary directory phase 10 reads and
    removes)."""
    from scaling_tpu_torch.logging.logger import append_jsonl_line
    from scaling_tpu_torch.resilience import verify_checkpoint
    from scaling_tpu_torch.train.bench import MODELS

    vocab = MODELS[TRAINER["model"]]["vocab_size"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_supervise_"))
    try:
        free = shutil.disk_usage(root).free
        need = checkpoint_need(3)
        print(f"  temporary directory {root}: {free / 1e9:.1f} GB free, three checkpoints need "
              f"~{need / 1e9:.1f} GB")
        if free < need:
            raise AssertionError(f"not enough disk for three checkpoints under {root}")
        prefixes = write_token_datasets(root, vocab)
        save_dir, run_dir = root / "ckpt", root / "obs"
        gold = trainer_run["losses"]
        run_dir.mkdir()

        def supervisor_event(event: str, **fields) -> None:
            """One of the supervisor's records, as ``log_event`` writes it."""
            append_jsonl_line(run_dir / "events.jsonl", json.dumps(
                {"event": event, "ts": time.time(), **fields}, sort_keys=True))

        # run A: SIGTERM from outside once step 4 is logged
        a = run_child(root, "run_a", supervise_config(prefixes, run_dir, "a", save_dir, False),
                      device, sigterm_after=SUPERVISE["sigterm_after"],
                      on_sigterm=lambda: supervisor_event(
                          "preempt-relay", host="supervisor", epoch=0))
        supervisor_event("epoch-clean-exit", epoch=0, preempted=True)
        k, records_a = a["iterations"], step_records(run_dir / "logs_a")
        losses = [records_a[s]["loss"] for s in sorted(records_a)]
        print(f"  run A: SIGTERM after the step-4 record; exited 0 at step {k}; losses {losses}")
        if k not in (4, 5) or sorted(records_a) != list(range(1, k + 1)):
            raise AssertionError(f"run A stopped at {k} with records {sorted(records_a)}")
        if losses != gold[:k]:
            raise AssertionError(f"run A's losses {losses} are not phase 8's {gold[:k]}")
        if (save_dir / "latest").read_text() != f"global_step{k}":
            raise AssertionError(f"latest names {(save_dir / 'latest').read_text()}, not {k}")
        for step in (3, k):
            d = save_dir / f"global_step{step}"
            problems = verify_checkpoint(d)
            if problems or not (d / "MESH.json").is_file():
                raise AssertionError(f"{d.name}: {problems or 'no MESH.json'}")
        differ = sorted(name for name, crc in npz_crcs(save_dir / "global_step3").items()
                        if trainer_run["step3_crcs"].get(name) != crc)
        if differ or len(trainer_run["step3_crcs"]) != len(npz_crcs(save_dir / "global_step3")):
            raise AssertionError(f"the asynchronous global_step3 differs from phase 8's "
                                 f"synchronous save in {differ}")
        print(f"  steps 1-{k} bitwise equal to phase 8; global_step3 and global_step{k} verify "
              f"with MESH.json; global_step3's {len(trainer_run['step3_crcs'])} npz files carry "
              "the crc32s of phase 8's synchronous save")

        # run B: run_with_resume from save_dir to step 6
        supervisor_event("relaunch", epoch=1, restarts=1, budget=1, backoff_s=0.0)
        b = run_child(root, "run_b", supervise_config(prefixes, run_dir, "b", save_dir, True),
                      device)
        supervisor_event("epoch-clean-exit", epoch=1, preempted=False)
        records_b = step_records(run_dir / "logs_b")
        again = [records_b[s]["loss"] for s in sorted(records_b)]
        rel = [abs(x - y) / abs(y) for x, y in zip(again, gold[k:])]
        print(f"  run B: resumed at {b['resumed_from']}, losses {again}; rel. diff to phase 8 "
              f"{rel} (rtol {RESUME_RTOL})")
        if b["resumed_from"] != [k] or sorted(records_b) != list(range(k + 1, 7)):
            raise AssertionError(f"run B resumed at {b['resumed_from']}, steps {sorted(records_b)}")
        if not max(rel) <= RESUME_RTOL:
            raise AssertionError(f"run B's losses {again} vs phase 8's {gold[k:]}")
        step6 = save_dir / "global_step6"
        if verify_checkpoint(step6) or (save_dir / "latest").read_text() != "global_step6":
            raise AssertionError(f"global_step6: {verify_checkpoint(step6)}")
        t_durable = [e["t"] for e in b["events"] if e["event"] == "durable" and e["step"] == 6]
        t_pruned = [e["t"] for e in b["events"] if e["event"] == "pruned" and e["step"] == 6]
        if len(t_durable) != 1 or len(t_pruned) != 1 or not t_pruned[0] > t_durable[0]:
            raise AssertionError(f"pruning did not follow global_step6's commit: {b['events']}")
        for step in (3, k):
            d = save_dir / f"global_step{step}"
            if list(d.glob("optimizer_state_*")) or verify_checkpoint(d):
                raise AssertionError(f"{d.name} not pruned or no longer verifies")
        stalls = (a["stall_count"], b["stall_count"])
        print(f"  global_step6 verifies, latest names it, global_step3 and global_step{k} lost "
              f"their optimizer files after its commit; watchdog stalls {stalls}")
        if stalls != (0, 0):
            raise AssertionError(f"the watchdog fired: {stalls}")

        sync = ", ".join(f"{name} {sec:.2f}s" for name, sec in trainer_run["saves"])
        for run, result in (("A", a), ("B", b)):
            for e in (e for e in result["events"] if e["event"] == "save"):
                print(f"  run {run} async save global_step{e['step']}: loop held "
                      f"{e['returned'] - e['t']:.2f}s, durable after {e['durable'] - e['t']:.2f}s;"
                      f" peak host RSS in its window {e['peak_rss'] / 1e9:.2f} GB "
                      f"({e['rss_before'] / 1e9:.2f} GB before it)")
        print(f"  phase 8's synchronous saves held the loop: {sync}")
        apart, during = {}, {}
        for run, result, records in (("A", a, records_a), ("B", b, records_b)):
            x, y = overlap_steps(result, records)
            apart.update({f"{run}{s}": v for s, v in x.items()})
            during.update({f"{run}{s}": v for s, v in y.items()})
        median = statistics.median(apart.values()) if apart else float("nan")
        print(f"  step ms with prefetch, overlapping no write (each run's first step left out): "
              f"{ {s: round(v, 2) for s, v in apart.items()} }, median {median:.2f}ms; phase 8 "
              f"(no prefetch) {trainer_run['step_ms']:.2f}ms, phase 5's bench step at "
              f"{MODELS[TRAINER['model']]['num_layers']} layers {bench_step_ms:.2f}ms")
        print(f"  step ms during an asynchronous write: "
              f"{ {s: round(v, 2) for s, v in during.items()} }")
        kernel = dict(Counter(a["kernel"]) + Counter(b["kernel"]))
        plain = dict(Counter(a["plain"]) + Counter(b["plain"]))
        print(f"  launches kernel={kernel} plain={plain}")
        check_supervise_launches(kernel, plain)
        kept = Path(tempfile.mkdtemp(prefix="chip_smoke_supervise_obs_"))
        shutil.copytree(run_dir, kept / "run")
        return {"launches": kernel, "run_dir": kept / "run", "k": k}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------- observability
def keep(name: str, text: str) -> None:
    """Write ``text`` under KEEP_DIR, when it is set."""
    if KEEP_DIR is not None:
        Path(KEEP_DIR).mkdir(parents=True, exist_ok=True)
        (Path(KEEP_DIR) / name).write_text(text)


def reset_logger() -> None:
    """Put the process logger back to no sinks: a Trainer's ``main``
    leaves its run's there, and the run's directory is about to go."""
    from scaling_tpu_torch.logging import LoggerConfig, logger

    logger.configure(LoggerConfig())


def check_observe_launches(where: str, kernel: dict, plain: dict, needed: tuple) -> None:
    if any(kernel.get(k, 0) <= 0 for k in needed):
        raise AssertionError(f"{where}: kernels not launched on its path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"{where}: plain versions ran on the card: {plain}")


def obs_report(run_dir: Path, *gates: str) -> tuple:
    """The port's ``obs report`` over ``run_dir`` with ``gates`` (its
    ``--assert-*`` options): (its text, its ``--json`` stats). Fails
    unless it exits 0."""
    import io

    from scaling_tpu_torch.obs.cli import main as obs_main

    out, stats_file = io.StringIO(), run_dir.parent / f"{run_dir.name}_report.json"
    with contextlib.redirect_stdout(out):
        rc = obs_main(["report", str(run_dir), "--json", str(stats_file), *gates])
    if rc != 0:
        raise AssertionError(f"obs report {run_dir} exited {rc}:\n{out.getvalue()}")
    return out.getvalue(), json.loads(stats_file.read_text())["stats"]


def report_section(text: str, title: str) -> list:
    """The lines of one ``== title ==`` section of a report."""
    lines = text.splitlines()
    start = lines.index(f"== {title} ==") + 1
    end = next((i for i in range(start, len(lines)) if lines[i].startswith("== ")), len(lines))
    return lines[start:end]


def check_mfu(records: list, where: str, mfu_section: list) -> int:
    """Every step record carries the telemetry's ``mfu``, equal to its
    ``achieved_tflops`` over the H100's 989.4 TFLOP/s and within MFU_RTOL
    of the record's ``palm_mfu``, and the report's MFU section reads it.
    Returns the number of records held."""
    from scaling_tpu_torch.models.transformer.utils.get_tflops import H100_BF16_TFLOPS

    steps = [r["metrics"] for r in records if "loss" in r["metrics"]]
    for m in steps:
        if not {"mfu", "achieved_tflops", "palm_mfu"} <= set(m):
            raise AssertionError(f"{where}: a step record without mfu/palm_mfu: {sorted(m)}")
        if not math.isclose(m["mfu"], m["achieved_tflops"] / H100_BF16_TFLOPS, rel_tol=1e-9):
            raise AssertionError(f"{where}: mfu {m['mfu']} is not achieved_tflops / 989.4")
        if not math.isclose(m["mfu"], m["palm_mfu"], rel_tol=MFU_RTOL):
            raise AssertionError(f"{where}: mfu {m['mfu']} vs palm_mfu {m['palm_mfu']}")
    if not steps:
        raise AssertionError(f"{where}: no step records")
    if not mfu_section or not mfu_section[0].strip().startswith("mfu: mean="):
        raise AssertionError(f"{where}: the report's MFU section reads {mfu_section}")
    return len(steps)


def observe_supervised(run_dir: Path, k: int) -> None:
    """Phase 10 (a): ``obs report`` over phase 9's run directory shows the
    step-time and MFU sections, the asynchronous saves' ``ckpt.*`` spans
    and, in the timeline, the SIGTERM relayed to run A and run B's
    relaunch."""
    text, stats = obs_report(run_dir)
    keep("observe_supervised_report.txt", text)
    steps = report_section(text, "step time")
    mfu = report_section(text, "mfu / throughput")
    held = sum(check_mfu(metric_records(f), f.parent.name, mfu)
               for f in sorted(run_dir.glob("logs_*/metrics_rank_0.jsonl")))
    commits = report_section(text, "checkpoint commits")
    timeline = report_section(text, "restart / preemption timeline")
    for line in steps + mfu + commits + timeline[-1:]:
        print(f"  report | {line.strip()}")
    if not steps[0].strip().startswith("host 0: n=6 "):
        raise AssertionError(f"the step-time section lacks the 6 steps:\n{text}")
    by_step = {int(line.split(":")[0].split()[-1]): line for line in commits}
    for step in (3, k, 6):
        line = by_step.get(step, "")
        if not all(f"{phase}=" in line for phase in ("save", "stage", "manifest", "rename",
                                                      "latest")):
            raise AssertionError(f"checkpoint section lacks step {step}'s ckpt spans:\n{text}")
    events = [re.match(r"\s*\+\s*[\d.]+s (\S+)", line).group(1) for line in timeline[:-1]]
    if events.count("preempt-relay") != 1 or events.count("relaunch") != 1 or \
            "restarts=1 preemptions=1 stalls=0" not in timeline[-1]:
        raise AssertionError(f"the timeline lacks the SIGTERM or the resume:\n{text}")
    print(f"  {held} step records: mfu = achieved_tflops / 989.4, within {MFU_RTOL} of "
          f"palm_mfu; p50 step time {stats['step_time_p50'] * 1e3:.2f}ms")


def check_no_added_sync(trainer) -> dict:
    """One more step dispatched and left in flight, then a span's emission,
    ``telemetry.on_step`` and ``telemetry.flush`` under
    ``torch.cuda.set_sync_debug_mode("error")`` with ``torch.cuda.synchronize``
    trapped: any device sync they make raises."""
    from scaling_tpu_torch.obs import span

    batch = trainer.batch_to_model_input(trainer._next_micro_batches(), trainer.device)
    torch.cuda.synchronize()
    loss, _, _ = trainer._train_step(batch)
    in_flight = not torch.cuda.current_stream().query()
    sync = torch.cuda.synchronize

    def trapped(*a, **kw):
        raise AssertionError("torch.cuda.synchronize on the telemetry path")

    step = trainer.context.iterations + 1
    torch.cuda.synchronize = trapped
    torch.cuda.set_sync_debug_mode("error")
    try:
        with span("observe.no_sync", step=step):
            pass
        derived = trainer.telemetry.on_step(step, 0.08)
        trainer.telemetry.flush(step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize = sync
    still = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    if not math.isfinite(float(loss)):
        raise AssertionError("the in-flight step's loss is not finite")
    return {"in_flight": in_flight, "still_in_flight": still, "derived": derived}


def obs_host_costs(trainer) -> dict:
    """Host cost of the telemetry with the events file on: an empty span
    (histogram update, JSON line, one write) and ``on_step`` + ``flush``
    (gauges, allocator query, one registry snapshot appended), mean ms over
    OBSERVE's repetitions, on the host clock."""
    from scaling_tpu_torch.obs import span

    t0 = time.perf_counter()
    for i in range(OBSERVE["span_reps"]):
        with span("observe.cost", step=i):
            pass
    span_ms = (time.perf_counter() - t0) * 1e3 / OBSERVE["span_reps"]
    step = trainer.context.iterations + 2
    t0 = time.perf_counter()
    for _ in range(OBSERVE["telemetry_reps"]):
        trainer.telemetry.on_step(step, 0.08)
        trainer.telemetry.flush(step)
    telemetry_ms = (time.perf_counter() - t0) * 1e3 / OBSERVE["telemetry_reps"]
    return {"span_ms": span_ms, "telemetry_ms": telemetry_ms}


class _NullMetric:
    def inc(self, *a, **kw):
        pass

    set = observe = inc


class _NullRegistry:
    """A registry that records nothing and writes nothing."""

    def _metric(self, *a, **kw):
        return _NullMetric()

    counter = gauge = histogram = _metric

    def flush_step(self, step):
        pass


@contextlib.contextmanager
def obs_stubbed(trainer=None):
    """The obs calls of the Trainer's step and of the serving path made
    no-ops for the body: spans, trace contexts, the registry (an engine
    built inside takes a null one; the bench's one flush after its run
    stays), ``log_event`` and, with ``trainer``,
    its telemetry's ``on_step`` and ``flush``. What runs is the path as it
    was before obs, beside which the always-on cost is timed."""
    import scaling_tpu_torch.obs as obs
    from scaling_tpu_torch.logging import logger
    from scaling_tpu_torch.serve import bench
    from scaling_tpu_torch.trainer import trainer as trainer_module

    null = _NullRegistry()

    def null_span(*a, **kw):
        return contextlib.nullcontext()

    patches = [(obs, "span", null_span), (obs, "trace_context", null_span),
               (obs, "current_trace_id", lambda: None), (obs, "get_registry", lambda: null),
               (bench, "span", null_span), (bench, "trace_context", null_span),
               (trainer_module, "span", null_span),
               (logger, "log_event", lambda *a, **kw: None)]
    if trainer is not None:
        patches += [(trainer.telemetry, "on_step", lambda *a, **kw: {}),
                    (trainer.telemetry, "flush", lambda step: None)]
    missing = object()
    saved = [(obj, name, vars(obj).get(name, missing)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            if value is missing:  # an instance's method: unshadow it
                delattr(obj, name)
            else:
                setattr(obj, name, value)


def train_turns(trainer, run_dir: Path) -> dict:
    """The trainer trains on in OBSERVE's turns of ``turn_steps`` steps of
    three kinds: "on", all of obs (spans, ``telemetry.on_step`` and
    ``flush``, the events file); "no_events", without the events file and
    ``on_step`` (the spans and the registry flush stay); "stub", with
    every obs call a no-op (``obs_stubbed``): the step as it was before
    obs. Returns each kind's median step ms, from the ``step_duration`` of
    the turns' records."""
    from scaling_tpu_torch.logging import logger

    config = logger.config
    ms = {kind: [] for kind in dict.fromkeys(OBSERVE["train_turns"])}
    for kind in OBSERVE["train_turns"]:
        logger.configure(dataclasses.replace(
            config, events_path=config.events_path if kind == "on" else None))
        trainer.telemetry.enabled = kind == "on"
        start = trainer.context.iterations
        trainer.config = dataclasses.replace(trainer.config,
                                             train_iterations=start + OBSERVE["turn_steps"])
        with obs_stubbed(trainer) if kind == "stub" else contextlib.nullcontext():
            trainer.run_training()
        ms[kind] += [r["metrics"]["step_duration"] * 1e3 for r in metric_records(
            run_dir / "logs" / "metrics_rank_0.jsonl") if r["step"] > start]
    logger.configure(config)
    trainer.telemetry.enabled = True
    for kind, values in ms.items():
        print(f"  turns obs {kind}: step ms {[round(v, 2) for v in values]}, median "
              f"{statistics.median(values):.2f}")
    return {kind: statistics.median(values) for kind, values in ms.items()}


def check_trace(trace_dir: Path) -> None:
    """The newest Chrome trace under ``trace_dir`` names K4's and K5's
    kernels among its device-kernel events."""
    traces = sorted(trace_dir.glob("*.json"))
    if not traces:
        raise AssertionError(f"no trace under {trace_dir}")
    events = json.loads(traces[-1].read_text()).get("traceEvents", [])
    names = Counter(e.get("name", "") for e in events if e.get("cat") == "kernel")
    flash = {n: c for n, c in names.items() if "flash_" in n}
    print(f"  torch.profiler trace {traces[-1].name}: {len(events)} events, "
          f"{sum(names.values())} kernel events; flash kernels {flash}")
    if not any("flash_fwd" in n for n in flash) or not any("flash_bwd" in n for n in flash):
        raise AssertionError("the profiler window's trace does not name K4 and K5")


def observe_train(bench_step_ms: float, device: str = "cuda") -> dict:
    """Phase 10 (b): a 5-step Trainer run of phase 8's model and data with
    no save and no eval, the events file on, and a profiler window at steps
    2-3 with ``capture_xla_trace``; the launch counters reset just before it
    and read just after. Its observations JSON holds the window's 2 steps,
    the trace names K4's and K5's kernels, ``obs report`` renders its
    step-time and MFU sections, and the no-sync check and the telemetry's
    host costs follow."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import main
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.train.bench import MODELS

    vocab = MODELS[TRAINER["model"]]["vocab_size"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_observe_"))
    try:
        prefixes = write_token_datasets(root, vocab)
        run_dir = root / "run"
        config = trainer_config(prefixes, run_dir / "logs")
        config["trainer"].update(train_iterations=OBSERVE["iterations"], eval_interval=None)
        config["logger"]["events_path"] = str(run_dir / "events.jsonl")
        start, count = OBSERVE["profile"]
        config["profiler"] = {"profile_steps": count, "profile_start_at_step": start,
                              "profiler_output": str(root / "profile" / "observations.json"),
                              "capture_xla_trace": True}
        run_dir.mkdir(parents=True)
        launches.reset()
        trainer = main(TransformerConfig.from_dict(config), device=device)
        torch.cuda.synchronize()
        kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
        print(f"  launches kernel={kernel} plain={plain}")
        check_observe_launches("observed trainer run", kernel, plain,
                               ("rms_norm", "rms_norm_bwd", "flash_attention_fwd",
                                "flash_attention_bwd"))

        observations = json.loads((root / "profile" / "observations.json").read_text())
        print(f"  profiler observations: {observations}")
        if [o["step"] for o in observations] != list(range(start, start + count)) or any(
                set(o) != {"step", "data_load", "step_time"} for o in observations):
            raise AssertionError(f"profiler observations: {observations}")
        check_trace(root / "profile" / "xla_trace")

        records = metric_records(run_dir / "logs" / "metrics_rank_0.jsonl")
        text, _ = obs_report(run_dir)
        keep("observe_train_report.txt", text)
        check_mfu(records, "observed run", report_section(text, "mfu / throughput"))
        tuner = report_section(text, "tuner") if "== tuner ==" in text.splitlines() else []
        for line in (report_section(text, "step time") + report_section(text, "mfu / throughput")
                     + tuner):
            print(f"  report | {line.strip()}")
        window = {start + 1 + i for i in range(count)}  # the window's records
        ms = {r["step"]: r["metrics"]["step_duration"] * 1e3 for r in records
              if "loss" in r["metrics"]}
        outside = [v for s, v in ms.items() if s not in window and s > 1]
        print(f"  step ms with the events file on: {ms} (records {sorted(window)} in the "
              f"profiler window, synchronised); outside it and after step 1: median "
              f"{statistics.median(outside):.2f}ms; phase 5's bench step at "
              f"{MODELS[TRAINER['model']]['num_layers']} layers {bench_step_ms:.2f}ms")

        turns = train_turns(trainer, run_dir)
        sync = check_no_added_sync(trainer)
        print(f"  no sync: a span, telemetry.on_step and telemetry.flush ran under "
              f"set_sync_debug_mode('error') with the step in flight "
              f"(before {sync['in_flight']}, after {sync['still_in_flight']}); "
              f"derived {sorted(sync['derived'])}")
        if not sync["in_flight"] or not sync["still_in_flight"]:
            raise AssertionError("the no-sync check ran with no step in flight")
        costs = obs_host_costs(trainer)
        print(f"  host cost with the events file on: a span {costs['span_ms'] * 1e3:.1f}us, "
              f"telemetry.on_step + flush {costs['telemetry_ms']:.3f}ms")
        trainer.stop_prefetch()
        del trainer
        torch.cuda.empty_cache()
        return {"launches": kernel, "step_ms": statistics.median(outside), "turns": turns,
                **costs}
    finally:
        reset_logger()
        shutil.rmtree(root, ignore_errors=True)


def observe_serve(phase4: dict, model: str = "0.5b", device: str = "cuda",
                  keep_run=None) -> dict:
    """Phase 10 (c): ``serve bench --run-dir`` at phase 4's native traffic,
    the launch counters reset just before it and read just after; its
    report's serving section counts the 32 requests and gives the bench's
    tokens/s within 0.1 %. Then the same bench in OBSERVE's turns of three
    kinds, the first run counting as one with a run directory: "run_dir";
    "none", without one (no file written, the always-on spans, counters
    and gauges stay); "stub", with every obs call a no-op
    (``obs_stubbed``), the engine as it was before obs. Returns the
    launches and each kind's median tokens/s and wall clock a tick; the
    run directory is copied to ``keep_run`` when given (phase 18 (b)
    calibrates the serving tuner from it)."""
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.serve.bench import main as bench_main

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_observe_serve_"))
    try:
        run_dir = root / "run"
        base = bench_base(model, device)
        launches.reset()
        rc = bench_main(base + ["--run-dir", str(run_dir), "--json", str(root / "stats.json")])
        torch.cuda.synchronize()
        kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
        stats = json.loads((root / "stats.json").read_text())
        print(f"  launches kernel={kernel} plain={plain}")
        if rc != 0 or stats["completed"] != WORKLOAD["n_requests"]:
            raise AssertionError(f"serve bench --run-dir: rc {rc}, stats {stats}")
        check_observe_launches("serve bench --run-dir", kernel, plain,
                               ("paged_attention", "rms_norm"))
        text, report = obs_report(run_dir)
        keep("observe_serve_report.txt", text)
        serving = report_section(text, "serving")
        for line in serving:
            print(f"  report | {line.strip()}")
        events = [json.loads(line) for line in (run_dir / "events.jsonl").read_text()
                  .splitlines()]
        requests = sum(1 for e in events if e["event"] == "serve-request")
        if requests != WORKLOAD["n_requests"] or \
                f"{WORKLOAD['n_requests']} request(s))" not in serving[0]:
            raise AssertionError(f"the serving section counts {requests} requests:\n{text}")
        rel = abs(report["serve_tokens_per_s"] - stats["tokens_per_s"]) / stats["tokens_per_s"]
        if not rel <= 1e-3:
            raise AssertionError(f"report tokens/s {report['serve_tokens_per_s']} vs the "
                                 f"bench's {stats['tokens_per_s']}")
        ticks = [e["dur_s"] for e in events if e.get("span") == "serve.tick"]
        tick_ms = stats["wall_s"] / stats["ticks"] * 1e3
        print(f"  with the run directory: {stats['tokens_per_s']:.1f} output tokens/s (the "
              f"report's {report['serve_tokens_per_s']:.1f}, rel. diff {rel:.1e}), wall per "
              f"tick {tick_ms:.3f}ms, serve.tick span median "
              f"{statistics.median(ticks) * 1e3:.3f}ms over {len(ticks)}; phase 4: "
              f"{phase4['tokens_per_s']:.1f} tokens/s, wall per tick "
              f"{phase4['wall_s'] / phase4['ticks'] * 1e3:.3f}ms")
        turns = {"run_dir": [stats], "none": [], "stub": []}
        for i, kind in enumerate(OBSERVE["serve_turns"]):
            out = root / f"stats_{i}.json"
            extra = ["--run-dir", str(root / f"run_{i}")] if kind == "run_dir" else []
            with obs_stubbed() if kind == "stub" else contextlib.nullcontext():
                rc = bench_main(base + extra + ["--json", str(out)])
            if rc != 0:
                raise AssertionError(f"serve bench turn {i} ({kind}) failed")
            turns[kind].append(json.loads(out.read_text()))
        summary = {kind: {"tokens_per_s": statistics.median(t["tokens_per_s"] for t in runs),
                          "tick_ms": statistics.median(t["wall_s"] / t["ticks"] * 1e3
                                                       for t in runs)}
                   for kind, runs in turns.items()}
        for kind, runs in turns.items():
            print(f"  turns {kind}: tokens/s "
                  f"{[round(t['tokens_per_s'], 1) for t in runs]}, wall per tick ms "
                  f"{[round(t['wall_s'] / t['ticks'] * 1e3, 3) for t in runs]}")
        from scaling_tpu_torch.serve.journal import replay_journal

        tokens = in_order(replay_journal(run_dir / "journal.jsonl").completed)
        if keep_run is not None:
            shutil.copytree(run_dir, keep_run)
        return {"launches": kernel, "turns": summary, "tokens": tokens}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------ supervised relaunch
def relaunch_supervisor(spec_file: str) -> int:
    """Phase 11's supervisor, in a process of its own, as a user runs one:
    the spec's training config read by ``TransformerConfig`` and
    ``runner_main(config.runner, payload)``. Writes its exit code and
    whether this process initialised CUDA (it must not: the card's memory
    is the workers') to ``result_path``."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.runner import runner_main

    spec = json.loads(Path(spec_file).read_text())
    rc = runner_main(TransformerConfig.from_dict(spec["payload"]).runner, spec["payload"])
    Path(spec["result_path"]).write_text(json.dumps({
        "rc": rc, "cuda_initialized": torch.cuda.is_initialized()}))
    return rc


def relaunch_worker() -> int:
    """A worker of phase 11, which the supervisor launches as ``python -m
    chip_smoke --payload=...``: the port's ``worker_main`` on the card of
    its slot (``CHIP_SMOKE_WORKER_DEVICE`` names another device), plus a
    record at its start (the card's free memory before the model is built)
    and one after each step (the loss, the launch counters, the newest
    heartbeat's time, the checkpoint load's), then phase 9's pause. A
    SIGKILLed worker writes nothing at its exit, so the records, appended
    to ``CHIP_SMOKE_RECORDS``, are written as it goes."""
    from scaling_tpu_torch.logging.logger import append_jsonl_line
    from scaling_tpu_torch.models.transformer import train
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.trainer import BaseTrainer

    device, records = os.environ.get("CHIP_SMOKE_WORKER_DEVICE"), os.environ["CHIP_SMOKE_RECORDS"]
    start = {"epoch": int(os.environ["SCALING_TPU_COORD_EPOCH"]), "t_start": time.time(),
             "free": None if device else torch.cuda.mem_get_info()[0], "load": None}
    append_jsonl_line(records, json.dumps({"kind": "start", **start}))
    load, build = BaseTrainer.load_checkpoint, train.build_trainer

    def timed_load(trainer, *a, **kw):
        t0 = time.time()
        loaded = load(trainer, *a, **kw)
        start["load"] = (t0, time.time())
        return loaded

    def build_with_records(config, device=None, glue=None):
        trainer = build(config, device, glue=glue)

        def record(metrics, step):
            cp = trainer._control_plane
            append_jsonl_line(records, json.dumps({
                "kind": "step", **start, "step": step, "loss": metrics["loss"], "t": time.time(),
                "hb_wall": cp.peer_heartbeats()[cp.host_id].wall,
                "kernel": dict(launches.KERNEL), "plain": dict(launches.PLAIN)}))
            time.sleep(SUPERVISE["pause_s"])

        trainer.metrics_hooks.append(record)
        return trainer

    BaseTrainer.load_checkpoint, train.build_trainer = timed_load, build_with_records
    train.worker_main(device=device)
    return 0


def start_supervisor(root: Path, name: str, payload: dict, env: dict) -> subprocess.Popen:
    """``relaunch_supervisor`` in a new session (its workers in its process
    group), its output and its workers' in ``root/<name>.log``."""
    spec = root / f"{name}.json"
    spec.write_text(json.dumps({"payload": payload,
                                "result_path": str(root / f"{name}_result.json")}))
    with open(root / f"{name}.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--supervise-runner", str(spec)],
            cwd=Path(__file__).resolve().parent, env={**os.environ, **env}, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)


def stop_supervisor(proc: subprocess.Popen) -> None:
    """Kill a supervisor and its workers, if any of them is left."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)  # a worker whose supervisor is gone


def read_jsonl(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()] if path.is_file() else []


def run_relaunch(root: Path, prefixes: dict, device: str) -> None:
    """Phase 11's two supervisors over one control root and save directory.
    The first runs with the faults and gets a real SIGTERM once epoch 2's
    step-``drain_after`` record is written; the second, without faults,
    resumes to the end. Each under a hard time limit; nothing outlives the
    call."""
    save_dir, run_dir = root / "ckpt", root / "obs"
    payload = trainer_config(prefixes, run_dir / "logs", save_dir=save_dir, load_dir=save_dir)
    payload["trainer"]["assert_checkpoint_loaded"] = False
    payload["runner"] = {"hosts": ["localhost"], "default_gpu_count": 1, "script": "chip_smoke",
                         "supervise": True, "control_dir": str(root / "control"),
                         **RELAUNCH["runner"]}
    device_env = {} if device == "cuda" else {"CHIP_SMOKE_WORKER_DEVICE": device}
    for name, faults, timeout in (("supervisor", RELAUNCH["faults"], RELAUNCH["timeout_s"]),
                                  ("resume", "", RELAUNCH["resume_timeout_s"])):
        records = root / f"{name}_records.jsonl"
        (run_dir / name).mkdir(parents=True)
        proc = start_supervisor(root, name, payload, {
            **device_env, "SCALING_TPU_FAULTS": faults, "CHIP_SMOKE_RECORDS": str(records),
            "SCALING_TPU_EVENTS_PATH": str(run_dir / name / "events.jsonl")})
        deadline = time.monotonic() + timeout
        try:
            while faults and not any(r.get("epoch") == 2 and r.get("step") == RELAUNCH[
                    "drain_after"] for r in read_jsonl(records)):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"{name}: no epoch-2 step-{RELAUNCH['drain_after']} "
                                         f"record before the supervisor ended or the limit:\n"
                                         f"{(root / f'{name}.log').read_text()[-4000:]}")
                time.sleep(0.01)
            if faults:
                proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name}: the supervisor outlived its {timeout}s limit:\n"
                                     f"{(root / f'{name}.log').read_text()[-4000:]}")
        finally:
            stop_supervisor(proc)
        if faults:  # the second supervisor reuses epoch-0, whose abort flag this one left
            (root / "abort_left").write_text(str((root / "control" / "epoch-0" / "flags" /
                                                  "abort").is_file()))


def supervisor_events(run_dir: Path) -> list:
    """The supervisor's lifecycle events of one run, in order."""
    names = ("epoch-start", "host-dead", "teardown-complete", "relaunch", "preempt-relay",
             "epoch-clean-exit", "epoch-stalled", "give-up")
    return [e for e in read_jsonl(run_dir / "events.jsonl") if e["event"] in names]


RELAUNCH_EVENTS = {  # the supervisors' events in order: (event, the fields that must hold)
    "supervisor": [("epoch-start", {"epoch": 0}),
                   ("host-dead", {"epoch": 0, "reason": "exit", "exit_codes": {"0": -9}}),
                   ("teardown-complete", {"killed_pids": []}),
                   ("relaunch", {"epoch": 1, "restarts": 1}), ("epoch-start", {"epoch": 1}),
                   ("host-dead", {"epoch": 1, "reason": "heartbeat-stale", "hosts": [0]}),
                   ("teardown-complete", {}), ("relaunch", {"epoch": 2, "restarts": 2}),
                   ("epoch-start", {"epoch": 2}), ("preempt-relay", {"epoch": 2}),
                   ("epoch-clean-exit", {"epoch": 2, "preempted": True})],
    "resume": [("epoch-start", {"epoch": 0}),
               ("epoch-clean-exit", {"epoch": 0, "preempted": False})],
}


def check_relaunch(root: Path, gold: list) -> dict:
    """Phase 11's checks over ``run_relaunch``'s output: each supervisor's
    events in order and its exit 0 without CUDA; each epoch's losses
    (bitwise through its first step, within RESUME_RTOL after), launches
    (K2-K5, no plain version) and free memory (within ``free_tol`` of
    epoch 0's); the stale epoch-0 directory wiped; ``global_step6``;
    ``obs report`` with 2 relaunches, the drain's preemption events and
    ``--assert-max-resizes 0``. Prints the time to recover from the crash
    and from the hang, split, and the silent stretches the timeouts budget.
    Returns the summed launch counts and the time to recover."""
    from scaling_tpu_torch.resilience import verify_checkpoint

    run_dir, epochs = root / "obs", {}
    for name, expected in RELAUNCH_EVENTS.items():
        result = json.loads((root / f"{name}_result.json").read_text())
        print(f"  {name}: exit {result['rc']}, torch.cuda.is_initialized() at its end: "
              f"{result['cuda_initialized']}")
        if result != {"rc": 0, "cuda_initialized": False}:
            raise AssertionError(f"{name}: {result} (exit 0 without initialising CUDA wanted)")
        events = supervisor_events(run_dir / name)
        got = [e["event"] for e in events]
        if got != [e for e, _ in expected] or any(
                {k: e.get(k) for k in fields} != fields
                for e, (_, fields) in zip(events, expected)):
            raise AssertionError(f"{name}: events {events}, wanted {expected}")
        if name == "supervisor" and not events[6]["killed_pids"]:
            raise AssertionError(f"the hung worker was not SIGKILLed: {events[6]}")
        for r in read_jsonl(root / f"{name}_records.jsonl"):
            ep = epochs.setdefault((name, r["epoch"]), {"start": None, "steps": [],
                                                        "events": events})
            if r["kind"] == "start":
                ep["start"] = r
            else:
                ep["steps"].append(r)
    steps = {key: [r["step"] for r in ep["steps"]] for key, ep in epochs.items()}
    k = max(steps[("supervisor", 2)])
    want = {("supervisor", 0): [1, 2, 3, 4], ("supervisor", 1): [4],
            ("supervisor", 2): list(range(4, k + 1)), ("resume", 0): list(range(k + 1, 7))}
    if steps != want or k not in (5, 6):
        raise AssertionError(f"steps by epoch {steps}, wanted {want} with k 5 or 6")
    # bitwise: epoch 0's steps (phase 8's start), and the first step of each
    # epoch resumed from global_step3 (phase 8's state and batch); the steps
    # after a resumed step within RESUME_RTOL (the embedding backward adds
    # with atomics)
    bitwise = {("supervisor", 0): 4, ("supervisor", 1): 1, ("supervisor", 2): 1, ("resume", 0): 0}
    for key, ep in epochs.items():
        losses = [r["loss"] for r in ep["steps"]]
        ref = [gold[s - 1] for s in steps[key]]
        n = bitwise[key]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses[n:], ref[n:])]
        print(f"  {key[0]} epoch {key[1]}: steps {steps[key]} losses {losses}; the first {n} "
              f"bitwise, then rel. diff {rel} (rtol {RESUME_RTOL})")
        if losses[:n] != ref[:n] or not all(x <= RESUME_RTOL for x in rel):
            raise AssertionError(f"{key}: losses {losses} vs phase 8's {ref}")
    for key, ep in epochs.items():
        last = ep["steps"][-1] if ep["steps"] else None
        print(f"  {key[0]} epoch {key[1]}: free memory at the worker's start "
              f"{ep['start']['free']}, launches "
              f"{'no step' if last is None else last['kernel']}, plain "
              f"{'-' if last is None else last['plain']}")
        if last is not None:
            check_relaunch_launches(key, last["kernel"], last["plain"])
    check_free_memory(epochs)
    if (root / "abort_left").read_text() != "True" or \
            (root / "control" / "epoch-0" / "flags" / "abort").is_file():
        raise AssertionError("the second supervisor did not wipe the stale epoch-0 directory")
    step6 = root / "ckpt" / "global_step6"
    if verify_checkpoint(step6) or (root / "ckpt" / "latest").read_text() != "global_step6":
        raise AssertionError(f"global_step6: {verify_checkpoint(step6)}")
    print(f"  drained at k={k}; the second supervisor wiped epoch-0's stale abort flag and "
          "resumed to step 6; global_step6 verifies")
    text, _ = obs_report(run_dir, "--assert-max-resizes", "0")
    keep("relaunch_report.txt", text)
    totals = report_section(text, "restart / preemption timeline")[-1]
    print(f"  report | {totals.strip()}")
    # the report counts the supervisor's preempt-relay and, unless the
    # worker had reached its last step, its preempt-broadcast
    if f"restarts=2 preemptions={1 + (k < 6)} stalls=0" not in totals:
        raise AssertionError(f"the report's timeline: {totals}")
    recover = time_to_recover(epochs)
    kernel = Counter()
    for ep in epochs.values():
        if ep["steps"]:
            kernel.update(ep["steps"][-1]["kernel"])
    return {"launches": dict(kernel), "recover": recover}


def check_relaunch_launches(key: tuple, kernel: dict, plain: dict) -> None:
    needed = ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd")
    if any(kernel.get(k, 0) <= 0 for k in needed) or sum(plain.values()):
        raise AssertionError(f"relaunch {key}: launches kernel={kernel} plain={plain}")


def check_free_memory(epochs: dict) -> None:
    """Each epoch's worker found the card's free memory that epoch 0's did,
    within ``free_tol``: a dead or hung worker's memory was given back."""
    base = epochs[("supervisor", 0)]["start"]["free"]
    if base is None:  # not on the card
        return
    for key, ep in epochs.items():
        if abs(ep["start"]["free"] - base) > RELAUNCH["free_tol"]:
            raise AssertionError(f"{key}: {ep['start']['free']} bytes free, epoch 0 had {base}")


def time_to_recover(epochs: dict) -> dict:
    """For the crash (epoch 0 -> 1) and the hang (1 -> 2): the fault (the
    last step record and the pause after it) to the relaunched worker's
    first step record, split into detection (to ``host-dead``), teardown
    (to ``teardown-complete``), backoff (to the next ``epoch-start``: the
    ``relaunch`` event, the sleep and the spawn), the worker's start to its
    first heartbeat (of which the checkpoint's load), and the step
    replayed (the first heartbeat to the first record). Also the timeouts'
    measurements: each epoch's start to its first heartbeat, and the
    longest gap between two heartbeats that step records saw."""
    events = epochs[("supervisor", 0)]["events"]
    ts = {(e["event"], e.get("epoch")): e["ts"] for e in events}
    dead = [e for e in events if e["event"] == "host-dead"]
    torn = [e for e in events if e["event"] == "teardown-complete"]
    out = {}
    for what, e in (("crash", 0), ("hang", 1)):
        last, nxt = epochs[("supervisor", e)]["steps"][-1], epochs[("supervisor", e + 1)]
        fault = last["t"] + SUPERVISE["pause_s"]
        first = nxt["steps"][0]
        split = {"detection": dead[e]["ts"] - fault, "teardown": torn[e]["ts"] - dead[e]["ts"],
                 "backoff": ts[("epoch-start", e + 1)] - torn[e]["ts"],
                 "start_to_heartbeat": first["hb_wall"] - ts[("epoch-start", e + 1)],
                 "of_which_load": first["load"][1] - first["load"][0],
                 "step_replayed": first["t"] - first["hb_wall"]}
        split["total"] = first["t"] - fault
        out[what] = split
        print(f"  time to recover from the {what}: {split['total']:.2f}s = detection "
              f"{split['detection']:.2f} + teardown {split['teardown']:.2f} + backoff "
              f"{split['backoff']:.2f} + start to first heartbeat "
              f"{split['start_to_heartbeat']:.2f} (checkpoint load "
              f"{split['of_which_load']:.2f}) + step {first['step']} replayed "
              f"{split['step_replayed']:.2f}")
    starts = {}
    for (name, e), ep in epochs.items():
        if ep["steps"]:
            begin = [x["ts"] for x in ep["events"] if x["event"] == "epoch-start"
                     and x["epoch"] == e][0]
            starts[f"{name}{e}"] = round(ep["steps"][0]["hb_wall"] - begin, 2)
    gaps = [b["hb_wall"] - a["hb_wall"] for ep in epochs.values()
            for a, b in zip(ep["steps"], ep["steps"][1:])]
    runner = RELAUNCH["runner"]
    print(f"  timeouts: startup_grace_seconds {runner['startup_grace_seconds']} against each "
          f"epoch's start to first heartbeat {starts}s; heartbeat_timeout_seconds "
          f"{runner['heartbeat_timeout_seconds']} against the longest gap between two "
          f"heartbeats {max(gaps):.2f}s (a save and its eval)")
    out["start_to_heartbeat"], out["max_heartbeat_gap"] = starts, max(gaps)
    return out


def relaunch_phase(trainer_run: dict, device: str = "cuda") -> dict:
    """Phase 11: phase 8's Trainer under the supervisor through a crash, a
    hang and a drain, and a second supervisor resuming to the end (see the
    module's docstring), held against phase 8's losses. Returns the
    workers' launch counts."""
    from scaling_tpu_torch.train.bench import MODELS

    vocab = MODELS[TRAINER["model"]]["vocab_size"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_relaunch_"))
    try:
        free = shutil.disk_usage(root).free
        need = checkpoint_need(3)
        print(f"  temporary directory {root}: {free / 1e9:.1f} GB free, three checkpoints need "
              f"~{need / 1e9:.1f} GB")
        if free < need:
            raise AssertionError(f"not enough disk for three checkpoints under {root}")
        prefixes = write_token_datasets(root, vocab)
        if device == "cuda":
            torch.cuda.empty_cache()  # this process's cache is not the workers' to lose
        t0 = time.monotonic()
        run_relaunch(root, prefixes, device)
        seconds = time.monotonic() - t0
        result = check_relaunch(root, trainer_run["losses"])
        print(f"  the two supervisors ran {seconds:.1f}s")
        return {**result, "seconds": seconds}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ finetune
def finetune_config(base: dict, log_dir: Path, save_dir=None, load_dir=None,
                    prob_dropout: float = 0.0, iterations=None) -> dict:
    """Phase 12's training config: phase 8's model, optimizer and token data
    with LoRA on query, key, value and dense, dropout 0.1 after the
    embedding, the attention and the MLP, only the LoRA trained."""
    cfg = trainer_config({**base["prefixes"], "valid": None}, log_dir, save_dir=save_dir,
                         load_dir=load_dir or base["ckpt"])
    cfg["transformer_architecture"].update(
        lora_config=FINETUNE["lora"], dropout_embedding=FINETUNE["dropout"],
        dropout_after_attention=FINETUNE["dropout"], dropout_after_mlp=FINETUNE["dropout"],
        dropout_attention_probs=prob_dropout)
    cfg["training"] = {"finetune": True}
    cfg["data"].pop("validation_data_prefixes")
    cfg["trainer"].update(eval_interval=None, eval_iterations=0,
                          train_iterations=iterations or FINETUNE["iterations"],
                          save_interval=FINETUNE["interval"])
    if load_dir is None:  # from the base: fresh LoRA leaves and optimizer, step 0
        cfg["trainer"].update(load_optimizer_states=False, load_context=False,
                              allowed_missing_keys_in_checkpoint=[".*_lora\\."])
    return cfg


def lora_state(trainer) -> dict:
    """Host copies of the LoRA leaves and their f32 optimizer state."""
    opt = trainer.optimizer.state
    out = {f"param.{n}": p.detach().to("cpu", copy=True)
           for n, p in trainer.module.model.named_parameters() if "_lora." in n}
    for field in ("master", "exp_avg", "exp_avg_sq"):
        out.update({f"{field}.{n}": t.to("cpu", copy=True)
                    for n, t in getattr(opt, field).items()})
    return out


def restore_lora_state(trainer, state: dict, step: int) -> None:
    params = dict(trainer.module.model.named_parameters())
    opt = trainer.optimizer.state
    with torch.no_grad():
        for key, value in state.items():
            field, name = key.split(".", 1)
            target = params[name] if field == "param" else getattr(opt, field)[name]
            target.copy_(value)
    opt.step = step


def remat_check(trainer, batch: dict, key: tuple, device: str) -> dict:
    """One step of ``trainer`` on ``batch`` under dropout ``key`` without
    remat, with ``every_layer`` and with ``every_layer_save_dots``, each from
    the same state: the losses bitwise, the f32 LoRA masters within
    REMAT_TOL of the run without remat, the bf16 LoRA leaves compared."""
    from scaling_tpu_torch.topology import ActivationCheckpointingType as Remat

    start, step = lora_state(trainer), trainer.optimizer.state.step
    topology = trainer.module.topology
    runs = []
    for ckpt in (Remat.DISABLED, Remat.EVERY_LAYER, Remat.EVERY_LAYER_SAVE_DOTS):
        restore_lora_state(trainer, start, step)
        trainer.module.topology = dataclasses.replace(topology, activation_checkpointing_type=ckpt)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        loss = float(trainer._train_step(batch, key)[0])
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        runs.append((loss, lora_state(trainer), peak))
    trainer.module.topology = topology
    (_, after0, _), *others = runs
    master = max((after0[k] - after[k]).abs().max().item() for _, after, _ in others
                 for k in after0 if k.startswith("master."))
    param = max((after0[k].float() - after[k].float()).abs().max().item()
                for _, after, _ in others for k in after0 if k.startswith("param."))
    moved = max((after0[k] - start[k]).abs().max().item() for k in after0
                if k.startswith("master."))
    return {"loss": tuple(r[0] for r in runs), "master_diff": master, "param_diff": param,
            "update": moved, "peak": tuple(r[2] for r in runs)}


def host_and_device_ms(step, batch: dict, n: int = 3) -> dict:
    """Where a finetune step's time goes: the host's dispatch (the step's
    call returns once its kernels are queued) against the step with its
    device sync, over ``n`` steps (medians), and one profiled step's device
    busy time, idle share and device ms by kernel group."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        step(batch)
        t1 = time.monotonic()
        torch.cuda.synchronize()
        times.append(((t1 - t0) * 1e3, (time.monotonic() - t0) * 1e3))
    return {"dispatch_ms": statistics.median(t for t, _ in times),
            "step_ms": statistics.median(t for _, t in times),
            **profile_train_step(step, batch)}


def served_vs_generated(inf, engine_tokens: dict, work: list) -> dict:
    """The engine's greedy tokens against ``generate``'s on the same
    prompts. Equal, or the first token where they part is a near tie: the
    card's full-sequence logits there (``logits()`` over the prompt and the
    engine's tokens before it) put the two candidates within TICK_TOL of
    max |logit| of each other, the tolerance the paged and the dense paths
    are held to against f32."""
    prompts = [p for _, p, _ in work]
    outs = inf.generate(prompts, max_tokens=max(n for _, _, n in work))
    equal, ties = 0, []
    for i, ((_, prompt, n), out) in enumerate(zip(work, outs)):
        got, want = engine_tokens[i], list(out.completion_ids[:n])
        if len(got) != n:
            raise AssertionError(f"served request {i}: {len(got)} of {n} tokens")
        t = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if t is None:
            equal += 1
            continue
        logits = inf.logits(prompt + got[:t])[0, -1].float()
        gap = abs(logits[got[t]] - logits[want[t]]).item()
        ties.append((i, t, gap, logits.abs().max().item()))
        if not gap <= TICK_TOL * ties[-1][3]:
            raise AssertionError(f"served request {i} parts from generate at token {t} with "
                                 f"a logit gap {gap} > {TICK_TOL} x max|logit|")
    return {"equal": equal, "ties": ties}


def finetune_phase(base: dict, device: str = "cuda") -> dict:
    """Phase 12: (a) a LoRA finetune of phase 8's step-6 checkpoint with
    dropout, (b) its resume from step 3 and one step with and without
    remat, (c) 2 steps with attention-probability dropout, unfused, (d) the
    step-6 checkpoint merged on load against the unmerged model on the
    CPU, and served against ``generate``, (e) one dropout call at training
    size. The launch counters reset just before (a) and read after (d)."""
    from scaling_tpu_torch.checkpoint import load_model_checkpoint
    from scaling_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerInferenceModule,
        TransformerModel,
    )
    from scaling_tpu_torch.models.transformer.train import build_trainer, main
    from scaling_tpu_torch.nn.base_layer import DropoutContext, dropout_key
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.parallel import ParallelModule
    from scaling_tpu_torch.parallel.parallel_module import jax_param_key
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import sample_workload

    t_phase = time.monotonic()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_finetune_"))
    lora_dir = root / "lora"
    n = FINETUNE["iterations"]
    try:
        # (a) the finetune from phase 8's step-6 checkpoint
        loaded = {}

        def on_load(trainer):
            loaded.update({k: v.detach().to("cpu", copy=True)
                           for k, v in trainer.module.model.named_parameters()
                           if "_lora." not in k})

        launches.reset()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with TrainerProbe(snapshot_at=FINETUNE["interval"], on_load=on_load) as first:
            trainer = main(TransformerConfig.from_dict(finetune_config(
                base, root / "logs_a", save_dir=lora_dir)), device=device)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        steps = metric_records(root / "logs_a" / "metrics_rank_0.jsonl")
        losses = [r["metrics"]["loss"] for r in steps]
        if [r["step"] for r in steps] != list(range(1, n + 1)) or not all(np.isfinite(losses)):
            raise AssertionError(f"finetune steps {[r['step'] for r in steps]} losses {losses}")
        model = trainer.module.model
        params = dict(model.named_parameters())
        lora_names = sorted(k for k in params if "_lora." in k)
        groups = [(g.name, sorted(g.keys)) for g in trainer.optimizer.parameter_groups]
        # the membership tests/test_torch_peft.py pins against the JAX
        # package: under finetune the LoRA leaves alone, none decayed
        if groups != [("no_weight_decay_params", lora_names)] or sorted(
                trainer.optimizer.state.master) != lora_names:
            raise AssertionError(f"parameter groups {[(g, len(k)) for g, k in groups]}, "
                                 f"optimizer states {len(trainer.optimizer.state.master)}")
        frozen_moved = [k for k, v in loaded.items() if not torch.equal(params[k].cpu(), v)]
        if len(loaded) != len(params) - len(lora_names) or frozen_moved:
            raise AssertionError(f"frozen leaves moved: {frozen_moved[:5]}")
        b_moved = [k for k in lora_names if k.endswith("lora_b") and not params[k].any()]
        if b_moved:
            raise AssertionError(f"LoRA B still zero: {b_moved[:5]}")
        delta = max((model.layers[f"layer_{i}"].attention.query_lora.get_delta_weights().float()
                     .norm() / model.layers[f"layer_{i}"].attention.query.weight.float().norm())
                    .item() for i in range(1, model.architecture.num_layers + 1))
        final = lora_state(trainer)
        step_ms = statistics.median(r["metrics"]["step_duration"] for r in steps[1:]) * 1e3
        tokens_per_s = TRAINER["mbs"] * TRAINER["seq"] / (step_ms / 1e3)
        size = dir_bytes(lora_dir / f"global_step{n}")
        print(f"  (a) LoRA rank {FINETUNE['lora']['rank']} alpha {FINETUNE['lora']['alpha']} "
              f"dropout {FINETUNE['lora']['dropout']} on q/k/v/dense, dropout "
              f"{FINETUNE['dropout']} after the embedding, attention and MLP: losses {losses}")
        print(f"  (a) {len(lora_names)} LoRA leaves of {sum(params[k].numel() for k in lora_names)}"
              f" parameters trained (one no-decay group, optimizer state for them alone); "
              f"{len(loaded)} frozen leaves bitwise equal to phase 8's checkpoint; every B "
              f"moved, largest |dW_query| / |W_query| {delta:.3e}")
        ref_peak = base.get("peak_bytes")
        print(f"  (a) step (median of steps 2-{n}, host clock to the loss's fetch) "
              f"{step_ms:.2f}ms tokens/s={tokens_per_s:.1f}; phase 8's {base['step_ms']:.2f}ms; "
              f"peak max_memory_allocated "
              + ("not measured (no card)" if peak is None else
                 f"{peak / 1e9:.2f}GB, phase 8's {ref_peak / 1e9:.2f}GB")
              + f"; the step-{n} checkpoint {size} bytes")
        del trainer, model, params
        if device == "cuda":
            torch.cuda.empty_cache()

        # (b) the resume from step 3, then one step with and without remat
        def check_loaded(trainer):
            now = lora_state(trainer)
            ref = {k: v for k, v in first.snapshot.items()
                   if "_lora." in k and (k.startswith("param.") or k.split(".")[0] in
                                         ("master", "exp_avg", "exp_avg_sq"))}
            if now.keys() != ref.keys() or any(not torch.equal(v, ref[k])
                                               for k, v in now.items()):
                raise AssertionError("the resumed LoRA state differs from step 3's")

        with TrainerProbe(on_load=check_loaded):
            resumed = main(TransformerConfig.from_dict(finetune_config(
                base, root / "logs_b", load_dir=lora_dir / f"global_step{FINETUNE['interval']}")),
                device=device)
        again = [r["metrics"]["loss"]
                 for r in metric_records(root / "logs_b" / "metrics_rank_0.jsonl")]
        now = lora_state(resumed)
        if again != losses[FINETUNE["interval"]:] or any(
                not torch.equal(v, final[k]) for k, v in now.items()):
            raise AssertionError(f"resumed losses {again} vs {losses[FINETUNE['interval']:]}, "
                                 "or its LoRA state differs")
        print(f"  (b) resumed at {FINETUNE['interval']}: losses {again}, bitwise equal to (a)'s, "
              "and so the LoRA leaves and their optimizer state at the end")
        batch = resumed.batch_to_model_input(resumed._next_micro_batches(), resumed.device)
        key = dropout_key(resumed.context.seed, resumed.context.iterations)
        remat = remat_check(resumed, batch, key, device)
        print(f"  (b) one more step without remat / with every_layer / with "
              f"every_layer_save_dots: loss " + " / ".join(repr(x) for x in remat["loss"])
              + f"; f32 LoRA masters differ by {remat['master_diff']:.3e} (tol {REMAT_TOL}; "
              f"the step moved them by up to {remat['update']:.3e}), bf16 leaves by "
              f"{remat['param_diff']:.3e}; peak max_memory_allocated "
              + ("not measured" if remat["peak"][0] is None else
                 " / ".join(f"{p / 1e9:.2f}" for p in remat["peak"]) + "GB"))
        if len(set(remat["loss"])) != 1 or not remat["master_diff"] <= REMAT_TOL:
            raise AssertionError(f"remat changed the step: {remat}")
        if device == "cuda":
            prof = host_and_device_ms(lambda b: resumed._train_step(b, key), batch)
            print(f"  (b) finetune step, host dispatch {prof['dispatch_ms']:.2f}ms of "
                  f"{prof['step_ms']:.2f}ms with its sync (medians of 3); one profiled step: "
                  f"wall={prof['wall_ms']:.3f}ms device busy={prof['device_busy_ms']:.3f}ms "
                  f"idle share={prof['device_idle_share']:.3f} device ms by group: "
                  + " ".join(f"{k}={v:.3f}" for k, v in prof["device_ms"].items()))
            for ms, count, name in prof["top_other"]:
                print(f"    other: {ms:.3f}ms in {count} launches: {name}")
        del resumed
        if device == "cuda":
            torch.cuda.empty_cache()

        # (c) probability dropout: the unfused attention, no K4/K5
        before_k, before_p = Counter(launches.KERNEL), Counter(launches.PLAIN)
        main(TransformerConfig.from_dict(finetune_config(
            base, root / "logs_c", prob_dropout=FINETUNE["prob_dropout"],
            iterations=FINETUNE["prob_steps"])), device=device)
        kern_c = Counter(launches.KERNEL) - before_k
        plain_c = Counter(launches.PLAIN) - before_p
        records_c = metric_records(root / "logs_c" / "metrics_rank_0.jsonl")
        prob_losses = [r["metrics"]["loss"] for r in records_c]
        flash = ("flash_attention_fwd", "flash_attention_bwd")
        print(f"  (c) dropout_attention_probs {FINETUNE['prob_dropout']}: losses {prob_losses}; "
              f"step ms {[round(r['metrics']['step_duration'] * 1e3, 2) for r in records_c]} "
              f"(host clock); launches kernel={dict(kern_c)} plain={dict(plain_c)}")
        if (len(prob_losses) != FINETUNE["prob_steps"] or not all(np.isfinite(prob_losses))
                or any(kern_c[k] + plain_c[k] for k in flash)):
            raise AssertionError(f"probability dropout: losses {prob_losses}, flash ran: "
                                 f"{dict(kern_c)} {dict(plain_c)}")
        if device == "cuda":
            torch.cuda.empty_cache()

        # (d) the step-6 checkpoint merged on load; the unmerged one served
        cfg = finetune_config(base, root / "logs_d", load_dir=lora_dir / f"global_step{n}")
        cfg["trainer"]["merge_lora_after_loading_checkpoint"] = True
        merged = build_trainer(TransformerConfig.from_dict(cfg), device=device)
        mb = merged.batch_to_model_input(merged._next_micro_batches(), merged.device)
        row = {k: v[0, :1, :FINETUNE["merge_tokens"]] for k, v in mb.items()}
        mm = merged.module.model
        if any(layer.attention.query_lora.lora_b.any() for layer in mm.transformer_layers):
            raise AssertionError("the merge left a LoRA B nonzero")
        mm.eval()
        with torch.no_grad():
            card = merged.module.forward(row)["activations"].float().cpu()
        arch = merged.context.config.transformer_architecture
        arch_topology = merged.module.topology
        del merged, mm
        if device == "cuda":
            torch.cuda.empty_cache()
        served = TransformerInferenceModule.from_checkpoint(lora_dir, device=device)
        if not served.model.layers["layer_1"].attention.query_lora.lora_b.any():
            raise AssertionError("the served checkpoint has no LoRA delta")
        before_k, before_p = Counter(launches.KERNEL), Counter(launches.PLAIN)
        engine = ServeEngine(served, EngineConfig(kv_dtype="native", **SERVE), device=device)
        work = sample_workload(FINETUNE["serve_requests"], WORKLOAD["rate"],
                               WORKLOAD["prompt_len"], WORKLOAD["output_len"],
                               arch.vocab_size, WORKLOAD["seed"])
        for _, prompt, olen in work:
            engine.submit(prompt, olen)
        tokens = {s.request.req_id: list(s.generated) for s in engine.run_until_done()}
        kern_d = Counter(launches.KERNEL) - before_k
        versus = served_vs_generated(served, [tokens[i] for i in sorted(tokens)], work)
        if device == "cuda":
            torch.cuda.synchronize()
        kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
        print(f"  (d) served {len(work)} requests of the LoRA checkpoint (native KV, phase 4's "
              f"traffic): engine launches {dict(kern_d)}; greedy tokens equal to generate's in "
              f"{versus['equal']}/{len(work)} requests, the others part at a near tie "
              f"(request, token, logit gap, max|logit|): {versus['ties']}")
        if device == "cuda" and any(kern_d.get(k, 0) <= 0 for k in ("paged_attention",
                                                                    "rms_norm")):
            raise AssertionError(f"serving the LoRA checkpoint: kernels {dict(kern_d)}")
        del engine, served
        if device == "cuda":
            torch.cuda.empty_cache()
        variants = {v: launches.VARIANTS[("rms_norm_bwd", v)] for v in ("dx_dw", "dx_only")}
        print(f"  launches kernel={kernel} plain={plain}; K3 by variant {variants} (the "
              "norm gains are frozen)")
        needed = ("paged_attention", "rms_norm", "rms_norm_bwd", "flash_attention_fwd",
                  "flash_attention_bwd")
        if device == "cuda" and (any(kernel.get(k, 0) <= 0 for k in needed)
                                 or sum(plain.values())):
            raise AssertionError(f"finetune phase: launches kernel={kernel} plain={plain}")
        if device == "cuda" and (variants["dx_dw"] or variants["dx_only"] <= 0):
            raise AssertionError(f"finetune phase: frozen gains took K3 {variants}")

        # the unmerged model in f32 on the CPU (plain versions, after the
        # counters were read)
        t0 = time.monotonic()
        arch32 = dataclasses.replace(arch, precision="float32")
        cpu_model = TransformerModel(arch32, device="cpu")
        load_model_checkpoint(lora_dir / f"global_step{n}",
                              {jax_param_key(cpu_model, k): p
                               for k, p in cpu_model.named_parameters()})
        cpu_model.eval()
        with torch.no_grad():
            cpu = ParallelModule(cpu_model, arch_topology).forward(
                {k: v.cpu() for k, v in row.items()})["activations"]
        scale = cpu.abs().max().item()
        err = (card - cpu).abs().max().item() / scale
        uniform = ((cpu.amax(-1) - cpu.amin(-1)) / 2).max().item() / scale
        print(f"  (d) merged on load (bf16, card) vs unmerged (f32, CPU), one row of "
              f"{row['token_ids'].shape[1]} tokens: err/max|logit|={err:.3e} (tol {MERGE_TOL}; "
              f"constant logits would give >= {uniform:.3e}) max|logit|={scale:.4e} "
              f"({time.monotonic() - t0:.1f}s)")
        if not (err <= MERGE_TOL < uniform):
            raise AssertionError(f"merged logits: err {err} uniform {uniform}")
        del cpu_model

        # (e) one dropout call at training size on the card
        dev = torch.device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(12)
        x = torch.randn(FINETUNE["dropout_shape"], generator=gen, device=dev).bfloat16()
        site, rate = "layer_1.after_mlp", FINETUNE["dropout"]
        ctx = DropoutContext(dropout_key(0, 1)).for_micro_batch(0)
        y = ctx.dropout(x, rate, site)
        dropped = (y == 0) & (x != 0)
        share = dropped.float().sum().item() / (x != 0).sum().item()
        sigma = math.sqrt(rate * (1 - rate) / x.numel())
        kept_ok = torch.equal(y[~dropped], (x / (1 - rate))[~dropped])
        same = torch.equal(y, ctx.dropout(x, rate, site))
        other = not torch.equal(y, DropoutContext(dropout_key(0, 2)).for_micro_batch(0)
                                .dropout(x, rate, site))
        ms = time_ms(lambda: ctx.dropout(x, rate, site)) if device == "cuda" else None
        print(f"  (e) dropout of a {tuple(x.shape)} bf16 tensor at {rate}: zero share "
              f"{share:.6f} ({abs(share - rate) / sigma:.2f} sigma from {rate}); kept values "
              f"x / {1 - rate} in bf16: {kept_ok}; same site and step the same mask: {same}; "
              f"another step another mask: {other}; "
              + ("not timed (no card)" if ms is None else
                 f"device ms={ms[0]:.3f}, per call (CUDA events) {ms[1]:.3f}ms"))
        if not (abs(share - rate) <= 5 * sigma and kept_ok and same and other):
            raise AssertionError("dropout on the card")
        wall = time.monotonic() - t_phase
        print(f"  phase 12 took {wall:.1f}s")
        return {"launches": kernel, "step_ms": step_ms, "peak_bytes": peak, "wall_s": wall}
    finally:
        reset_logger()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------ serving modes, resilience
def repeating_workload(vocab: int, seed: int = MODES["seed"], n=None) -> list:
    """Phase 13 (a)'s traffic: ``n`` requests at phase 4's rate and output
    lengths, each prompt a random segment of 16-64 tokens repeated up to
    128-1024 tokens (the code-editing and quote-the-document traffic n-gram
    drafting serves)."""
    rng = np.random.default_rng(seed)
    n = MODES["requests"] if n is None else n
    arrivals = np.cumsum(rng.exponential(1.0 / WORKLOAD["rate"], size=n))
    arrivals[0] = 0.0
    work = []
    for a in arrivals:
        lo, hi = MODES["segment"]
        segment = rng.integers(1, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
        length = int(rng.integers(WORKLOAD["prompt_len"][0], WORKLOAD["prompt_len"][1] + 1))
        olen = int(rng.integers(WORKLOAD["output_len"][0], WORKLOAD["output_len"][1] + 1))
        work.append((float(a), (segment * (length // len(segment) + 1))[:length], olen))
    return work


def phase4_workload(vocab: int) -> list:
    from scaling_tpu_torch.serve.bench import sample_workload

    return sample_workload(WORKLOAD["n_requests"], WORKLOAD["rate"], WORKLOAD["prompt_len"],
                           WORKLOAD["output_len"], vocab, WORKLOAD["seed"])


def serve_mode(inf, work: list, device: str, **cfg) -> dict:
    """``work`` through a fresh engine of SERVE's shape with ``cfg``, after
    phase 4's warm-up request, the counters reset just before the run and
    read just after. Returns the stats with the tokens by request index,
    the launches (K1's by query width too) and the longest tick."""
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import run_bench

    engine = ServeEngine(inf, EngineConfig(**{**SERVE, **cfg}), device=device)
    engine.submit(list(range(1, 41)), 4)  # warm-up request, off the books
    engine.run_until_done()
    tick, longest = engine.tick, [0.0]

    def timed_tick():
        t0 = time.monotonic()
        out = tick()  # each tick ends in its device->host pull
        longest[0] = max(longest[0], time.monotonic() - t0)
        return out

    engine.tick = timed_tick
    launches.reset()
    stats = run_bench(engine, work)
    if device == "cuda":
        torch.cuda.synchronize()
    stats.update(launches=dict(launches.KERNEL), plain=dict(launches.PLAIN),
                 widths=dict(launches.WIDTHS), longest_tick_s=longest[0])
    finished = {s.request.req_id: s for s in engine.finished}
    stats["tokens"] = {}
    for i, (_, _, olen) in enumerate(work):
        seq = finished.get(i + 1)  # id 0 was the warm-up request
        if seq is None or seq.finish_status != "completed" or len(seq.generated) != olen:
            raise AssertionError(f"{cfg}: request {i} did not complete {olen} tokens")
        stats["tokens"][i] = list(seq.generated)
    return stats


def check_near_ties(inf, prompts: list, got: dict, want: dict, what: str) -> int:
    """``got`` against ``want`` (request index -> tokens): equal, or the
    first token where they part is a near tie, the card's ``logits()``
    there putting the two candidates within TICK_TOL of max |logit| of
    each other. Returns how many requests are equal."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: requests {sorted(got)} vs {sorted(want)}")
    equal = 0
    for i in sorted(want):
        a, b = got[i], want[i]
        if len(a) != len(b):
            raise AssertionError(f"{what}: request {i} has {len(a)} tokens, not {len(b)}")
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            equal += 1
            continue
        logits = inf.logits(prompts[i] + a[:t])[0, -1].float()
        gap = abs(logits[a[t]] - logits[b[t]]).item()
        if not gap <= TICK_TOL * logits.abs().max().item():
            raise AssertionError(f"{what}: request {i} parts at token {t} with a logit gap "
                                 f"{gap} > {TICK_TOL} x max|logit|")
    return equal


def check_mode_launches(what: str, stats: dict, needed: tuple) -> None:
    kernel, plain = stats["launches"], stats["plain"]
    if any(kernel.get(k, 0) <= 0 for k in needed):
        raise AssertionError(f"{what}: kernels not launched on its path: {kernel}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"{what}: plain versions ran on the card: {plain}")


def check_k1_widths(widths: dict, needed: tuple) -> None:
    """K1 launched at each query width of ``needed``."""
    if any(widths.get(("paged_attention", s), 0) <= 0 for s in needed):
        raise AssertionError(f"(c) K1 not launched at each of the widths {needed}: {widths}")


def fmt_latency(stats: dict) -> str:
    return (f"{stats['tokens_per_s']:.1f} tokens/s, ttft p50/p99 {stats['ttft_p50_s']:.4f}/"
            f"{stats['ttft_p99_s']:.4f}s, itl p50/p99 {stats['itl_p50_s']:.4f}/"
            f"{stats['itl_p99_s']:.4f}s, {stats['ticks']} ticks")


def first_token_logits(inf, device: str) -> tuple:
    """One 1000-token prompt through whole-prompt prefill (bucket 1024, 24
    pads in segment 1): the logits the engine samples its first token
    from, beside those of the f32 copy's ``logits()`` of the bare prompt
    on the CPU. Returns (max |error|, max |logit|)."""
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine

    prompt = np.random.default_rng(MODES["seed"] + 1).integers(
        1, inf.architecture.vocab_size, size=MODES["first_token_prompt"]).tolist()
    captured = []
    prefill = inf.prefill_forward

    def capture(*args, **kwargs):
        out = prefill(*args, **kwargs)
        captured.append(out[0][0, 0].float().cpu())
        return out

    inf.prefill_forward = capture
    try:
        engine = ServeEngine(inf, EngineConfig(**{**SERVE, "prefill_chunk": None}),
                             device=device)
        engine.submit(prompt, 1)
        engine.run_until_done()
    finally:
        del inf.prefill_forward
    ref = cpu_f32_copy(inf).logits(prompt)[0, -1]
    return (captured[0] - ref).abs().max().item(), ref.abs().max().item()


def modes_in_process(inf, phase4: dict, device: str) -> dict:
    """Phase 13 (a)-(c), in this process on phase 4's model. Each mode is
    held against a run beside it in this call: (a)'s spec-off run on the
    same repeating traffic, and on the first ``MODES["requests"]`` of
    phase 4's traffic a chunked spec-off run of phase 4's engine (host-bound numbers move by tens of percent
    between runs minutes apart)."""
    vocab = inf.architecture.vocab_size
    n = MODES["requests"]
    plain_work, rep_work = phase4_workload(vocab)[:n], repeating_workload(vocab)
    plain_prompts = [p for _, p, _ in plain_work]
    paged = ("paged_attention", "rms_norm")
    out = {"longest_tick_s": 0.0, "launches": {}}

    def run(name, work, **cfg):
        stats = serve_mode(inf, work, device, **cfg)
        out["longest_tick_s"] = max(out["longest_tick_s"], stats["longest_tick_s"])
        out["launches"][name] = stats["launches"]
        return stats

    # (a) speculative decoding on self-repeating prompts, and on phase 4's traffic
    spec = run("spec", rep_work, spec_k=MODES["spec_k"])
    off = run("spec_off", rep_work)
    check_mode_launches("(a) spec_k 4", spec, paged)
    if spec["spec_accepted_tokens"] <= 0:
        raise AssertionError(f"(a) no draft accepted: {spec['spec_drafted_tokens']} drafted")
    equal = check_near_ties(inf, [p for _, p, _ in rep_work], spec["tokens"], off["tokens"],
                            "(a) spec on vs off")
    print(f"  (a) spec_k {MODES['spec_k']}, repeating prompts: accept rate "
          f"{spec['spec_accept_rate']} ({spec['spec_accepted_tokens']}/"
          f"{spec['spec_drafted_tokens']}), {fmt_latency(spec)}")
    print(f"  (a) spec off, the same traffic: {fmt_latency(off)}; greedy tokens equal in "
          f"{equal} of {len(rep_work)} requests, the rest part at a near tie; spec on / off "
          f"tokens/s {spec['tokens_per_s'] / off['tokens_per_s']:.3f}")
    chunked = run("chunked", plain_work)
    check_mode_launches("phase 4's engine", chunked, paged)
    check_near_ties(inf, plain_prompts, chunked["tokens"],
                    {i: phase4["tokens"][i] for i in range(len(plain_work))},
                    "phase 4's engine again vs phase 4")
    print(f"  phase 4's engine (chunk {SERVE['prefill_chunk']}, spec off) on the first "
          f"{len(plain_work)} requests of its traffic, beside the runs below: "
          f"{fmt_latency(chunked)}; phase 4's own run (all its requests) "
          f"{phase4['tokens_per_s']:.1f} tokens/s")
    random_spec = run("spec_random", plain_work, spec_k=MODES["spec_k"])
    check_mode_launches("(a) spec_k 4 on phase 4's traffic", random_spec, paged)
    equal = check_near_ties(inf, plain_prompts, random_spec["tokens"], chunked["tokens"],
                            "(a) spec_k 4 vs spec off on phase 4's traffic")
    print(f"  (a) spec_k {MODES['spec_k']} on phase 4's random traffic: accept rate "
          f"{random_spec['spec_accept_rate']}, {fmt_latency(random_spec)}; spec on / off "
          f"tokens/s {random_spec['tokens_per_s'] / chunked['tokens_per_s']:.3f}; tokens equal "
          f"in {equal} of {len(plain_work)}, the rest part at a near tie")
    # (b) whole-prompt prefill at phase 4's traffic
    whole = run("whole_prompt", plain_work, prefill_chunk=None)
    check_mode_launches("(b) whole-prompt prefill", whole,
                        paged + ("flash_attention_fwd",))
    equal = check_near_ties(inf, plain_prompts, whole["tokens"], chunked["tokens"],
                            "(b) whole prompt vs chunks")
    err, scale = first_token_logits(inf, device)
    print(f"  (b) whole-prompt prefill: {fmt_latency(whole)}; chunked ttft p50/p99 "
          f"{chunked['ttft_p50_s']:.4f}/{chunked['ttft_p99_s']:.4f}s, chunked / whole ttft "
          f"p50 {chunked['ttft_p50_s'] / whole['ttft_p50_s']:.3f}; K4 launches "
          f"{whole['launches'].get('flash_attention_fwd', 0)}; tokens equal in {equal} of "
          f"{len(plain_work)}, the rest part at a near tie")
    print(f"  (b) a {MODES['first_token_prompt']}-token prompt's first-token logits vs the f32 "
          f"CPU forward: max_abs_err={err:.4e} max|logit|={scale:.4e} (tol {TICK_TOL} x)")
    if not err <= TICK_TOL * scale:
        raise AssertionError(f"(b) first-token logits disagree: {err} > {TICK_TOL * scale}")
    # (c) the separate decode and chunk forwards, on the first requests
    n_sep = min(MODES["separate_requests"], len(plain_work))
    separate = run("separate", plain_work[:n_sep], fused_tick=False)
    check_mode_launches("(c) fused_tick=False", separate, paged)
    widths = separate["widths"]
    check_k1_widths(widths, (1, SERVE["prefill_chunk"]))
    equal = check_near_ties(inf, plain_prompts, separate["tokens"],
                            {i: chunked["tokens"][i] for i in range(n_sep)},
                            "(c) separate vs fused")

    def per_tick(stats):
        ticks = stats["ticks"]
        return (f"{stats['wall_s'] / ticks * 1e3:.3f}ms a tick, launches a tick: K1 "
                f"{stats['launches'].get('paged_attention', 0) / ticks:.2f} K2 "
                f"{stats['launches'].get('rms_norm', 0) / ticks:.2f}")

    print(f"  (c) fused_tick=False: {per_tick(separate)} (K1 at s=1: "
          f"{widths.get(('paged_attention', 1), 0)}, at s={SERVE['prefill_chunk']}: "
          f"{widths.get(('paged_attention', SERVE['prefill_chunk']), 0)}); fused, beside it: "
          f"{per_tick(chunked)}; phase 4's run: {per_tick(phase4)}; {fmt_latency(separate)}; "
          f"tokens equal in {equal} of {n_sep} (phase 4's first {n_sep} requests), the rest "
          "part at a near tie")
    return out


def bench_base(model: str, device: str) -> list:
    """``serve bench`` flags of phase 4's native traffic and engine."""
    return ["--model", model, "--device", device, "--seed", str(WORKLOAD["seed"]),
            "--requests", str(WORKLOAD["n_requests"]), "--rate", str(WORKLOAD["rate"]),
            "--prompt-len", *map(str, WORKLOAD["prompt_len"]),
            "--output-len", *map(str, WORKLOAD["output_len"]),
            "--num-slots", str(SERVE["num_slots"]), "--block-size", str(SERVE["block_size"]),
            "--num-blocks", str(SERVE["num_blocks"]),
            "--max-blocks-per-seq", str(SERVE["max_blocks_per_seq"]),
            "--prefill-chunk", str(SERVE["prefill_chunk"])]


def start_bench(run_dir: Path, args: list, faults=None, record: bool = True
                ) -> subprocess.Popen:
    """``python -m scaling_tpu_torch.serve bench`` in a child process, its
    stats in ``run_dir/stats.json``; with ``record`` also ``--run-dir
    run_dir`` (events, metrics, the journal)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCALING_TPU_")}
    if faults:
        env["SCALING_TPU_FAULTS"] = faults
    run_dir.mkdir(parents=True)
    log = open(run_dir.parent / f"{run_dir.name}.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", "scaling_tpu_torch.serve", "bench", *args,
         *(["--run-dir", str(run_dir)] if record else []),
         "--json", str(run_dir / "stats.json")],
        cwd=Path(__file__).resolve().parent, env=env, stdout=log, stderr=subprocess.STDOUT)


def wait_bench(proc: subprocess.Popen, run_dir: Path, what: str) -> dict:
    try:
        rc = proc.wait(timeout=MODES["child_timeout_s"])
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"{what}: the bench outran {MODES['child_timeout_s']}s")
    if rc != 0:
        tail = (run_dir.parent / f"{run_dir.name}.log").read_text()[-3000:]
        raise AssertionError(f"{what}: the bench exited {rc}:\n{tail}")
    return json.loads((run_dir / "stats.json").read_text())


def check_child_launches(what: str, stats: dict) -> dict:
    """A child's counters, as it wrote them into its stats."""
    check_mode_launches(what, {"launches": stats["kernel_launches"],
                               "plain": stats["plain_launches"]},
                        ("paged_attention", "rms_norm"))
    return stats["kernel_launches"]


def in_order(tokens: dict) -> dict:
    """Request id -> tokens as workload index -> tokens (the ids count up
    from the first measured request)."""
    return {i: tokens[r] for i, r in enumerate(sorted(tokens))}


def check_drain(stats: dict) -> None:
    if not stats["drained"] or stats["unsubmitted"] <= 0:
        raise AssertionError(f"drain: drained={stats['drained']} "
                             f"unsubmitted={stats['unsubmitted']}")


def check_journal_counts(replay, offered: int, what: str) -> None:
    """Every offered request ended once: completed, shed or timed out."""
    ended = len(replay.completed) + replay.shed_count + replay.timeout_count
    if replay.offered_count != offered or ended != offered or replay.incomplete:
        raise AssertionError(
            f"{what}: the journal offered {replay.offered_count} of {offered}, "
            f"completed {len(replay.completed)} + shed {replay.shed_count} + timeout "
            f"{replay.timeout_count} = {ended}, incomplete {len(replay.incomplete)}")


def serve_time_to_recover(events: list) -> dict:
    """From the kill to the relaunched child's first emitted token, by the
    events' host clocks: the kill (the end of the killed child's last
    tick), the supervisor's restart event, the relaunch's spawn, its
    ``serve-start`` (the bench entered), its ``serve-resume`` (the model
    built, warmed up and the journal replayed: ``replay_s`` of it) and
    its first token (the earliest ``serve-request``'s arrival plus TTFT)."""
    restart = next(i for i, e in enumerate(events) if e["event"] == "serve-restart")
    kill = max(e["ts"] for e in events[:restart] if e.get("span") == "serve.tick")
    after = events[restart:]
    spawn = next(e["ts"] for e in after if e.get("span") == "serve.supervisor.spawn")
    start = next(e for e in after if e["event"] == "serve-start")
    resume = next(e for e in after if e["event"] == "serve-resume")
    first = min(e["ts"] - e["e2e_s"] + e["ttft_s"] for e in after
                if e["event"] == "serve-request" and "ttft_s" in e)
    return {"total": first - kill, "detection": events[restart]["ts"] - kill,
            "process_start": start["ts"] - spawn,
            "model_build": resume["ts"] - start["ts"] - resume["replay_s"],
            "replay": resume["replay_s"], "first_token": first - resume["ts"]}


def resilience_children(phase4: dict, observed_tokens: dict, inf, longest_tick_s: float,
                        model: str, device: str) -> dict:
    """Phase 13 (d): the bench in child processes at phase 4's traffic. The
    wedged tick, the drain and the overload run side by side; then the
    crash replay alone, which is timed. Returns each exiting child's
    launches."""
    from scaling_tpu_torch.serve.journal import replay_journal

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_resilience_"))
    base, n = bench_base(model, device), WORKLOAD["n_requests"]
    # the fault drills without the warm-up request, whose ticks the fault
    # points would count: tick 40 falls in the measured run
    cold = base + ["--warmup", "0"]
    prompts = [p for _, p, _ in phase4_workload(inf.architecture.vocab_size)]
    launches = {}
    try:
        tick_timeout = max(5 * longest_tick_s, MODES["min_tick_timeout_s"])
        ttft_deadline_ms = 0.5 * phase4["ttft_p50_s"] * 1e3
        hang = start_bench(root / "hang", cold + ["--restarts", "1", "--tick-timeout-s",
                                                  str(tick_timeout)],
                           faults=f"serve.tick=hang@{MODES['fault_tick']}")
        # the drain's workload arrives at MODES["drain_rate"], so that the SIGTERM after
        # the first completed request lands while requests still arrive
        drain = start_bench(root / "drain", base + ["--rate", str(MODES["drain_rate"])])
        overload = start_bench(root / "overload", base + [
            "--rate", str(MODES["overload_x"] * WORKLOAD["rate"]),
            "--max-waiting", str(MODES["max_waiting"]),
            "--ttft-deadline-ms", str(ttft_deadline_ms)])
        events_file = root / "drain" / "events.jsonl"
        deadline = time.monotonic() + MODES["child_timeout_s"]
        while not (events_file.is_file() and '"serve-request"' in events_file.read_text()):
            if time.monotonic() > deadline or drain.poll() is not None:
                raise AssertionError("drain: no serve-request before the SIGTERM")
            time.sleep(0.05)
        drain.send_signal(signal.SIGTERM)
        stats = wait_bench(drain, root / "drain", "drain")
        check_drain(stats)
        launches["drain"] = check_child_launches("drain", stats)
        report, _ = obs_report(root / "drain", "--assert-max-serve-timeouts", "0")
        keep("modes_drain_report.txt", report)
        replay = replay_journal(root / "drain" / "journal.jsonl")
        check_journal_counts(replay, n - stats["unsubmitted"], "drain")
        print(f"  (d) drain at {MODES['drain_rate']} req/s: SIGTERM after the first served "
              "request: exit 0, drained, "
              f"{stats['unsubmitted']} unsubmitted, {len(replay.completed)} completed; "
              "obs report --assert-max-serve-timeouts 0 passes")
        stats = wait_bench(overload, root / "overload", "overload")
        launches["overload"] = check_child_launches("overload", stats)
        replay = replay_journal(root / "overload" / "journal.jsonl")
        check_journal_counts(replay, n, "overload")
        if stats["requests_shed"] <= 0 or stats["requests_timeout"] <= 0:
            raise AssertionError(f"overload: shed {stats['requests_shed']} timeouts "
                                 f"{stats['requests_timeout']}")
        report, rstats = obs_report(root / "overload")
        keep("modes_overload_report.txt", report)
        line = next(x for x in report_section(report, "serving") if "resilience:" in x)
        if f"shed={stats['requests_shed']} " not in line or \
                f"timeouts={stats['requests_timeout']} " not in line:
            raise AssertionError(f"overload: the report's {line!r} vs {stats}")
        print(f"  (d) overload at {MODES['overload_x']}x the rate, --max-waiting "
              f"{MODES['max_waiting']}, --ttft-deadline-ms {ttft_deadline_ms:.1f}: completed "
              f"{stats['requests']} shed {stats['requests_shed']} timeout "
              f"{stats['requests_timeout']} of {n}; report |{line.strip()}")
        stats = wait_bench(hang, root / "hang", "wedged tick")
        launches["hang"] = check_child_launches("wedged tick", stats)
        events = read_jsonl(root / "hang" / "events.jsonl")
        stalls = [e for e in events if e["event"] == "serve-stall"]
        restarts = [e["rc"] for e in events if e["event"] == "serve-restart"]
        replay = replay_journal(root / "hang" / "journal.jsonl")
        if not stalls or restarts != [-signal.SIGKILL]:
            raise AssertionError(f"wedged tick: stalls {stalls}, restarts {restarts}")
        check_journal_counts(replay, n, "wedged tick")
        print(f"  (d) wedged tick (serve.tick=hang@{MODES['fault_tick']}): --tick-timeout-s "
              f"{tick_timeout:.2f} (5 x the longest tick measured, {longest_tick_s:.4f}s, "
              f"at least {MODES['min_tick_timeout_s']}s): serve-stall after "
              f"{stalls[0]['stalled_s']}s, restart rc {restarts[0]}, {len(replay.completed)} "
              f"of {n} completed")
        # the crash replay, alone on the card
        run_dir = root / "crash"
        proc = start_bench(run_dir, cold + ["--restarts", "2"],
                           faults=f"serve.tick=kill@{MODES['fault_tick']}")
        stats = wait_bench(proc, run_dir, "crash replay")
        launches["crash"] = check_child_launches("crash replay", stats)
        replay = replay_journal(run_dir / "journal.jsonl")
        check_journal_counts(replay, n, "crash replay")
        if replay.shed_count or replay.timeout_count:
            raise AssertionError("crash replay: requests shed or timed out")
        equal = check_near_ties(inf, prompts, in_order(replay.completed), observed_tokens,
                                "crash replay vs the fault-free bench")
        events = read_jsonl(run_dir / "events.jsonl")
        restarts = [e["rc"] for e in events if e["event"] == "serve-restart"]
        if restarts != [-signal.SIGKILL]:
            raise AssertionError(f"crash replay: restarts {restarts}")
        free = [e["free_bytes"] for e in events if e["event"] == "serve-start"]
        if len(free) != 2 or (device == "cuda" and abs(free[0] - free[1]) > MODES["free_tol"]):
            raise AssertionError(f"crash replay: the relaunch found {free} bytes free")
        ttr = serve_time_to_recover(events)
        print(f"  (d) crash replay (serve.tick=kill@{MODES['fault_tick']}, --restarts 2): exit "
              f"0, offered {replay.offered_count}, completed {len(replay.completed)}, none "
              f"incomplete; tokens equal to the fault-free bench's in {equal} of {n}, the rest "
              f"part at a near tie; free memory at each start {free}")
        print("  (d) time to recover " + f"{ttr['total']:.2f}s = " + " + ".join(
            f"{k.replace('_', ' ')} {v:.2f}" for k, v in ttr.items() if k != "total"))
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def modes_phase(phase4: dict, observed_tokens: dict, model: str = "0.5b",
                device: str = "cuda") -> dict:
    """Phase 13: the serving modes and the resilience drills on phase 4's
    model. Returns the launches by run (the children's as they wrote them)."""
    from scaling_tpu_torch.serve.bench import build_inference

    t0 = time.monotonic()
    inf = build_inference(model, seed=0, device=device)
    modes = modes_in_process(inf, phase4, device)
    drills = resilience_children(phase4, observed_tokens, inf, modes["longest_tick_s"],
                                 model, device)
    del inf
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"  phase 13 took {time.monotonic() - t0:.1f}s")
    launches = {f"modes_{k}": v for k, v in modes["launches"].items()}
    launches.update({f"resilience_{k}": v for k, v in drills.items()})
    return launches

def fleet_workload(vocab: int) -> list:
    from scaling_tpu_torch.serve.bench import sample_workload

    return sample_workload(FLEET["n_requests"], FLEET["rate"], FLEET["prompt_len"],
                           FLEET["output_len"], vocab, FLEET["seed"],
                           shared_prefix_len=FLEET["shared_prefix_len"],
                           prefix_families=FLEET["prefix_families"])


def fleet_args(model: str, device: str, rate=None) -> list:
    """``serve bench`` flags of workload F on phase 4's engine."""
    return ["--model", model, "--device", device, "--seed", str(FLEET["seed"]),
            "--requests", str(FLEET["n_requests"]), "--rate", str(rate or FLEET["rate"]),
            "--prompt-len", *map(str, FLEET["prompt_len"]),
            "--output-len", *map(str, FLEET["output_len"]),
            "--shared-prefix-len", str(FLEET["shared_prefix_len"]),
            "--prefix-families", str(FLEET["prefix_families"]),
            "--num-slots", str(SERVE["num_slots"]), "--block-size", str(SERVE["block_size"]),
            "--num-blocks", str(SERVE["num_blocks"]),
            "--max-blocks-per-seq", str(SERVE["max_blocks_per_seq"]),
            "--prefill-chunk", str(SERVE["prefill_chunk"])]


def wait_fleet(proc: subprocess.Popen, run_dir: Path, what: str) -> dict:
    try:
        rc = proc.wait(timeout=FLEET["child_timeout_s"])
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"{what}: the bench outran {FLEET['child_timeout_s']}s")
    if rc != 0:
        tail = (run_dir.parent / f"{run_dir.name}.log").read_text()[-3000:]
        raise AssertionError(f"{what}: the bench exited {rc}:\n{tail}")
    return json.loads((run_dir / "stats.json").read_text())


def check_fleet_launches(what: str, rows: list) -> dict:
    """Each replica launched K1 and K2 and no plain version; returns the
    launches summed over the replicas."""
    total = Counter()
    for row in rows:
        check_mode_launches(f"{what} replica {row['replica']}",
                            {"launches": row["kernel_launches"], "plain": row["plain_launches"]},
                            ("paged_attention", "rms_norm"))
        total.update(row["kernel_launches"])
    return dict(total)


def check_fleet_dispatch(what: str, stats: dict) -> None:
    rows = stats["replica_stats"]
    if len(rows) != FLEET["replicas"] or any(r.get("dispatches", 0) <= 0 for r in rows):
        raise AssertionError(f"{what}: not every replica was dispatched to: {rows}")
    if stats["router"]["affinity_dispatches"] <= 0:
        raise AssertionError(f"{what}: no affinity dispatch: {stats['router']}")
    if stats["requests"] != FLEET["n_requests"] or stats["requests_timeout"] \
            or stats["requests_shed"]:
        raise AssertionError(f"{what}: completed {stats['requests']} of {FLEET['n_requests']}, "
                             f"timeouts {stats['requests_timeout']} shed "
                             f"{stats['requests_shed']}")


def fleet_line(stats: dict) -> str:
    rows = ", ".join(f"replica {r['replica']} {r['requests']} requests {r['ticks']} ticks "
                     f"{r.get('dispatches', 0)} dispatches ({r.get('affinity_dispatches', 0)} "
                     "by affinity)" for r in stats["replica_stats"])
    return f"{fmt_latency(stats)}, prefix hit rate {stats['prefix_hit_rate']}; {rows}"


def fleet_tokens(stats: dict) -> dict:
    return in_order({int(r): t for r, t in stats["outputs"].items()})


def check_heartbeats(what: str, stats: dict, restarts: int = 0) -> None:
    """No replica near the heartbeat timeout (a hung verdict would SIGKILL
    it and show as a restart), and the host without CUDA."""
    if stats["replica_restarts"] != restarts or \
            stats["max_loop_age_s"] >= FLEET["heartbeat_timeout_s"]:
        raise AssertionError(f"{what}: restarts {stats['replica_restarts']}, longest loop "
                             f"age {stats['max_loop_age_s']}s")
    if stats["host_cuda_initialized"]:
        raise AssertionError(f"{what}: the fleet's host initialised CUDA")


def fleet_time_to_recover(events: list) -> dict:
    """From the killed worker's last tick (the end of replica 1's last
    ``serve.tick`` before the dead verdict) to the verdict, the relaunch's
    spawn (the start of its ``serve.replica.spawn`` span), its
    ``serve-replica-ready`` and the first token of a re-dispatched request
    (one admitted by replica 1 before the verdict and by another replica
    after it), by the events' host clocks."""
    i_dead = next(i for i, e in enumerate(events) if e["event"] == "serve-replica-dead")
    dead = events[i_dead]
    rid = dead["replica"]
    kill = max(e["ts"] for e in events[:i_dead]
               if e.get("span") == "serve.tick" and e.get("replica") == rid)
    after = events[i_dead:]
    spawn = next(e for e in after
                 if e.get("span") == "serve.replica.spawn" and e.get("replica") == rid)
    ready = next(e for e in after if e["event"] == "serve-replica-ready" and e["replica"] == rid)
    before_ids = {e["req"] for e in events[:i_dead]
                  if e.get("span") == "serve.admit" and e.get("replica") == rid}
    again = {e["req"] for e in after if e.get("span") == "serve.admit"
             and e.get("replica") != rid and e["req"] in before_ids}
    first = min(e["ts"] - e["e2e_s"] + e["ttft_s"] for e in after
                if e["event"] == "serve-request" and e.get("req") in again and "ttft_s" in e)
    return {"detection": dead["ts"] - kill, "spawn": spawn["ts"] - spawn["dur_s"] - kill,
            "ready": ready["ts"] - kill, "first_token": first - kill,
            "redispatched": len(again)}


def check_fleet_journals(run_dir: Path, stats: dict) -> dict:
    """Every offered request ended once: the completed requests of the
    replica journals are disjoint, and with the failover harvest's (the
    dead incarnation's journal is harvested, then started afresh) they are
    every offered one; nothing is left incomplete or shed."""
    from scaling_tpu_torch.serve.journal import replay_journal

    seen: dict = {}
    for path in sorted(run_dir.glob("journal_r*.jsonl")):
        rep = replay_journal(path)
        for r in rep.completed:
            if r in seen:
                raise AssertionError(f"request {r} completed in {seen[r]} and {path.name}")
            seen[r] = path.name
        if rep.timeout_count or rep.shed_count:
            raise AssertionError(f"{path.name}: timeouts {rep.timeout_count} "
                                 f"shed {rep.shed_count}")
    fleet = replay_journal(run_dir / "journal.jsonl")
    ended = len(seen) + stats["recovered_requests"]
    if ended != FLEET["n_requests"] or fleet.shed_count or \
            set(seen) - {int(r) for r in stats["outputs"]}:
        raise AssertionError(f"journals: {len(seen)} completed + {stats['recovered_requests']} "
                             f"recovered of {FLEET['n_requests']}, fleet sheds "
                             f"{fleet.shed_count}")
    return {"journaled": len(seen), "recovered": stats["recovered_requests"]}


def fleet_children(ref: dict, inf, model: str, device: str) -> dict:
    """Phase 14 (b)-(e), each a ``serve bench`` child on workload F.
    Returns each run's launches summed over its replicas."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    prompts = [p for _, p, _ in fleet_workload(inf.architecture.vocab_size)]
    base = fleet_args(model, device)
    launches, rows = {}, {}
    n = FLEET["replicas"]
    try:
        # (b) and (c) without a run directory, as (a): no events file in the
        # runs whose tokens/s stand beside (a)'s
        stats = wait_fleet(start_bench(root / "threads", base + ["--replicas", str(n)],
                                       record=False), root / "threads", "(b) --replicas 2")
        check_fleet_dispatch("(b)", stats)
        launches["fleet_threads"] = check_fleet_launches("(b)", stats["replica_stats"])
        equal = check_near_ties(inf, prompts, fleet_tokens(stats), ref["tokens"], "(b) vs (a)")
        rows["threads"] = stats
        print(f"  (b) --replicas {n} (one process, a tick thread and a CUDA stream a "
              f"replica): {fleet_line(stats)}; tokens equal to (a)'s in {equal} of "
              f"{len(prompts)}, the rest part at a near tie")
        # (c) the process fleet, fault-free
        stats = wait_fleet(start_bench(root / "procs", base + ["--replicas-proc", str(n)],
                                       record=False), root / "procs", "(c) --replicas-proc 2")
        check_fleet_dispatch("(c)", stats)
        check_heartbeats("(c)", stats)
        launches["fleet_procs"] = check_fleet_launches("(c)", stats["replica_stats"])
        clean = fleet_tokens(stats)
        equal = check_near_ties(inf, prompts, clean, ref["tokens"], "(c) vs (a)")
        rows["procs"] = stats
        print(f"  (c) --replicas-proc {n} (a worker process and CUDA context a replica, the "
              f"host without CUDA): {fleet_line(stats)}; tokens equal to (a)'s in {equal} "
              f"of {len(prompts)}, the rest part at a near tie; longest loop age "
              f"{stats['max_loop_age_s']:.4f}s, longest stats round trip "
              f"{stats['max_stats_rtt_s']:.4f}s")
        # (d) replica 1 SIGKILLed at its 40th tick with work
        if device == "cuda":
            torch.cuda.synchronize()
        free_before = torch.cuda.mem_get_info()[0] if device == "cuda" else None
        faults = f"serve.replica.kill=kill@{FLEET['kill_tick']}@host=1"
        stats = wait_fleet(start_bench(root / "kill", base + ["--replicas-proc", str(n)],
                                       faults=faults), root / "kill", "(d) the kill")
        free_after = torch.cuda.mem_get_info()[0] if device == "cuda" else None
        events = read_jsonl(root / "kill" / "events.jsonl")
        check_heartbeats("(d)", stats, restarts=1)
        hung = [e for e in events if e["event"] == "serve-replica-hung"]
        if hung:
            raise AssertionError(f"(d): hung verdicts {hung}")
        launches["fleet_kill"] = check_fleet_launches("(d)", stats["replica_stats"])
        if stats["requests"] != FLEET["n_requests"] or stats["replicas_gave_up"]:
            raise AssertionError(f"(d): completed {stats['requests']}, gave up "
                                 f"{stats['replicas_gave_up']}")
        ended = check_fleet_journals(root / "kill", stats)
        restarts = [e for e in events if e["event"] == "serve-replica-restart"]
        if len(restarts) != 1:
            raise AssertionError(f"(d): restart events {restarts}")
        report, _ = obs_report(root / "kill", "--assert-max-replica-restarts", "1")
        keep("fleet_kill_report.txt", report)
        equal = check_near_ties(inf, prompts, fleet_tokens(stats), clean, "(d) vs (c)")
        ready = [e for e in events if e["event"] == "serve-replica-ready"]
        starts = [(e["replica"], e["incarnation"], e["free_bytes"]) for e in events
                  if e["event"] == "serve-start"]
        if device == "cuda":
            first_up = min(e["free_bytes"] for e in ready[:n])
            relaunch_up = ready[-1]["free_bytes"]
            if relaunch_up < first_up - FLEET["free_tol"] or \
                    abs(free_after - free_before) > FLEET["free_tol"]:
                raise AssertionError(
                    f"(d) free memory: both up {first_up} at the start, {relaunch_up} after "
                    f"the relaunch; this process {free_before} before, {free_after} after")
        ttr = fleet_time_to_recover(events)
        rows["kill"] = stats
        print(f"  (d) {faults}: {stats['requests']} of {FLEET['n_requests']} completed, "
              f"{ended['journaled']} by the replica journals and {ended['recovered']} from "
              f"the failover harvest, each once; {stats['redispatched_requests']} "
              f"re-dispatched; restarts 1; obs report --assert-max-replica-restarts 1 passes; "
              f"tokens equal to (c)'s in {equal} of {len(prompts)}, the rest part at a near "
              f"tie; {fleet_line(stats)}")
        print(f"  (d) free memory: at each start (replica, incarnation, bytes) {starts}; with "
              f"both up {[e['free_bytes'] for e in ready]}; this process before "
              f"{free_before} after {free_after}")
        print(f"  (d) time to recover from the last tick: dead verdict {ttr['detection']:.3f}s, "
              f"relaunch spawn {ttr['spawn']:.3f}s, ready {ttr['ready']:.3f}s, first token "
              f"of a re-dispatched request {ttr['first_token']:.3f}s "
              f"({ttr['redispatched']} re-dispatched)")
        # (e) the drain
        proc = start_bench(root / "drain", fleet_args(model, device, FLEET["drain_rate"])
                           + ["--replicas-proc", str(n)])
        events_file = root / "drain" / "events.jsonl"
        deadline = time.monotonic() + FLEET["child_timeout_s"]
        while not (events_file.is_file()
                   and events_file.read_text().count('"serve-replica-ready"') >= n):
            if time.monotonic() > deadline or proc.poll() is not None:
                raise AssertionError("(e): the fleet never became ready")
            time.sleep(0.05)
        time.sleep(FLEET["drain_after_s"])
        proc.send_signal(signal.SIGTERM)
        stats = wait_fleet(proc, root / "drain", "(e) the drain")
        check_drain(stats)
        codes = [r["exit_code"] for r in stats["replica_stats"]]
        if codes != [0] * n or stats["replicas_gave_up"]:
            raise AssertionError(f"(e): worker exit codes {codes}")
        print(f"  (e) SIGTERM {FLEET['drain_after_s']}s after both workers were ready, "
              f"arrivals at {FLEET['drain_rate']} req/s: exit 0, drained, "
              f"{stats['unsubmitted']} unsubmitted, {stats['requests']} completed, worker "
              f"exit codes {codes}")
        return {"launches": launches, "runs": rows}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def fleet_phase(model: str = "0.5b", device: str = "cuda") -> dict:
    """Phase 14: (a) one engine in this process on workload F, then the
    fleets in child processes (``fleet_children``). Returns the launches by
    run, each fleet's summed over its replicas."""
    from scaling_tpu_torch.serve.bench import build_inference

    t0 = time.monotonic()
    inf = build_inference(model, seed=0, device=device)
    work = fleet_workload(inf.architecture.vocab_size)
    ref = serve_mode(inf, work, device)
    check_mode_launches("(a) one engine", ref, ("paged_attention", "rms_norm"))
    print(f"  (a) one engine on F: {fmt_latency(ref)}, prefix hit rate "
          f"{ref['prefix_hit_rate']}, {ref['preemptions']} preemptions, "
          f"{ref['wall_s'] / ref['ticks'] * 1e3:.3f}ms a tick")
    out = fleet_children(ref, inf, model, device)
    runs = out["runs"]
    print("  tokens/s on F: one engine {:.1f}, --replicas 2 {:.1f} ({:.3f}x), --replicas-proc 2 "
          "{:.1f} ({:.3f}x), with the kill {:.1f}".format(
              ref["tokens_per_s"], runs["threads"]["tokens_per_s"],
              runs["threads"]["tokens_per_s"] / ref["tokens_per_s"],
              runs["procs"]["tokens_per_s"], runs["procs"]["tokens_per_s"] / ref["tokens_per_s"],
              runs["kill"]["tokens_per_s"]))
    del inf
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"  phase 14 took {time.monotonic() - t0:.1f}s")
    return {"fleet_one": ref["launches"], **out["launches"]}


def time_kernels(errs: dict) -> list:
    """One row a kernel, its launches added by ``add_launches``."""
    import torch.nn.functional as F

    from scaling_tpu_torch.ops import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
        paged_attention,
        paged_attention_plain,
        rms_norm,
        rms_norm_bwd,
        rms_norm_bwd_plain,
        rms_norm_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = []

    def row(name, route, source, replaces, fn, plain_fn, bound_ms, library_fn=None,
            flops=None):
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces, max_abs_err=errs[name],
            ms=time_ms(fn), plain_ms=time_ms(plain_fn), bound_ms=bound_ms[0],
            bound_by=bound_ms[1], library_ms=time_ms(library_fn) if library_fn else None,
        ))
        if flops is not None:  # the bound's operations over the device time
            rows[-1]["tflops"] = flops / (rows[-1]["ms"][0] * 1e-3) / 1e12

    long_gen = torch.Generator(device=dev)  # apart: the tick's inputs stay as they were
    long_gen.manual_seed(4)
    for name, quantized in (("paged_attention", False), ("paged_attention_int8", True)):
        args, kw = k1_inputs(gen, quantized, dev)
        row(name, "cuda", "scaling_tpu_torch/csrc/paged_attention.cu",
            "scaling_tpu/nn/paged_attention.py:163",
            lambda: paged_attention(*args, **kw), lambda: paged_attention_plain(*args, **kw),
            k1_bound_ms(args, kw))
        long_args, long_kw = k1_inputs(long_gen, quantized, dev, K1_LONG_ROW)
        dev_ms, call_ms = time_ms(lambda: paged_attention(*long_args, **long_kw))
        long_bound = k1_bound_ms(long_args, long_kw)[0]
        print(f"  {name} one 2048-slot row: device ms={dev_ms:.4f} per call={call_ms:.4f} "
              f"bound={long_bound:.4f} gbps={long_bound / dev_ms * HBM_BYTES_PER_S / 1e9:.1f}")
        for case, (a, k) in (("serving tick", (args, kw)), ("one 2048-slot row",
                                                            (long_args, long_kw))):
            parts = device_ms_by_kernel(lambda: paged_attention(*a, **k))
            print(f"  {name} {case}: device ms by kernel: "
                  + (" ".join(f"{n}={ms:.4f}" for n, ms in parts.items()) or "not measured"))
    for rows_k2, d in (K2_SHAPES[0], K3_SHAPES[0]):  # serving ticks; a training micro-batch
        x = torch.randn(rows_k2, d, generator=gen, device=dev).bfloat16()
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
        dev_ms, call_ms = time_ms(lambda: rms_norm(x, w, 1e-5))
        print(f"  rms_norm ({rows_k2}, {d}): device ms={dev_ms:.4f} per call={call_ms:.4f} "
              f"bound={k2_bound_ms(x)[0]:.4f}")
    row("rms_norm", "triton", "scaling_tpu_torch/ops/_rms_norm_triton.py",
        "scaling_tpu/ops/rms_norm.py:107",
        lambda: rms_norm(x, w, 1e-5), lambda: rms_norm_plain(x, w, 1e-5), k2_bound_ms(x),
        lambda: F.rms_norm(x, (d,), w, 1e-5))

    g = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    y_lib = F.rms_norm(xr, (d,), wr, 1e-5)  # the library yardstick: autograd of F.rms_norm
    row("rms_norm_bwd", "cuda", "scaling_tpu_torch/csrc/rms_norm_bwd.cu",
        "scaling_tpu/ops/rms_norm.py:130",
        lambda: rms_norm_bwd(x, w, g, 1e-5), lambda: rms_norm_bwd_plain(x, w, g, 1e-5),
        k3_bound_ms(x),
        lambda: torch.autograd.grad(y_lib, (xr, wr), g, retain_graph=True))
    parts = device_ms_by_kernel(lambda: rms_norm_bwd(x, w, g, 1e-5))
    print(f"  rms_norm_bwd {tuple(x.shape)}: device ms by kernel: "
          + (" ".join(f"{n}={ms:.4f}" for n, ms in parts.items()) or "not measured"))
    # the dx-only variant (frozen gains): the library call is autograd of
    # F.rms_norm with respect to x alone
    y_lib_x = F.rms_norm(xr, (d,), w, 1e-5)
    dev_ms, call_ms = time_ms(lambda: rms_norm_bwd(x, w, g, 1e-5, need_dw=False))
    lib_ms = time_ms(lambda: torch.autograd.grad(y_lib_x, (xr,), g, retain_graph=True))[0]
    only_bound = k3_bound_ms(x, need_dw=False)[0]
    print(f"  rms_norm_bwd dx-only {tuple(x.shape)}: device ms={dev_ms:.4f} "
          f"per call={call_ms:.4f} bound={only_bound:.4f} (bytes) library={lib_ms:.4f} "
          f"gbps={only_bound / dev_ms * HBM_BYTES_PER_S / 1e9:.1f}")

    q, k, v, seg = flash_inputs(gen, 1, dev)
    out, lse = flash_attention_fwd(q, k, v, seg)
    dout = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    # the library yardstick: SDPA in its (b, n, s, d) layout, laid out once, untimed
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    y_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0,
                                            enable_gqa=True)
    dout_t = dout.transpose(1, 2).contiguous()
    row("flash_attention_fwd", "cuda", "scaling_tpu_torch/csrc/flash_attention.cu",
        "scaling_tpu/ops/flash_attention.py:160",
        lambda: flash_attention_fwd(q, k, v, seg), lambda: flash_attention_plain(q, k, v, seg),
        k4_bound_ms(q, k),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0,
                                               enable_gqa=True),
        flops=flash_flops(*q.shape))
    row("flash_attention_bwd", "cuda", "scaling_tpu_torch/csrc/flash_attention.cu",
        "scaling_tpu/ops/flash_attention.py:160",
        lambda: flash_attention_bwd(q, k, v, out, lse, dout, seg),
        lambda: flash_attention_bwd_plain(q, k, v, out, lse, dout, seg),
        k5_bound_ms(q, k),
        lambda: torch.autograd.grad(y_sdpa, (qt, kt, vt), dout_t, retain_graph=True),
        flops=2.5 * flash_flops(*q.shape))
    for r in rows:
        launch = {k: r[k][1] for k in ("ms", "plain_ms", "library_ms") if r[k]}
        for k in launch:
            r[k] = r[k][0]  # the JSON line carries device time
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if r["name"].startswith("paged_attention") and r["bound_by"] == "bytes":
            # the bound's bytes over the device time
            r["gbps"] = r["bound_ms"] / r["ms"] * HBM_BYTES_PER_S / 1e9
        rate = f" tflops={r['tflops']:.1f}" if "tflops" in r else ""
        rate += f" gbps={r['gbps']:.1f}" if "gbps" in r else ""
        print(f"  {r['name']}: device ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"library={lib} bound={r['bound_ms']:.4f} ({r['bound_by']}){rate}; "
              "per call with launch (events): "
              + " ".join(f"{k}={v:.4f}" for k, v in launch.items()))
    return rows


# ------------------------------------------------------- MoE and muP
def card_copy(layer: torch.nn.Module, device) -> torch.nn.Module:
    """A copy of ``layer`` on the card (phase 15 (a)'s card side)."""
    import copy

    return copy.deepcopy(layer).to(device)


def moe_layer_check(device: str = "cuda") -> dict:
    """Phase 15 (a): one MoE layer of the phase's model in f32, weights from
    seed 0 and an input of ``MOE["layer_shape"]`` from a numpy seed, on the
    card and on the CPU: the share of tokens routed alike (expert set and
    kept flags), and on them y's error over max |y|; the aux losses."""
    from scaling_tpu_torch.models.transformer import TransformerArchitectureConfig
    from scaling_tpu_torch.nn.moe import ParallelMoEMLP
    from scaling_tpu_torch.serve.bench import MODELS

    arch = TransformerArchitectureConfig.from_dict(MODELS[MOE["model"]])
    cpu_layer = ParallelMoEMLP(arch.hidden_size, arch.mlp_factor, arch.moe_num_experts,
                               top_k=arch.moe_top_k, capacity_factor=arch.moe_capacity_factor,
                               aux_loss_coef=arch.moe_aux_loss_coef, glu=True,
                               activation=arch.activation_function)
    cpu_layer.init_(torch.Generator().manual_seed(0))
    b, s = MOE["layer_shape"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(b, s, arch.hidden_size)).astype(np.float32))
    card_layer = card_copy(cpu_layer, device)
    with torch.no_grad():
        y, aux = cpu_layer(x)
        xc = x.to(device)
        y_card, aux_card = card_layer(xc)
        alike = (routing_decisions(card_layer, xc) == routing_decisions(cpu_layer, x)).all(-1)
    diff = (y_card.cpu() - y).abs().amax(-1)
    scale = y.abs().max().item()
    return {"alike": alike.float().mean().item(),
            "err": diff[alike].max().item() / scale if alike.any() else math.inf,
            "scale": scale, "aux": aux.item(), "aux_card": aux_card.item()}


def check_moe_layer(rec: dict) -> None:
    print(f"  (a) one MoE layer at b, s = {MOE['layer_shape']} in f32, card vs cpu: "
          f"{rec['alike']:.5f} of the tokens routed alike (>= {MOE['route_agree']}); on them "
          f"y max_abs_err/max|y|={rec['err']:.3e} (max|y|={rec['scale']:.4e}, tol "
          f"{MOE['layer_tol']}); aux card={rec['aux_card']:.7f} cpu={rec['aux']:.7f} "
          f"(rtol {MOE['aux_rtol']})")
    if not rec["alike"] >= MOE["route_agree"]:
        raise AssertionError(f"MoE routing on the card disagrees with the CPU's: {rec}")
    if not rec["err"] <= MOE["layer_tol"]:
        raise AssertionError(f"MoE layer output on the card disagrees: {rec}")
    if not abs(rec["aux_card"] - rec["aux"]) <= MOE["aux_rtol"] * abs(rec["aux"]):
        raise AssertionError(f"MoE aux loss on the card disagrees: {rec}")


def moe_phase() -> dict:
    """Phase 15: MoE and muP at the 0.5B widths: (a) the layer alone, (b)
    phase 5's training, (c) phase 4's serving (native KV); every kernel
    K1-K5 launched on (b) and (c) and no plain version. Returns each path's
    launch counters."""
    check_moe_layer(moe_layer_check())
    model = cut_model(MOE["model"], MOE["layers"])
    print(f"  (b) train {MOE['model']} (full width, {MOE['layers']} of its 8 layers, random "
          f"weights, seed 0; mbs {TRAIN_MBS}, seq {TRAIN_SEQ})")
    trained = train(model)
    print("  (c) serve it at phase 4's settings and traffic, native KV")
    served = serve("native", model)
    launched = Counter(trained["launches"]) + Counter(served["launches"])
    needed = ("paged_attention", "rms_norm", "rms_norm_bwd", "flash_attention_fwd",
              "flash_attention_bwd")
    if any(launched[k] <= 0 for k in needed):
        raise AssertionError(f"phase 15 did not launch every kernel K1-K5: {dict(launched)}")
    print(f"  (d) launches: training {trained['launches']}, serving {served['launches']}; "
          "no plain version ran")
    return {"moe_train": trained["launches"], "moe_serve": served["launches"]}


# ------------------------------------------------------------ phase 16
def features_arch(**extra) -> dict:
    """FEATURES["model"] (the 0.5B widths) cut to FEATURES["layers"] layers,
    with ``extra``."""
    from scaling_tpu_torch.train.bench import MODELS

    return dict(MODELS[FEATURES["model"]], num_layers=FEATURES["layers"], **extra)


def settled_memory(dev: torch.device) -> int:
    """The bytes earlier phases still hold on the card once their garbage
    is collected (a cycle freed in the middle of a measurement would pull
    its peak down), 0 on the CPU."""
    gc.collect()
    if dev.type != "cuda":
        return 0
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def multimodal_batch(rng: np.random.Generator, vocab: int, dev) -> dict:
    """One micro-batch (gas 1) of FEATURES["mbs"] rows of FEATURES["seq"]
    tokens, two 384 x 384 images a row at FEATURES["image_starts"], the
    placeholders' loss weight 0."""
    mbs, s = FEATURES["mbs"], FEATURES["seq"]
    tokens = rng.integers(1, vocab, size=(1, mbs, s))
    weights = np.ones((1, mbs, s), np.float32)
    starts = FEATURES["image_starts"]
    for st in starts:
        weights[..., st:st + 144] = 0.0
    batch = {"token_ids": tokens, "target_token_ids": np.roll(tokens, -1, axis=-1),
             "position_ids": np.broadcast_to(np.arange(s, dtype=np.int32), (1, mbs, s)).copy(),
             "segment_ids": np.zeros((1, mbs, s), np.int32), "loss_weights": weights,
             "input_images": rng.normal(size=(1, mbs, len(starts), 384, 384, 3)).astype(
                 np.float32),
             "input_image_locations": np.broadcast_to(np.array(starts, np.int32),
                                                      (1, mbs, len(starts))).copy(),
             "input_image_mask": np.ones((1, mbs, len(starts)), bool)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def multimodal_check(device: str = "cuda") -> dict:
    """Phase 16 (a): the 2-layer 0.5B model with the ViT encoder at its
    defaults trained on one multimodal batch for FEATURES["steps"] steps,
    counters reset just before and read just after; the loss must fall; the
    logits before the first image must not move, bitwise, when the images
    change. Returns the counters, the step ms and the peak GB."""
    from scaling_tpu_torch.models.transformer import (
        TransformerConfig,
        init_model,
        init_optimizer,
        loss_function,
    )
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.train.bench import OPTIMIZER

    dev = torch.device(device)
    held = settled_memory(dev)
    config = TransformerConfig.from_dict({
        "topology": {"micro_batch_size": FEATURES["mbs"], "gradient_accumulation_steps": 1},
        "transformer_architecture": features_arch(sequence_length=FEATURES["seq"],
                                                  image_encoder=True, **FEATURES["encoder"]),
        "optimizer": OPTIMIZER,
        "learning_rate_scheduler": {"learning_rate": FEATURES["lr"],
                                    "learning_rate_warmup_steps": 1,
                                    "learning_rate_decay_iters": 1000},
        "trainer": {"seed": 0}})
    module = init_model(config, device=dev)
    n_params = sum(p.numel() for p in module.model.parameters())
    n_encoder = sum(p.numel() for p in module.model.embedding.image_encoder.parameters())
    step = module.build_train_step(init_optimizer(config, module.model), loss_function)
    rng = np.random.default_rng(FEATURES["seed"])
    batch = multimodal_batch(rng, config.transformer_architecture.vocab_size, dev)
    first = FEATURES["image_starts"][0]
    with torch.no_grad():
        row = {k: v[0] for k, v in batch.items()}
        a = module.forward(row)["activations"]
        other = dict(row, input_images=torch.from_numpy(rng.normal(
            size=tuple(row["input_images"].shape)).astype(np.float32)).to(dev))
        b = module.forward(other)["activations"]
        kept = torch.equal(a[:, :first], b[:, :first])
        moved = (a[:, first:] - b[:, first:]).abs().max().item()
        del a, b, other, row
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    launches.reset()
    losses, times = [], []
    for _ in range(FEATURES["steps"]):
        t0 = time.perf_counter()
        losses.append(float(step(batch)[0]))  # the loss's fetch syncs the step
        times.append((time.perf_counter() - t0) * 1e3)
    kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 1e9 if device == "cuda" else None
    step_ms = statistics.median(times[1:])
    print(f"  (a) multimodal: params={n_params} (image encoder {n_encoder}), mbs "
          f"{FEATURES['mbs']}, seq {FEATURES['seq']}, {len(FEATURES['image_starts'])} images a "
          f"row at {FEATURES['image_starts']}: losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; step {step_ms:.2f}ms (median of steps 2-{FEATURES['steps']}, host clock to the "
          f"loss's fetch); peak max_memory_allocated above what earlier phases hold "
          + ("not measured" if peak is None else f"{peak:.2f}GB (they hold {held / 1e9:.2f}GB)"))
    print(f"  (a) other images: logits before position {first} bitwise the same: {kept}; "
          f"after it they moved by up to {moved:.3e}")
    print(f"  (a) launches kernel={kernel} plain={plain}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"multimodal: the loss did not fall: {losses}")
    if not kept or not moved > 0:
        raise AssertionError("multimodal: the logits before the first image moved with the "
                             "image, or none after it did")
    needed = ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd")
    if device == "cuda" and (any(kernel.get(k, 0) <= 0 for k in needed)
                             or sum(plain.values()) != 0):
        raise AssertionError(f"multimodal: K2-K5 not all launched, or a plain version ran: "
                             f"{kernel} {plain}")
    del module, step, batch
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": kernel, "step_ms": step_ms, "peak_gb": peak}


def init_encoder(encoder: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every ``init_`` of ``encoder``'s modules from one seeded generator."""
    gen = torch.Generator(device=next(encoder.parameters()).device).manual_seed(seed)
    for m in encoder.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
    return encoder


def drawn_clip_state(width: int, layers: int, grid: int, seed: int) -> dict:
    """A CLIPVisionModel state dict drawn from a seed (patch 32, ``grid`` x
    ``grid`` positions, MLP 4x): normal weights of std 0.02, LayerNorms at 1
    and 0, as a pretrained file would lay them out."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    sd = {"vision_model.embeddings.class_embedding": normal(width),
          "vision_model.embeddings.patch_embedding.weight": normal(width, 3, 32, 32),
          "vision_model.embeddings.position_embedding.weight": normal(grid * grid + 1, width),
          "vision_model.pre_layrnorm.weight": torch.ones(width),
          "vision_model.pre_layrnorm.bias": torch.zeros(width)}
    for i in range(layers):
        base = f"vision_model.encoder.layers.{i}"
        for name, (o, n) in {"self_attn.q_proj": (width, width), "self_attn.k_proj": (width, width),
                             "self_attn.v_proj": (width, width),
                             "self_attn.out_proj": (width, width),
                             "mlp.fc1": (4 * width, width), "mlp.fc2": (width, 4 * width)}.items():
            sd[f"{base}.{name}.weight"], sd[f"{base}.{name}.bias"] = normal(o, n), normal(o)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{base}.{ln}.weight"], sd[f"{base}.{ln}.bias"] = torch.ones(width), torch.zeros(width)
    return sd


def encoder_vs_cpu(encoder, images: torch.Tensor) -> tuple:
    """The first image through ``encoder`` on the card and through an f32
    copy on the CPU: (max |card - cpu| / max |cpu|, the least such error
    constant features per token could reach)."""
    cpu = copy_module_f32(encoder)
    with torch.no_grad():
        card = encoder(images[:1]).float().cpu()
        ref = cpu(images[:1].cpu())
    scale = ref.abs().max().item()
    return ((card - ref).abs().max().item() / scale,
            ((ref.amax(-1) - ref.amin(-1)) / 2).max().item() / scale)


def copy_module_f32(module: torch.nn.Module) -> torch.nn.Module:
    """An f32 copy of ``module`` on the CPU (its ``dtype`` attributes too)."""
    import copy

    cpu = copy.deepcopy(module).float().cpu()
    for m in cpu.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    return cpu


def clip_backbones_check(device: str = "cuda") -> dict:
    """Phase 16 (b): the RN50x16 trunk at its defaults, forward and backward
    on FEATURES["clip_images"] images in bf16, and a CLIP ViT at the
    encoder's defaults from a drawn state dict, forward; one image of each
    against the CPU in f32. Returns each one's ms."""
    from scaling_tpu_torch.models.transformer.image_encoder import ImageEncoder

    dev = torch.device(device)
    rng = np.random.default_rng(FEATURES["seed"] + 1)
    images = torch.from_numpy(rng.normal(size=(FEATURES["clip_images"], 384, 384, 3)).astype(
        np.float32)).to(dev)
    width = features_arch()["hidden_size"]
    held = settled_memory(dev)
    out = {}
    resnet = init_encoder(ImageEncoder(width, backbone="clip_resnet", dtype=torch.bfloat16,
                                       device=dev, **FEATURES["resnet"]), FEATURES["seed"])
    n_resnet = sum(p.numel() for p in resnet.parameters())

    def resnet_step():
        resnet.zero_grad(set_to_none=True)
        y = resnet(images)
        y.float().square().mean().backward()
        return y

    resnet_step()  # cuDNN picks its algorithms
    if device == "cuda":
        out["resnet_fwd_bwd_ms"] = timed_ms(resnet_step, 3)
        torch.cuda.reset_peak_memory_stats(dev)
    y = resnet_step().detach()
    if device == "cuda":
        out["resnet_peak_gb"] = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
    stats = [p for n, p in resnet.named_parameters() if n.endswith((".mean", ".var"))]
    no_grad = all(p.grad is None for p in stats)
    finite = bool(torch.isfinite(y).all()) and all(
        p.grad is None or bool(torch.isfinite(p.grad).all()) for p in resnet.parameters())
    resnet.zero_grad(set_to_none=True)
    err, uniform = encoder_vs_cpu(resnet, images)
    trunk = resnet.clip
    print(f"  (b) clip_resnet (stages {trunk.stage_blocks}, {trunk.channels} channels: RN50x16 "
          f"at the defaults; {n_resnet} parameters) on {len(images)} images: tokens "
          f"{tuple(y.shape)}, forward and backward "
          + (f"{out['resnet_fwd_bwd_ms']:.2f}ms (median of 3), peak above earlier phases' "
             f"{out['resnet_peak_gb']:.2f}GB" if "resnet_fwd_bwd_ms" in out else "not timed")
          + f"; BatchNorm statistics without gradient: {no_grad}; one image card bf16 vs cpu "
          f"f32 max_abs_err/max|y|={err:.3e} (tol {FEATURES['encoder_tol']}; constant tokens "
          f"would give >= {uniform:.3e})")
    if y.shape != (len(images), 144, width) or not finite or not no_grad:
        raise AssertionError("clip_resnet: wrong tokens, a non-finite value or a gradient on "
                             "the BatchNorm statistics")
    if not err <= FEATURES["encoder_tol"] < uniform:
        raise AssertionError(f"clip_resnet: card vs cpu {err} (constant {uniform})")
    del resnet, y
    vit = ImageEncoder(width, backbone="clip", dtype=torch.bfloat16, device=dev,
                       **FEATURES["vit"])
    init_encoder(vit, FEATURES["seed"])
    grid = FEATURES["clip_source_grid"]
    vit.load_clip_weights(drawn_clip_state(vit.clip.width, vit.clip.num_layers, grid,
                                           FEATURES["seed"]))
    with torch.no_grad():
        vit(images)
        if device == "cuda":
            out["vit_fwd_ms"] = timed_ms(lambda: vit(images), 3)
        y = vit(images)
    err, uniform = encoder_vs_cpu(vit, images)
    print(f"  (b) clip ViT ({vit.clip.width} wide, {vit.clip.num_layers} blocks; a {grid} x "
          f"{grid} grid imported and "
          f"interpolated to 12 x 12) on {len(images)} images: tokens {tuple(y.shape)}, forward "
          + (f"{out['vit_fwd_ms']:.2f}ms" if "vit_fwd_ms" in out else "not timed")
          + f"; one image card bf16 vs cpu f32 max_abs_err/max|y|={err:.3e} (tol "
          f"{FEATURES['encoder_tol']}; constant tokens would give >= {uniform:.3e})")
    if y.shape != (len(images), 144, width) or not bool(torch.isfinite(y).all()):
        raise AssertionError("clip ViT: wrong tokens or a non-finite value")
    if not err <= FEATURES["encoder_tol"] < uniform:
        raise AssertionError(f"clip ViT: card vs cpu {err} (constant {uniform})")
    del vit, y, images
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def local_window_check(device: str = "cuda") -> dict:
    """Phase 16 (c): FEATURES["local_heads"] of 16 heads local: greedy
    ``generate`` of FEATURES["local_prompts"] prompts cached and with
    ``use_cache=False``, counters reset just before and read just after;
    the prefill must run K4 with its local heads. Returns the counters."""
    from scaling_tpu_torch.models.transformer import (
        TransformerArchitectureConfig,
        TransformerInferenceModule,
    )
    from scaling_tpu_torch.ops import launches

    flash_module = importlib.import_module("scaling_tpu_torch.ops.flash_attention")
    arch = TransformerArchitectureConfig.from_dict(features_arch(
        num_local_attention_heads=FEATURES["local_heads"],
        local_attention_window_size=FEATURES["window"]))
    inf = TransformerInferenceModule.random_init(arch, seed=0, device=device)
    rng = np.random.default_rng(FEATURES["seed"] + 2)
    prompts = [rng.integers(1, arch.vocab_size, size=FEATURES["local_prompt_len"]).tolist()
               for _ in range(FEATURES["local_prompts"])]
    inf.generate(prompts[0][:128], max_tokens=2)  # warm-up, off the books
    local_heads = []
    launch = flash_module.flash_attention_fwd

    def spy(q, k, v, segment_ids, num_local_heads=0, *a, **kw):
        local_heads.append(num_local_heads)
        return launch(q, k, v, segment_ids, num_local_heads, *a, **kw)

    flash_module.flash_attention_fwd = spy
    try:
        launches.reset()
        t0 = time.monotonic()
        cached = inf.generate(prompts, max_tokens=FEATURES["local_tokens"])
        t1 = time.monotonic()
        uncached = inf.generate(prompts, max_tokens=FEATURES["local_tokens"], use_cache=False)
        t2 = time.monotonic()
        kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    finally:
        flash_module.flash_attention_fwd = launch
    got = {i: o.completion_ids for i, o in enumerate(cached)}
    want = {i: o.completion_ids for i, o in enumerate(uncached)}
    equal = check_near_ties(inf, prompts, got, want, "local-window decode")
    rec = recompute_generation(inf, prompts[0], cached[0])
    print(f"  (c) the first row's cached decode recomputed on the CPU in f32 without a cache "
          f"(plain versions): logits max_abs_err/max|logit|={rec['err']:.3e} (tol "
          f"{GEN_LOGIT_TOL}; constant logits would give >= {rec['uniform_err']:.3e}); tokens "
          f"where the CPU's top-2 margin exceeds 2x the error: {rec['sure']}, of which not the "
          f"CPU argmax: {rec['disagree']}")
    if not rec["err"] <= GEN_LOGIT_TOL < rec["uniform_err"] or rec["disagree"]:
        raise AssertionError(f"local-window: the cached decode disagrees with the CPU: {rec}")
    print(f"  (c) {FEATURES['local_heads']} of {arch.num_attention_heads} heads local (window "
          f"{FEATURES['window']}): {len(prompts)} prompts of {FEATURES['local_prompt_len']} "
          f"tokens, {FEATURES['local_tokens']} greedy tokens: cached {t1 - t0:.2f}s, "
          f"use_cache=False {t2 - t1:.2f}s; {equal}/{len(prompts)} requests' tokens equal, the "
          f"others part first at a near tie; K4 ran with num_local_heads "
          f"{sorted(set(local_heads))}")
    print(f"  (c) launches kernel={kernel} plain={plain}")
    if not local_heads or any(n != FEATURES["local_heads"] for n in local_heads):
        raise AssertionError(f"local-window: K4 did not run with the local heads: {local_heads}")
    if device == "cuda" and (kernel.get("flash_attention_fwd", 0) <= 0
                             or kernel.get("rms_norm", 0) <= 0 or sum(plain.values()) != 0):
        raise AssertionError(f"local-window: K4 or K2 not launched, or a plain version ran: "
                             f"{kernel} {plain}")
    del inf
    if device == "cuda":
        torch.cuda.empty_cache()
    return kernel


def remat_modes_check(device: str = "cuda") -> dict:
    """Phase 16 (d): phase 5's step (8 layers) without remat, with
    ``every_layer`` and with ``every_layer_save_dots`` from one module, each
    after a warm-up step: step ms, peak memory and launches a step, counters
    reset just before each mode's timed steps and read just after;
    ``every_layer_save_dots`` must launch each of K2-K5 as often as
    ``every_layer``. Returns the save_dots steps' counters and the numbers."""
    from scaling_tpu_torch.models.transformer import loss_function
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.topology import ActivationCheckpointingType as Remat
    from scaling_tpu_torch.train.bench import build, synth_batch

    dev = torch.device(device)
    held = settled_memory(dev)
    config, module, optimizer = build(FEATURES["remat_model"], FEATURES["seq"], FEATURES["mbs"],
                                      device=dev, seed=0)
    step = module.build_train_step(optimizer, loss_function)
    batch = synth_batch(np.random.default_rng(0), FEATURES["mbs"], FEATURES["seq"],
                        config.transformer_architecture.vocab_size, 1, dev)
    topology = module.topology
    rows = {}
    for mode in (Remat.DISABLED, Remat.EVERY_LAYER, Remat.EVERY_LAYER_SAVE_DOTS):
        module.topology = dataclasses.replace(topology, activation_checkpointing_type=mode)
        float(step(batch)[0])
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        launches.reset()
        t0 = time.perf_counter()
        losses = [step(batch)[0] for _ in range(FEATURES["remat_steps"])]
        float(losses[-1])
        if device == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FEATURES["remat_steps"]
        rows[mode] = {"ms": ms, "launches": dict(launches.KERNEL),
                      "plain": dict(launches.PLAIN),
                      "ran": dict(launches.KERNEL if device == "cuda" else launches.PLAIN),
                      "peak_gb": ((torch.cuda.max_memory_allocated(dev) - held) / 1e9
                                  if device == "cuda" else None)}
        if device == "cuda":  # where the time goes: the host's dispatch, the device's work
            rows[mode]["split"] = host_and_device_ms(step, batch)
    module.topology = topology
    n = FEATURES["remat_steps"]
    for mode, r in rows.items():
        per_step = {k: v / n for k, v in sorted(r["launches"].items())}
        print(f"  (d) phase 5's step, {mode}: {r['ms']:.2f}ms a step (mean of {n}), peak above "
              "earlier phases' " + ("not measured" if r["peak_gb"] is None else
                                    f"{r['peak_gb']:.2f}GB (they hold {held / 1e9:.2f}GB)")
              + f"; launches a step {per_step}, plain {r['plain']}")
        if "split" in r:
            sp = r["split"]
            print(f"  (d) {mode}: host dispatch {sp['dispatch_ms']:.2f}ms of {sp['step_ms']:.2f}ms "
                  f"with its sync (medians of 3); one profiled step: device busy="
                  f"{sp['device_busy_ms']:.3f}ms idle share={sp['device_idle_share']:.3f} "
                  "device ms by group: " + " ".join(f"{k}={v:.3f}"
                                                    for k, v in sp["device_ms"].items()))
    dots, layer = rows[Remat.EVERY_LAYER_SAVE_DOTS], rows[Remat.EVERY_LAYER]
    needed = ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd")
    if any(dots["ran"].get(k, 0) != layer["ran"].get(k, 0) or dots["ran"].get(k, 0) <= 0
           for k in needed):
        raise AssertionError(f"save_dots: its launches differ from every_layer's: "
                             f"{dots['ran']} vs {layer['ran']}")
    if device == "cuda" and (any(dots["launches"].get(k, 0) <= 0 for k in needed)
                             or any(sum(r["plain"].values()) for r in rows.values())):
        raise AssertionError("save_dots: K2-K5 not launched, or a plain version ran")
    del module, optimizer, step, batch
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": dots["launches"], "rows": rows}


def features_phase(device: str = "cuda") -> dict:
    """Phase 16: (a)-(d) of FEATURES. Returns each path's launch counters."""
    multimodal = multimodal_check(device)
    clip_backbones_check(device)
    local = local_window_check(device)
    remat = remat_modes_check(device)
    return {"multimodal": multimodal["launches"], "local_window": local,
            "remat_save_dots": remat["launches"]}


# ------------------------------------------------------------ tooling (phase 17)
def write_tntidx(prefix: Path, docs: list, dtype) -> None:
    """The Megatron TNTIDX layout written with numpy, as the docstring of
    ``data/legacy_indexed_dataset.py`` sets it out: one dim a document."""
    dtype = np.dtype(dtype)
    sizes = np.asarray([len(d) for d in docs], np.int64)
    code = {np.dtype(np.uint16): 8, np.dtype(np.int32): 4}[dtype]
    with open(prefix.with_suffix(".bin"), "wb") as f:
        for d in docs:
            f.write(np.asarray(d, dtype).tobytes())
    with open(prefix.with_suffix(".idx"), "wb") as f:
        f.write(b"TNTIDX\x00\x00")
        f.write(struct.pack("<QQQQQQ", 1, code, dtype.itemsize, len(docs), len(docs),
                            len(docs) + 1))
        for arr in (np.arange(len(docs) + 1), np.concatenate([[0], np.cumsum(sizes)]), sizes,
                    np.arange(len(docs) + 1)):
            f.write(np.asarray(arr, np.int64).tobytes())


def write_legacy_datasets(root: Path, vocab: int) -> dict:
    """(a)'s data: ~TOOLING["tokens"] tokens in each Megatron layout, MMIDIDX
    by the port's writer and TNTIDX by numpy, uint16 documents of
    ``doc_len`` tokens ending in EOD 0, from seed 0."""
    from scaling_tpu_torch.data import LegacyMMapIndexWriter

    rng = np.random.default_rng(0)
    docs = {}
    for name in ("mmidx", "tntidx"):
        docs[name], written = [], 0
        while written < TOOLING["tokens"]:
            doc = rng.integers(1, vocab, size=int(rng.integers(*TOOLING["doc_len"])) - 1)
            docs[name].append(np.append(doc, 0))
            written += doc.size + 1
    with LegacyMMapIndexWriter(root / "mmidx", dtype=np.uint16) as writer:
        for d in docs["mmidx"]:
            writer.add(d)
    write_tntidx(root / "tntidx", docs["tntidx"], np.uint16)
    return {name: str(root / name) for name in docs}


def legacy_trainer_check(root: Path, device: str) -> dict:
    """(a): TOOLING["steps"] Trainer steps of phase 8's model over a blend of
    the two Megatron datasets with ``legacy_dataset`` and
    ``only_full_sequences``; the C++ builder's windows against the plain
    loop's; K2-K5 launched, no plain version. The counters are reset just
    before and read just after."""
    from scaling_tpu_torch.data import LegacyIndexedDataset
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import main
    from scaling_tpu_torch.native import build_pack_index_plain
    from scaling_tpu_torch.ops import launches

    t0 = time.monotonic()
    (root / "legacy").mkdir()
    prefixes = write_legacy_datasets(root / "legacy", trainer_arch()["vocab_size"])
    written = time.monotonic() - t0
    cfg = trainer_config({"a": prefixes["mmidx"], "b": prefixes["tntidx"], "valid": None},
                         root / "legacy_logs")
    cfg["data"] = {"data_prefixes": [prefixes["mmidx"], prefixes["tntidx"]],
                   "legacy_dataset": True, "only_full_sequences": True,
                   "eod_token_id": 0}
    cfg["trainer"].update(train_iterations=TOOLING["steps"], eval_interval=None,
                          eval_iterations=0)
    launches.reset()
    try:
        trainer = main(TransformerConfig.from_dict(cfg), device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
        windows = {}
        for ds in trainer.dataset.datasets:
            if not isinstance(ds.memory_map, LegacyIndexedDataset):
                raise AssertionError(f"{ds.data_prefix} is not read as Megatron data")
            starts, ends = build_pack_index_plain(ds.memory_map.sizes(), ds.sequence_length,
                                                  ds.allow_incomplete_sequences_every_n)
            if not (np.array_equal(ds._item_starts, starts)
                    and np.array_equal(ds._item_ends, ends)):
                raise AssertionError(f"{ds.data_prefix}: the C++ windows are not the loop's")
            windows[Path(ds.data_prefix).name] = len(starts)
        iterations = trainer.context.iterations
        del trainer
    finally:
        reset_logger()
    records = metric_records(root / "legacy_logs" / "metrics_rank_0.jsonl")
    steps = [r for r in records if "loss" in r["metrics"]]
    losses = [r["metrics"]["loss"] for r in steps]
    if iterations != TOOLING["steps"] or len(losses) != TOOLING["steps"]:
        raise AssertionError(f"(a) trained {iterations} steps, records {len(losses)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"(a) non-finite losses {losses}")
    step_ms = statistics.median(r["metrics"]["step_duration"] for r in steps[1:]) * 1e3
    print(f"  (a) Megatron data written in {written:.1f}s; windows by the C++ builder equal "
          f"to the plain loop's: {windows}; {TOOLING['steps']} steps, losses {losses}, "
          f"step {step_ms:.2f}ms (median of steps 2-{TOOLING['steps']}, host clock to the "
          f"loss's fetch)")
    print(f"  (a) launches kernel={kernel} plain={plain}")
    if device == "cuda":
        needed = ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd")
        if any(kernel.get(k, 0) <= 0 for k in needed) or sum(plain.values()):
            raise AssertionError(f"(a) kernels {kernel}, plain versions {plain}")
        torch.cuda.empty_cache()
    return {"launches": kernel, "step_ms": step_ms, "losses": losses}


def pack_builder_check() -> dict:
    """(b): the C++ builder and the plain loop over TOOLING["pack_docs"]
    document sizes from seed 0 at sequence 2048, each
    ``allow_incomplete_sequences_every_n`` of TOOLING["pack_every_n"]; the
    spans must be equal. Host seconds of each."""
    from scaling_tpu_torch import native

    t0 = time.monotonic()
    native.load()
    loaded = time.monotonic() - t0
    sizes = np.random.default_rng(0).integers(TOOLING["pack_doc_len"][0],
                                              TOOLING["pack_doc_len"][1] + 1,
                                              size=TOOLING["pack_docs"])
    out = {}
    for every_n in TOOLING["pack_every_n"]:
        t0 = time.monotonic()
        got = native.build_pack_index(sizes, TRAIN_SEQ, every_n)
        cpp_s = time.monotonic() - t0
        t0 = time.monotonic()
        want = native.build_pack_index_plain(sizes, TRAIN_SEQ, every_n)
        plain_s = time.monotonic() - t0
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"(b) every_n {every_n}: the C++ spans are not the loop's")
        out[every_n] = {"cpp_s": cpp_s, "plain_s": plain_s, "windows": len(got[0])}
        print(f"  (b) {len(sizes)} documents, {int(sizes.sum())} tokens, every_n {every_n}: "
              f"{len(got[0])} windows, equal; C++ {cpp_s * 1e3:.1f}ms, plain loop "
              f"{plain_s * 1e3:.1f}ms ({plain_s / cpp_s:.0f}x)")
    print(f"  (b) the C++ builder loaded (built with g++ if missing) in {loaded:.2f}s")
    return out


def reference_round_trip(base: dict, root: Path, device: str) -> dict:
    """(c): phase 8's step-6 checkpoint exported to the reference's format
    and imported back, bit-equal to the source; the import served for
    TOOLING["serve_requests"] requests (native KV, phase 4's traffic),
    greedy tokens against ``generate``'s under the near-tie rule; K1 and K2
    launched, no plain version (the counters reset just before the engine
    and read just after ``generate``)."""
    from scaling_tpu_torch.checkpoint.export_reference import export_reference_checkpoint
    from scaling_tpu_torch.checkpoint.import_reference import convert_reference_checkpoint
    from scaling_tpu_torch.models.transformer import TransformerInferenceModule
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.serve import EngineConfig, ServeEngine
    from scaling_tpu_torch.serve.bench import sample_workload

    src = base["ckpt"] / (base["ckpt"] / "latest").read_text()
    weights = sum(f.stat().st_size for f in src.glob("model_state_layer_*.npz"))
    t0 = time.monotonic()
    written = export_reference_checkpoint(src, root / "ref")
    export_s = time.monotonic() - t0
    pt_bytes = sum(f.stat().st_size for f in (root / "ref").glob("*.pt"))
    t0 = time.monotonic()
    converted = convert_reference_checkpoint(root / "ref", root / "imported")
    import_s = time.monotonic() - t0
    for f in src.glob("model_state_layer_*.npz"):
        with np.load(f) as want, np.load(root / "imported" / f.name) as got:
            if sorted(got.files) != sorted(want.files) or any(
                    got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k])
                    for k in want.files):
                raise AssertionError(f"(c) {f.name}: the import is not the source bit for bit")
    print(f"  (c) export: {written} .pt files, {pt_bytes / 1e9:.3f} GB bf16 from "
          f"{weights / 1e9:.3f} GB of f32 npz, {export_s:.2f}s ({weights / export_s / 1e9:.2f} "
          f"GB/s of npz); import: {converted} npz files in {import_s:.2f}s "
          f"({weights / import_s / 1e9:.2f} GB/s of npz), bit-equal to the source")
    shutil.copy(src / "config.yml", root / "imported" / "config.yml")
    served = TransformerInferenceModule.from_checkpoint(root / "imported", device=device)
    arch = served.architecture
    work = sample_workload(TOOLING["serve_requests"], WORKLOAD["rate"], WORKLOAD["prompt_len"],
                           WORKLOAD["output_len"], arch.vocab_size, WORKLOAD["seed"])
    launches.reset()
    engine = ServeEngine(served, EngineConfig(kv_dtype="native", **SERVE), device=device)
    for _, prompt, olen in work:
        engine.submit(prompt, olen)
    tokens = {s.request.req_id: list(s.generated) for s in engine.run_until_done()}
    versus = served_vs_generated(served, [tokens[i] for i in sorted(tokens)], work)
    if device == "cuda":
        torch.cuda.synchronize()
    kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
    print(f"  (c) served {len(work)} requests of the import: greedy tokens equal to generate's "
          f"in {versus['equal']}/{len(work)}, the others part at a near tie (request, token, "
          f"logit gap, max|logit|): {versus['ties']}; launches kernel={kernel} plain={plain}")
    if device == "cuda" and (any(kernel.get(k, 0) <= 0 for k in ("paged_attention", "rms_norm"))
                             or sum(plain.values())):
        raise AssertionError(f"(c) kernels {kernel}, plain versions {plain}")
    del engine, served
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": kernel, "export_s": export_s, "import_s": import_s,
            "weights_bytes": weights}


def restore_faults_check(base: dict, root: Path, device: str) -> dict:
    """(d): one Trainer of phase 8's config loads phase 8's kept steps 3
    and 6 (model files, ``latest`` at 6) with ``restore.assemble`` failing
    once (retried: step 6) and failing each of its 3 tries (step 6
    demoted: step 3), then a copy of step 6 whose ``MESH.json`` names two
    devices (``ckpt.reshard`` fires once). Host seconds of each load,
    the crc32 verification included."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.models.transformer.train import build_trainer
    from scaling_tpu_torch.resilience import FaultPlan, get_fault_plan, set_fault_plan
    from scaling_tpu_torch.resilience.manifest import write_manifest

    cfg = trainer_config({**base["prefixes"], "valid": None}, root / "restore_logs")
    cfg["data"].pop("validation_data_prefixes")
    cfg["trainer"].update(eval_interval=None, eval_iterations=0, load_optimizer_states=False)
    trainer = build_trainer(TransformerConfig.from_dict(cfg), device=device)
    older, newest = sorted(int(d.name[len("global_step"):])
                           for d in base["ckpt"].glob("global_step*"))[-2:]
    latest = base["ckpt"] / f"global_step{newest}"
    n_files = len(list(latest.glob("model_state_layer_*.npz")))
    mesh = root / "mesh" / latest.name
    shutil.copytree(latest, mesh, copy_function=os.link)
    meta = json.loads((mesh / "MESH.json").read_text())
    meta["topology"].update(world_size=2, data_parallel_size=2)
    for name in ("MESH.json", "MANIFEST.json"):  # links: new files, the originals untouched
        (mesh / name).unlink()
    (mesh / "MESH.json").write_text(json.dumps(meta))
    write_manifest(mesh, newest)
    out = {}
    try:
        for name, where, spec, step, point, hits in (
                ("transient", base["ckpt"], "restore.assemble=fail@1", newest,
                 "restore.assemble", 1 + n_files),
                ("persistent", base["ckpt"], "restore.assemble=fail@1x3", older,
                 "restore.assemble", 3 + n_files),
                ("reshard", mesh.parent, "", newest, "ckpt.reshard", 1)):
            set_fault_plan(FaultPlan(spec))
            t0 = time.monotonic()
            if not trainer.load_checkpoint(where):
                raise AssertionError(f"(d) {name}: nothing restored")
            if device == "cuda":
                torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            got = (trainer.context.iterations, get_fault_plan().hits(point))
            print(f"  (d) {name} ({spec or 'MESH.json of 2 devices'}): restored step {got[0]}, "
                  f"{point} hits {got[1]}, {seconds:.2f}s")
            if got != (step, hits):
                raise AssertionError(f"(d) {name}: step and hits {got}, expected {(step, hits)}")
            out[name] = seconds
    finally:
        set_fault_plan(None)
        del trainer
        reset_logger()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


LADDER_LINE = re.compile(
    r"^mbs=(\d+) (?:(out of memory)|([0-9.]+) tokens/s(?: peak ([0-9.]+) GB)?)$")


def ladder_check(device: str) -> dict:
    """(e): ``python -m scaling_tpu_torch.train.bench`` climbing
    TOOLING["mbs_plan"] at phase 5's model (8 layers) in a child process,
    so that an out-of-memory rung cannot leave fragments in this process's
    allocator. Each rung's tokens/s, the winner and its MFU; no plain
    version ran in the child."""
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        print(f"  (e) this process holds {held / 1e9:.2f} GB of the card while the child runs")
    cmd = [sys.executable, "-m", "scaling_tpu_torch.train.bench", "--model", TOOLING["model"],
           "--mbs-plan", TOOLING["mbs_plan"], "--steps", str(TOOLING["ladder_steps"]),
           "--seq-len", str(TOOLING["ladder_seq"]), "--device", device]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=TOOLING["ladder_timeout_s"])
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(e) the ladder exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    lines = {line.split(": ", 1)[0]: line.split(": ", 1)[1]
             for line in proc.stdout.splitlines() if ": " in line}
    rungs_text, winner = lines["ladder"].rsplit("; winner mbs=", 1)
    rungs = []
    for part in rungs_text.split(", "):
        m = LADDER_LINE.match(part)
        if m is None:
            raise AssertionError(f"(e) unreadable rung {part!r}")
        rungs.append({"mbs": int(m.group(1)), "oom": bool(m.group(2)),
                      "tokens_per_s": None if m.group(2) else float(m.group(3)),
                      "peak_gb": None if m.group(4) is None else float(m.group(4))})
    counts = json.loads(lines["launches"])
    for line in proc.stdout.splitlines():
        print(f"  (e) | {line}")
    print(f"  (e) the child ran {seconds:.1f}s")
    if device == "cuda" and (sum(counts["plain"].values()) or not counts["kernel"]):
        raise AssertionError(f"(e) launches {counts}")
    return {"rungs": rungs, "winner": int(winner), "seconds": seconds,
            "launches": counts["kernel"]}


def tooling_phase(base: dict, device: str = "cuda", ladder_out=None) -> dict:
    """Phase 17: (a)-(e) of TOOLING on phase 8's kept checkpoint and data.
    Returns the launch counters of (a)'s training and (c)'s serving; (e)'s
    rungs and winner go into ``ladder_out`` when given (phase 18 (c))."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tooling_"))
    try:
        trained = legacy_trainer_check(root, device)
        pack_builder_check()
        served = reference_round_trip(base, root, device)
        restore_faults_check(base, root, device)
        ladder = ladder_check(device)
        if ladder_out is not None:
            ladder_out.update(ladder)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"tooling_legacy_trainer": trained["launches"],
            "tooling_import_serve": served["launches"]}


# ------------------------------------------------ phase 18: the tuner, the audit
def mean_tick_s(run_dir: Path) -> tuple:
    """(mean seconds, count) of the ``serve.mixed`` / ``serve.decode``
    spans of a serve run directory: the tick the serving tuner prices."""
    spans = [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]
    ticks = [e["dur_s"] for e in spans
             if e.get("span") in ("serve.mixed", "serve.decode") and e.get("dur_s") is not None]
    return statistics.fmean(ticks), len(ticks)


def fit_block_overhead(ms: dict) -> tuple:
    """``t(bs) = c * (1 + O / bs)``, least squares of t on 1/bs: (c, O)."""
    xs, ys = [1.0 / bs for bs in ms], list(ms.values())
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    c = my - slope * mx
    return c, slope / c


def k1_block_sizes(device: str = "cuda") -> dict:
    """Phase 18 (a): K1 alone at each block size the serving tuner searches
    (TUNE["block_sizes"]), at phase 4's tick shape (16 rows of 32 queries,
    the same contexts up to 2048 slots) over one 16384-slot pool, each
    held against its plain version; device ms from ``torch.profiler``, and
    the fit of ``t = c * (1 + O / bs)`` whose O is the serving tuner's
    ``PAGED_BLOCK_OVERHEAD`` (the CPU times the plain version instead)."""
    from scaling_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
    from scaling_tpu_torch.tune.serving import PAGED_BLOCK_OVERHEAD

    rows, ms = [], {}
    for bs in TUNE["block_sizes"]:
        gen = torch.Generator(device=device).manual_seed(11)
        args, kw = k1_inputs(gen, False, device, block_size=bs)
        out = paged_attention(*args, **kw)
        ref = paged_attention_plain(*args, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= KERNEL_TOL + KERNEL_TOL * ref.float().abs().max().item():
            raise AssertionError(f"(a) K1 at block size {bs} disagrees with its plain "
                                 f"version: {err}")
        if device == "cuda":
            ms[bs] = time_ms(lambda: paged_attention(*args, **kw), TUNE["reps"])[0]
        else:
            t0 = time.perf_counter()
            paged_attention(*args, **kw)
            ms[bs] = (time.perf_counter() - t0) * 1e3
        b_ms, by = k1_bound_ms(args, kw)
        rows.append((bs, ms[bs], b_ms, by, err))
    c, overhead = fit_block_overhead(ms)
    for bs, t, b_ms, by, err in rows:
        print(f"  (a) K1 at block size {bs}: {t:.4f}ms (bound {b_ms:.4f}ms, {by}; "
              f"{b_ms / t:.0%} of it), max_abs_err {err:.3e} vs the plain version; "
              f"the fit's {c * (1 + overhead / bs):.4f}ms")
    print(f"  (a) fit t = c * (1 + O / bs): c {c:.4f}ms, O {overhead:.3f} (the tuner's "
          f"PAGED_BLOCK_OVERHEAD {PAGED_BLOCK_OVERHEAD})")
    return {"ms": ms, "overhead": overhead}


def serving_tuner_check(serve_run_dir: Path, device: str = "cuda", model: str = "0.5b",
                        tune_model=None) -> dict:
    """Phase 18 (b): ``tune --serve --devices 1`` calibrated from phase 10's
    serve run directory emits a serving config; ``serve bench --config``
    serves TUNE["requests"] requests of phase 4's traffic with it in this
    process, counters reset just before and read just after: K1 and K2
    launched, no plain version. The config's block size, token budget,
    slots and pool are the bench's defaults; the pool and the longest
    context are given explicitly, at what the traffic's longest request
    needs in every slot (the tuner sizes a pool from the token budget and
    knows no traffic). Prints the chosen point, the calibrated prediction
    of its tick beside the measured mean ``serve.mixed`` tick, and the
    calibration factor."""
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.serve.bench import main as bench_main
    from scaling_tpu_torch.tune.cli import main as tune_main

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tuner_"))
    try:
        emitted, report = root / "serving.json", root / "tune.json"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tune_main(["--serve", "--devices", "1", "--model", tune_model or model,
                            "--serve-calibrate-from", str(serve_run_dir),
                            "--emit-config", str(emitted), "--json", str(report)])
        for line in out.getvalue().splitlines()[:6]:
            print(f"  (b) tune | {line}")
        payload, cfg = json.loads(report.read_text()), json.loads(emitted.read_text())
        cal = payload["serve_calibration"]
        if rc != 0 or cal is None:
            raise AssertionError(f"(b) tune --serve exited {rc}, calibration {cal}")
        best = payload["ranked"][0]
        longest = WORKLOAD["prompt_len"][1] + WORKLOAD["output_len"][1]
        per_seq = -(-longest // cfg["block_size"])
        run, stats_file = root / "run", root / "stats.json"
        args = ["--model", model, "--device", device, "--seed", str(WORKLOAD["seed"]),
                "--requests", str(TUNE["requests"]), "--rate", str(WORKLOAD["rate"]),
                "--prompt-len", *map(str, WORKLOAD["prompt_len"]),
                "--output-len", *map(str, WORKLOAD["output_len"]),
                "--prefill-chunk", str(SERVE["prefill_chunk"]), "--config", str(emitted),
                "--max-blocks-per-seq", str(per_seq),
                "--num-blocks", str(cfg["num_slots"] * per_seq + 1),
                "--run-dir", str(run), "--json", str(stats_file)]
        launches.reset()
        rc = bench_main(args)
        if device == "cuda":
            torch.cuda.synchronize()
        kernel, plain = dict(launches.KERNEL), dict(launches.PLAIN)
        stats = json.loads(stats_file.read_text())
        engine = stats["engine"]
        if rc != 0 or stats["completed"] != TUNE["requests"]:
            raise AssertionError(f"(b) serve bench --config: rc {rc}, stats {stats}")
        if any(engine[k] != cfg[k] for k in ("block_size", "token_budget", "num_slots")):
            raise AssertionError(f"(b) the bench ran {engine}, not the emitted {cfg}")
        if device == "cuda" and (kernel.get("paged_attention", 0) <= 0
                                 or kernel.get("rms_norm", 0) <= 0 or sum(plain.values())):
            raise AssertionError(f"(b) launches kernel={kernel} plain={plain}")
        measured, ticks = mean_tick_s(run)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  (b) chosen {best['label']} (config {cfg}); served {stats['completed']} requests: "
          f"{stats['tokens_per_s']:.1f} tokens/s, {stats['preemptions']} preemptions, launches "
          f"kernel={kernel} plain={plain}")
    print(f"  (b) tick: predicted {best['tick_s'] * 1e3:.3f}ms (analytic "
          f"{best['tick_s'] / cal['factor'] * 1e3:.3f}ms x calibration factor "
          f"{cal['factor']:.3f} from {cal['ticks']} ticks of phase 10's run), measured mean "
          f"{measured * 1e3:.3f}ms over {ticks} serve.mixed ticks")
    return {"launches": kernel, "predicted_tick_s": best["tick_s"], "measured_tick_s": measured,
            "factor": cal["factor"], "label": best["label"]}


def training_tuner(args: list) -> dict:
    """``python -m scaling_tpu_torch.tune`` in this process: its ``--json``
    payload."""
    from scaling_tpu_torch.tune.cli import main as tune_main

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        report = Path(tmp) / "tune.json"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tune_main([*args, "--json", str(report)])
        if rc != 0:
            raise AssertionError(f"tune {args} exited {rc}:\n{out.getvalue()}")
        return json.loads(report.read_text())


def observed_run_prediction(mfu: float) -> dict:
    """Phase 18 (c), first half, before phase 10: the training tuner's
    prediction for phase 10's observed run (phase 8's model: the 0.5B
    widths at TRAINER's depth, micro-batch 4, one micro-batch a step),
    calibrated from phase 5's MFU; phase 10 runs with it exported, so its
    ``obs report`` prints the calibration error."""
    from scaling_tpu_torch.train.bench import MODELS

    arch = dict(MODELS[TRAINER["model"]], num_layers=trainer_arch()["num_layers"])
    spec = ",".join(str(arch[k]) for k in ("hidden_size", "num_layers", "num_attention_heads",
                                           "attention_num_kv_heads"))
    spec += f",{TRAINER['seq']},{arch['vocab_size']},{arch['mlp_factor']}"
    payload = training_tuner(["--devices", "1", "--model", spec, "--global-batch",
                              str(TRAIN_MBS), "--mbs", str(TRAIN_MBS), "--mfu", str(mfu)])
    print(f"  (c) the tuner's prediction for phase 10's run ({spec}, mbs {TRAIN_MBS}): "
          f"{payload['prediction']['predicted_step_s'] * 1e3:.2f}ms a step at efficiency "
          f"{mfu:.4f} (phase 5's MFU)")
    return payload["prediction"]


def ladder_vs_tuner(mfu: float, ladder: dict) -> dict:
    """Phase 18 (c), second half, after phase 17: the training tuner over
    the micro-batch ladder at the 0.5B (one device, global batch 64),
    calibrated from phase 5's MFU; each rung's predicted memory and tokens/s
    beside phase 17's measured rung, and the tuner's pick beside the
    ladder's winner. Printed facts, not gates."""
    payload = training_tuner(["--devices", "1", "--model", TOOLING["model"], "--mbs-ladder",
                              TUNE["ladder"], "--mfu", str(mfu)])
    measured = {r["mbs"]: r for r in ladder.get("rungs", [])}
    for row in payload["ranked"]:
        mbs = row["layout"]["micro_batch_size"]
        m = measured.get(mbs)
        seen = ("not measured (the climb stopped before it)" if m is None else
                "out of memory" if m["oom"] else
                f"{m['tokens_per_s']:.1f} tokens/s, peak {m['peak_gb']} GB")
        print(f"  (c) mbs {mbs}: predicted {row['predicted_step_s']:.4f}s a step of "
              f"{row['layout']['global_batch_size']} sequences ({row['tokens_per_s']:.1f} "
              f"tokens/s), {row['memory_gb_per_device']:.2f} GB; phase 17 measured {seen}")
    pick = payload["ranked"][0]["layout"]["micro_batch_size"]
    print(f"  (c) the tuner's pick mbs {pick} (ties broken by label), the ladder's winner mbs "
          f"{ladder.get('winner')}")
    return {"pick": pick, "winner": ladder.get("winner")}


def audit_train_step_check(device: str = "cuda", model: str = "0.5b") -> dict:
    """Phase 18 (d): phase 5's step (the 0.5B, micro-batch 4, seq 2048)
    under the dispatch audit after one warm step: per step K2 and K3 2L+1,
    K4 and K5 L launches and no plain version (the CPU: as many plain
    runs). Prints its host syncs, device-to-host copies, aten ops, matmuls
    and bf16->f32 upcasts feeding them."""
    from scaling_tpu_torch.analysis.dispatch_audit import audit_train_step
    from scaling_tpu_torch.models.transformer import loss_function
    from scaling_tpu_torch.train.bench import build, synth_batch

    dev = torch.device(device)
    config, module, optimizer = build(model, TRAIN_SEQ, TRAIN_MBS, device=dev, seed=0)
    layers = config.transformer_architecture.num_layers
    step = module.build_train_step(optimizer, loss_function)
    batch = synth_batch(np.random.default_rng(0), TRAIN_MBS, TRAIN_SEQ,
                        config.transformer_architecture.vocab_size, 1, dev)
    step(batch)
    report = audit_train_step(step, batch)
    want = {"rms_norm": 2 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
            "flash_attention_fwd": layers, "flash_attention_bwd": layers}
    got = report["launches"]["plain" if device == "cpu" else "kernel"]
    if got != want or (device == "cuda" and report["launches"]["plain"]):
        raise AssertionError(f"(d) the step's launches {report['launches']}, want {want}")
    print(f"  (d) phase 5's step ({layers} layers): launches {report['launches']}; host syncs "
          f"{report['host_syncs']}, device->host copies {report['device_to_host_copies']}, "
          f"{report['op_count']} aten ops, {report['matmul_ops']} matmuls, "
          f"{report['bf16_to_f32_matmul_upcasts']} fed by a bf16->f32 upcast, rng ops "
          f"{report['rng_ops']}")
    del module, optimizer, step, batch
    if device == "cuda":
        torch.cuda.empty_cache()
    return report


def audit_tick(engine, vocab: int, device: str = "cuda") -> dict:
    """Phase 18 (d), on phase 4's engine after its run: 16 requests of
    phase 4's traffic submitted at once, RECOMPUTE_TICK ticks, then one
    tick under the dispatch audit (prefill-chunk and decode rows): K1 and
    K2 launched, no plain version (the CPU: plain runs)."""
    from scaling_tpu_torch.analysis.dispatch_audit import audit_engine_tick

    for _, prompt, olen in phase4_workload(vocab)[:16]:
        engine.submit(prompt, olen)
    for _ in range(RECOMPUTE_TICK):
        engine.tick()
    report = audit_engine_tick(engine)
    got = report["launches"]["plain" if device == "cpu" else "kernel"]
    if got.get("paged_attention", 0) <= 0 or got.get("rms_norm", 0) <= 0 or (
            device == "cuda" and report["launches"]["plain"]):
        raise AssertionError(f"(d) the audited tick's launches {report['launches']}")
    engine.run_until_done()
    return report


def tuner_phase(serve_run_dir: Path, mfu: float, ladder: dict, phase4: dict,
                device: str = "cuda") -> dict:
    """Phase 18: (a)-(d) of TUNE. Returns the launch counters of (b)'s
    serving through the emitted config."""
    t0 = time.monotonic()
    k1_block_sizes(device)
    served = serving_tuner_check(serve_run_dir, device)
    ladder_vs_tuner(mfu, ladder)
    audit_train_step_check(device)
    tick = phase4["tick_audit"]
    print(f"  (d) a steady tick of phase 4's engine: launches {tick['launches']}; host syncs "
          f"{tick['host_syncs']}, device->host copies {tick['device_to_host_copies']}, "
          f"{tick['op_count']} aten ops")
    print(f"  (d) distinct forward shapes over phase 4's traffic: {len(phase4['forward_shapes'])} "
          f"{phase4['forward_shapes']} (the CUDA graphs the tick would need)")
    print(f"  phase 18 took {time.monotonic() - t0:.1f}s")
    return {"tuner_serve_config": served["launches"]}


# ------------------------------------------- phase 19: data and tensor parallelism
DIST_KERNELS = ("rms_norm", "rms_norm_bwd", "flash_attention_fwd", "flash_attention_bwd")


def dist_probe_row(arch) -> torch.Tensor:
    """Phase 19's probe row: ``probe_tokens`` ids (at most the model's
    sequence) from seed 19, (1, n)."""
    gen = torch.Generator().manual_seed(19)
    n = min(DIST["probe_tokens"], arch.sequence_length)
    return torch.randint(1, arch.vocab_size, (1, n), generator=gen, dtype=torch.int32)


def dist_worker() -> int:
    """A worker of phase 19, which ``runner_main`` launches as ``python -m
    chip_smoke --payload=...``: the port's ``worker_main`` on its slot's
    card, with one JSON line a step appended to ``<log_dir>/rank{r}.jsonl``
    (the global loss, the launch counters, ``max_memory_allocated``, the
    collectives' byte counters, the time) and a pause of ``pause_s``; at its
    start its pid, backend and device; at its end the iterations, this
    rank's parameter and optimizer bytes, and rank 0's logits of the probe
    row at the final weights (``probe_logits.npy``), the forward run by
    every rank of the layout (over pipe stages the last stage's first data
    and model rank writes them). A step's record also carries the global
    gradient norm and ``moment_sq``: the squared norm of the Adam first
    moments of the pieces this rank counts in the global norm, by logical
    layer (``moment_sq_by_layer``). ``CHIP_SMOKE_WORKER_DEVICE`` names
    another device than the slot's card (the CPU tests). Under ZeRO-3
    (phase 22) every rank also runs the probe row's forward at each save and
    rank 0 writes its logits (``probe_logits_step<N>.npy``): the weights the
    checkpoint holds."""
    from scaling_tpu_torch.logging.logger import append_jsonl_line
    from scaling_tpu_torch.models.transformer import train
    from scaling_tpu_torch.ops import launches
    from scaling_tpu_torch.parallel import collectives
    from scaling_tpu_torch.runner import LaunchConfig

    launch = LaunchConfig.from_launcher_args()
    log_dir = Path(launch.payload["logger"]["log_dir"])
    log_dir.mkdir(parents=True, exist_ok=True)
    records = log_dir / f"rank{launch.global_rank}.jsonl"
    build = train.build_trainer
    device = os.environ.get("CHIP_SMOKE_WORKER_DEVICE")

    def max_allocated(dev: torch.device) -> int:
        return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    def build_with_records(config, device=None, glue=None):
        trainer = build(config, device, glue=glue)
        lay = trainer.layout
        append_jsonl_line(records, json.dumps({
            "kind": "start", "pid": os.getpid(), "rank": launch.global_rank, "t": time.time(),
            "device": str(trainer.device), "describe": None if lay is None else lay.describe(),
            "local_world_size": int(os.environ.get("LOCAL_WORLD_SIZE", "1"))}))

        def record(metrics, step):
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)
            append_jsonl_line(records, json.dumps({
                "kind": "step", "step": step, "loss": metrics["loss"], "t": time.time(),
                "kernel": dict(launches.KERNEL), "plain": dict(launches.PLAIN),
                "max_allocated": max_allocated(trainer.device),
                "stats": dict(collectives.STATS),
                "grad_norm": metrics.get("global_grad_norm"),
                "moment_sq": moment_sq_by_layer(trainer.optimizer)}))
            time.sleep(PIPE["pause_s"] if lay is not None and lay.pipe_parallel_size > 1
                       else DIST["pause_s"])

        trainer.metrics_hooks.append(record)
        if config.optimizer.shards_parameters:
            trainer.checkpoint_hooks.append(lambda step_dir, step: probe(trainer, step))
        return trainer

    def probe(trainer, step=None):
        """Every rank's forward of the probe row; rank 0 (of the last stage)
        writes its logits."""
        row = dist_probe_row(trainer.module.model.architecture).to(trainer.device)
        trainer.module.model.eval()
        with torch.no_grad():
            out = trainer.module.forward({"token_ids": row})  # a pipe runs it stagewise
        trainer.module.model.train()
        lay = trainer.layout
        if out is not None and (lay is None or lay.data_parallel_rank == lay.model_parallel_rank
                                == lay.context_parallel_rank == 0):
            name = "probe_logits.npy" if step is None else f"probe_logits_step{step}.npy"
            np.save(log_dir / name, out["activations"][0].float().cpu().numpy())

    train.build_trainer = build_with_records
    trainer = train.worker_main(device=device)
    probe(trainer)
    opt = trainer.optimizer.state
    append_jsonl_line(records, json.dumps({
        "kind": "end", "iterations": trainer.context.iterations,
        "preempted": trainer._preempted,
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in trainer.module.model.parameters()),
        "optimizer_bytes": sum(t.numel() * t.element_size() for field in (
            opt.master, opt.exp_avg, opt.exp_avg_sq) for t in field.values()),
        "max_allocated": max_allocated(trainer.device),
        "kernel": dict(launches.KERNEL), "plain": dict(launches.PLAIN)}))
    return 0


def moment_sq_by_layer(optimizer) -> dict:
    """The squared norm of the Adam first moments of the pieces this rank
    counts in the global norm (each piece on one rank), by logical layer
    (``layer_0`` the embedding, the edges after the layers by name)."""
    sums: dict = {}
    for name, owned in zip(optimizer.optimized, optimizer._owned):
        if owned:
            key = name.split(".")[1] if name.startswith("layers.") else name
            sq = optimizer.state.exp_avg[name].float().square().sum()
            sums[key] = sums[key] + sq if key in sums else sq
    values = torch.stack(list(sums.values())).tolist() if sums else []
    return dict(zip(sums, values))


def free_port() -> int:
    """A TCP port of this host that nothing listens on now (each launch's
    rendezvous takes its own, so two checkouts on one host never meet)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_config(prefixes: dict, root: Path, name: str, dp: int, mp: int, steps: int,
                load_dir=None, save: bool = True) -> dict:
    """Phase 8's config at dp x mp (ZeRO-1 when dp > 1, micro-batch
    ``TRAINER["mbs"] / dp`` a data rank: phase 8's global batch), saving
    every ``save_interval`` steps (``save``), no evaluation, under ``runner_main``
    with one slot a rank and this script as the workers' module."""
    config = trainer_config(dict(prefixes, valid=None), root / name / "logs",
                            save_dir=root / name / "ckpt" if save else None, load_dir=load_dir)
    del config["data"]["validation_data_prefixes"]  # phase 8's kept prefixes: a and b
    config["topology"] = {"model_parallel_size": mp, "pipe_parallel_size": 1,
                          "data_parallel_size": dp,
                          "micro_batch_size": TRAINER["mbs"] // dp,
                          "gradient_accumulation_steps": 1}
    config["optimizer"] = dict(config["optimizer"], zero=dp > 1)
    config["trainer"].update(train_iterations=steps, save_interval=DIST["save_interval"],
                             eval_interval=None)
    config["runner"] = {"default_gpu_count": dp * mp, "script": DIST["script"],
                        "master_port": free_port()}
    return config


def dist_records(log_dir: Path, world: int) -> list:
    """Each rank's records, by rank: ``{"start", "steps": {step: rec}, "end"}``."""
    out = []
    for r in range(world):
        path = log_dir / f"rank{r}.jsonl"
        recs = [json.loads(line) for line in path.read_text().splitlines()] \
            if path.is_file() else []
        out.append({"start": next((x for x in recs if x["kind"] == "start"), None),
                    "steps": {x["step"]: x for x in recs if x["kind"] == "step"},
                    "end": next((x for x in recs if x["kind"] == "end"), None)})
    return out


def start_runner(config: dict) -> tuple:
    """``runner_main`` over ``config`` on a thread of this process (it only
    spawns and watches the workers); returns (thread, result dict)."""
    from scaling_tpu_torch.models.transformer import TransformerConfig
    from scaling_tpu_torch.runner import runner_main

    result = {}

    def run():
        try:
            result["rc"] = runner_main(TransformerConfig.from_dict(config).runner, config)
        except BaseException as e:  # re-raised by the caller after the join
            result["error"] = e

    thread = threading.Thread(target=run, name="phase19-runner", daemon=True)
    thread.start()
    return thread, result


def join_runner(thread: threading.Thread, result: dict, what: str, log_dir: Path) -> None:
    thread.join(timeout=DIST["timeout_s"])
    if thread.is_alive():
        raise AssertionError(f"{what}: the runner did not end within {DIST['timeout_s']}s")
    if "error" in result:
        raise result["error"]
    if result.get("rc") != 0:
        logs = sorted(log_dir.glob("*.log"))
        tail = logs[0].read_text()[-3000:] if logs else ""
        raise AssertionError(f"{what}: runner_main exited {result.get('rc')}\n{tail}")


def dist_cpu_logits(step_dir: Path, config: dict) -> torch.Tensor:
    """The probe row's logits in f32 on the CPU (the plain versions) from
    the merged checkpoint ``step_dir``, loaded by one rank."""
    from scaling_tpu_torch.checkpoint import load_model_checkpoint
    from scaling_tpu_torch.models.transformer import TransformerConfig, TransformerModel
    from scaling_tpu_torch.parallel import ParallelModule

    cfg = TransformerConfig.from_dict(dict(config, topology={
        "micro_batch_size": 1, "gradient_accumulation_steps": 1}))
    arch32 = dataclasses.replace(cfg.transformer_architecture, precision="float32")
    module = ParallelModule(TransformerModel(arch32, device="cpu"), cfg.topology)
    params = dict(module.model.named_parameters())
    load_model_checkpoint(step_dir, {key: params[name]
                                     for name, key in module.ckpt_keys().items()})
    module.model.eval()
    with torch.no_grad():
        return module.forward({"token_ids": dist_probe_row(arch32)})["activations"][0]


def check_dist_launches(what: str, steps: dict, plain: dict, want: dict) -> dict:
    """A rank's launches in step 2 (step 2's counters less step 1's) equal
    ``want`` for K2-K5, and no plain version ran; returns the step's."""
    got = {k: steps[2]["kernel"].get(k, 0) - steps[1]["kernel"].get(k, 0) for k in DIST_KERNELS}
    if want is not None and got != want:
        raise AssertionError(f"{what}: launches in step 2 {got}, the one-rank run's {want}")
    if any(v <= 0 for v in got.values()):
        raise AssertionError(f"{what}: a kernel was not launched in step 2: {got}")
    if sum(plain.values()) != 0:
        raise AssertionError(f"{what}: plain versions ran on the card: {plain}")
    return got


def dist_phase(base: dict, device: str = "cuda", share=None) -> dict:
    """Phase 19: see the module docstring (19). Returns the launches of the
    four ranks' run, summed over the ranks, by path. ``share`` (a
    ``Future``) gets the one-rank run's records (with phase 19's rank 0's
    ``max_memory_allocated`` as ``zero1_max_allocated``) once every process
    of the phase has ended (phases 21 and 22 hold their layouts to them, and
    21 starts then), or the error that ended the phase first."""
    try:
        return _dist_phase(base, device, share)
    except BaseException as e:
        if share is not None and not share.done():
            share.set_exception(e)
        raise


def _dist_phase(base: dict, device: str, share) -> dict:
    from scaling_tpu_torch.resilience import read_mesh_meta, verify_checkpoint

    dp, mp, world = DIST["dp"], DIST["mp"], DIST["dp"] * DIST["mp"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    t0 = time.monotonic()
    runners = []  # each runner's (thread, result), joined before the files go
    try:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()  # the card's memory to the workers
        prefixes = base["prefixes"]
        sharded_cfg = dist_config(prefixes, root, "sharded", dp, mp, DIST["steps"])
        one_cfg = dist_config(prefixes, root, "one", 1, 1, DIST["ref_steps"], save=False)
        sharded_logs, one_logs = root / "sharded" / "logs", root / "one" / "logs"
        sharded, one = start_runner(sharded_cfg), start_runner(one_cfg)
        runners += [sharded, one]
        # SIGTERM to rank 3 once its step-3 record is written
        deadline = time.monotonic() + DIST["timeout_s"]
        target = DIST["sigterm_rank"]
        while True:
            recs = dist_records(sharded_logs, world)[target]
            if DIST["sigterm_after"] in recs["steps"]:
                os.kill(recs["start"]["pid"], signal.SIGTERM)
                break
            if not sharded[0].is_alive() or time.monotonic() > deadline:
                join_runner(*sharded, "phase 19's four ranks", sharded_logs)
                raise AssertionError(f"phase 19: no step-{DIST['sigterm_after']} record of "
                                     f"rank {target}")
            time.sleep(0.02)
        # (d)'s one-rank child starts now, beside the four ranks' last step and
        # save: the step-2 checkpoint was durable before any rank's step 3
        ckpt = root / "sharded" / "ckpt"
        stop = DIST["stop_step"]
        resume_cfg = dist_config(prefixes, root, "resume", 1, 1, stop,
                                 load_dir=ckpt / "global_step2", save=False)
        resume = start_runner(resume_cfg)
        runners.append(resume)
        join_runner(*sharded, "phase 19's four ranks", sharded_logs)
        join_runner(*one, "phase 19's one-rank run", one_logs)
        ranks, ref = dist_records(sharded_logs, world), dist_records(one_logs, 1)[0]
        run_s = time.monotonic() - t0
        # (e) every rank stopped at the same step, with a checkpoint that verifies
        stops = [r["end"]["iterations"] if r["end"] else None for r in ranks]
        latest = (ckpt / "latest").read_text().strip()
        problems = verify_checkpoint(ckpt / f"global_step{stop}")
        print(f"  (e) SIGTERM to rank {target} after its step-{DIST['sigterm_after']} record: "
              f"exit 0 on every rank, stopped at steps {stops}, preempted "
              f"{[r['end']['preempted'] for r in ranks]}; latest {latest}, its verification "
              f"{problems or 'clean'}")
        if stops != [stop] * world or latest != f"global_step{stop}" or problems:
            raise AssertionError(f"phase 19 (e): ranks stopped at {stops}, latest {latest}, "
                                 f"{problems}")
        # (a) the losses of steps 1-2 against the one-rank run's
        losses = [ranks[0]["steps"][s]["loss"] for s in sorted(ranks[0]["steps"])]
        ref_losses = [ref["steps"][s]["loss"] for s in range(1, DIST["ref_steps"] + 1)]
        diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
        print(f"  (a) losses of the four ranks {losses}; the one-rank run's {ref_losses}; "
              f"|diff| {diffs} (tol {DIST['loss_tol']})")
        if not all(math.isfinite(x) for x in losses) or max(diffs) > DIST["loss_tol"]:
            raise AssertionError(f"phase 19 (a): losses {losses} vs {ref_losses}")
        # (c) each rank launches K2-K5 as often a step as the one-rank run, no plain
        want = check_dist_launches("phase 19 one rank", ref["steps"], ref["end"]["plain"], None)
        for r, rec in enumerate(ranks):
            check_dist_launches(f"phase 19 rank {r}", rec["steps"], rec["end"]["plain"], want)
        arch = sharded_cfg["transformer_architecture"]
        heads = arch["num_attention_heads"]
        print(f"  (c) launches in step 2 on each of the four ranks {want} (K4/K5 on "
              f"{heads // mp} query and {(arch.get('attention_num_kv_heads') or heads) // mp} "
              "kv heads), the one-rank run's the same; no plain version on any rank")
        # (b) the probe row's logits at the step-4 weights against the CPU's
        t_cpu = time.monotonic()
        card = torch.from_numpy(np.load(sharded_logs / "probe_logits.npy"))
        cpu = dist_cpu_logits(ckpt / f"global_step{stop}", sharded_cfg)
        scale = cpu.abs().max().item()
        err = (card - cpu).abs().max().item() / scale
        uniform = ((cpu.amax(-1) - cpu.amin(-1)) / 2).max().item() / scale
        print(f"  (b) probe row ({DIST['probe_tokens']} tokens) at the step-{stop} weights, the "
              f"four ranks' forward vs the f32 CPU forward of the merged checkpoint: "
              f"max_abs_err={err * scale:.4e} max|logit|={scale:.4e} err/max|logit|={err:.3e} "
              f"(tol {DIST['logit_tol']}; constant logits would give >= {uniform:.3e}) "
              f"({time.monotonic() - t_cpu:.1f}s)")
        if not uniform > DIST["logit_tol"] or not err <= DIST["logit_tol"]:
            raise AssertionError(f"phase 19 (b): err {err}, constant logits {uniform}")
        # (d) a one-rank child resumes the step-2 checkpoint to step 4
        mesh = read_mesh_meta(ckpt / "global_step2")
        join_runner(*resume, "phase 19's one-rank resume", root / "resume" / "logs")
        if share is not None:  # every process of phase 19 has ended: phase 21 may start
            share.set_result(dict(ref, zero1_max_allocated=ranks[0]["end"]["max_allocated"]))
        resumed = dist_records(root / "resume" / "logs", 1)[0]
        got = [resumed["steps"][s]["loss"] for s in range(3, stop + 1)]
        want_l = [ranks[0]["steps"][s]["loss"] for s in range(3, stop + 1)]
        rdiff = [abs(a - b) for a, b in zip(got, want_l)]
        topo = mesh["topology"]
        print(f"  (d) MESH.json of step 2: dp {topo['data_parallel_size']} x mp "
              f"{topo['model_parallel_size']}, zero_stage {mesh['optimizer']['zero_stage']}; a "
              f"one-rank child resumed it: steps 3-{stop} losses {got}, the four ranks' "
              f"{want_l}, |diff| {rdiff} (tol {DIST['loss_tol']})")
        if (topo["data_parallel_size"], topo["model_parallel_size"]) != (dp, mp) or \
                max(rdiff) > DIST["loss_tol"]:
            raise AssertionError(f"phase 19 (d): {topo}, {got} vs {want_l}")
        # memory, layout, collective bytes, step time
        start = ranks[0]["start"]
        describe = start["describe"]
        print(f"  backend {describe['backend']}, {start['local_world_size']} ranks on "
              f"{torch.cuda.device_count()} device(s) ({start['device']} each); bytes staged "
              f"through the host a step: 0 (every collective runs on the CUDA tensors)")
        n_params = ref["end"]["param_bytes"] // 2  # bf16
        for r, rec in enumerate(ranks):
            end = rec["end"]
            print(f"  rank {r}: max_memory_allocated {end['max_allocated'] / 1e9:.3f} GB "
                  f"(the one-rank run's {ref['end']['max_allocated'] / 1e9:.3f} GB); parameters "
                  f"{end['param_bytes'] / 1e9:.4f} GB (expected {2 * n_params / mp / 1e9:.4f}: "
                  f"/mp), optimizer state {end['optimizer_bytes'] / 1e9:.4f} GB (expected "
                  f"{12 * n_params / (mp * dp) / 1e9:.4f}: /(mp*dp))")
        stats = [rec["steps"] for rec in ranks]
        per_step = {k: stats[0][3]["stats"].get(k, 0) - stats[0][2]["stats"].get(k, 0)
                    for k in stats[0][3]["stats"]}
        print(f"  rank 0's collectives in step 3: "
              + ", ".join(f"{k} {v}" for k, v in sorted(per_step.items())))
        # steps 3 and 4 (step 2's record comes after its save; each after a pause)
        times = [stats[0][s]["t"] - stats[0][s - 1]["t"] - DIST["pause_s"] for s in (3, 4)]
        ref_t = ref["steps"][2]["t"] - ref["steps"][1]["t"] - DIST["pause_s"]
        print(f"  step time with four ranks sharing one card, in the script with phase 20's "
              f"beside them (not a scaling figure), steps "
              f"3-4: {[round(t * 1e3, 1) for t in times]} ms (step 4 beside the one-rank "
              f"resume child's start); the one-rank run's step 2 "
              f"{ref_t * 1e3:.1f} ms (host clock between step records, less the pause; run "
              f"wall {run_s:.1f}s)")
        total: dict = {}
        for rec in ranks:
            for k, v in rec["end"]["kernel"].items():
                total[k] = total.get(k, 0) + v
        return {"dist_4ranks": total}
    finally:
        for thread, _ in runners:  # after a failed check: the runners end on their own
            thread.join(timeout=DIST["timeout_s"])
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------- phase 20: pipelining
def pipe_config(prefixes: dict, root: Path, name: str, pp: int, vpp: int, dp: int, mbs: int,
                steps: int, load_dir=None, save: bool = True) -> dict:
    """Phase 8's config at the 0.5B widths cut to ``PIPE["layers"]`` layers,
    at pp x vpp x dp (ZeRO-1 when dp > 1) with ``PIPE["remat"]`` and
    accumulation ``PIPE["gas"]``, saving every ``save_interval`` steps, no
    evaluation, under ``runner_main`` with one slot a rank; the events file
    beside the logs (``obs report``'s pipeline section)."""
    config = dist_config(prefixes, root, name, dp, 1, steps, load_dir=load_dir, save=save)
    config["transformer_architecture"] = dict(config["transformer_architecture"],
                                              num_layers=PIPE["layers"])
    config["topology"] = {"model_parallel_size": 1, "pipe_parallel_size": pp,
                          "pipe_virtual_size": vpp, "data_parallel_size": dp,
                          "micro_batch_size": mbs, "gradient_accumulation_steps": PIPE["gas"],
                          "activation_checkpointing_type": PIPE["remat"]}
    config["trainer"]["save_interval"] = PIPE["save_interval"]
    config["logger"] = dict(config["logger"], events_path=str(root / name / "events.jsonl"))
    config["runner"]["default_gpu_count"] = pp * dp
    return config


def stage_launches(recs: list, step: int) -> dict:
    """K2-K5 launched in ``step`` (its counters less the step before's),
    summed over ``recs``' ranks."""
    return {k: sum(r["steps"][step]["kernel"].get(k, 0) - r["steps"][step - 1]["kernel"].get(k, 0)
                   for r in recs) for k in DIST_KERNELS}


def transport_per_step(pp: int, vpp: int, gas: int, stage: int, act_bytes: int) -> int:
    """The bytes a step's schedule sends from ``stage``."""
    from scaling_tpu_torch.parallel.pipeline_schedule import executor_schedule

    sends = sum(i.name in ("send_activation", "send_grad")
                for i in executor_schedule(pp, stage, gas, vpp).instructions())
    return sends * act_bytes


def pipe_phase(base: dict, device: str = "cuda", say=print, say_slices=None) -> dict:
    """Phase 20: see the module docstring (20). Returns the launches of the
    four ranks' run, summed over the ranks, by path. ``say`` takes its
    lines (``main`` runs it beside phase 19 and prints them after). With
    ``say_slices`` it also runs phase 21 (c) beside the child, which it is
    held to, and gives that check's lines to ``say_slices``."""
    from scaling_tpu_torch.resilience import read_mesh_meta, verify_checkpoint

    pp, vpp, dp = PIPE["pp"], PIPE["vpp"], PIPE["dp"]
    world, stop = pp * dp, PIPE["stop_step"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_pipe_"))
    t0 = time.monotonic()
    runners = []
    try:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()  # the card's memory to the workers
        prefixes = base["prefixes"]
        piped_cfg = pipe_config(prefixes, root, "piped", pp, vpp, dp, PIPE["mbs"], PIPE["steps"])
        logs = root / "piped" / "logs"
        piped = start_runner(piped_cfg)
        runners.append(piped)
        deadline = time.monotonic() + PIPE["timeout_s"]
        target = PIPE["sigterm_rank"]
        ckpt = root / "piped" / "ckpt"
        child_cfg = pipe_config(prefixes, root, "child", 1, 1, 1, PIPE["mbs"] * dp, stop,
                                load_dir=ckpt / "global_step2", save=False)
        child = sliced = None
        sliced_cfg = None
        if say_slices is not None:  # phase 21 (c): the child's config at pp 2 x S 2
            sliced_cfg = pipe_config(prefixes, root, "sliced", 2, 1, 1, PIPE["mbs"] * dp, stop,
                                     load_dir=ckpt / "global_step2", save=False)
            sliced_cfg["topology"]["pipe_token_slices"] = SPLIT["ts"]
        while True:
            if child is None and (ckpt / "latest").is_file() and \
                    (ckpt / "latest").read_text().strip() == "global_step2":
                # the step-2 checkpoint is durable: the child starts beside the ranks
                child = start_runner(child_cfg)
                runners.append(child)
                if sliced_cfg is not None:
                    sliced = start_runner(sliced_cfg)
                    runners.append(sliced)
            recs = dist_records(logs, world)[target]
            if child is not None and PIPE["sigterm_after"] in recs["steps"]:
                os.kill(recs["start"]["pid"], signal.SIGTERM)
                break
            if not piped[0].is_alive() or time.monotonic() > deadline:
                join_runner(*piped, "phase 20's four ranks", logs)
                raise AssertionError(f"phase 20: no step-{PIPE['sigterm_after']} record of "
                                     f"rank {target}, or no durable step-2 checkpoint")
            time.sleep(0.02)
        join_runner(*piped, "phase 20's four ranks", logs)
        ranks = dist_records(logs, world)
        run_s = time.monotonic() - t0
        # (d) every rank stopped at the same step, with a checkpoint that verifies
        stops = [r["end"]["iterations"] if r["end"] else None for r in ranks]
        latest = (ckpt / "latest").read_text().strip()
        problems = verify_checkpoint(ckpt / f"global_step{stop}")
        mesh = read_mesh_meta(ckpt / "global_step2")["topology"]
        say(f"  (d) SIGTERM to rank {target} after its step-{PIPE['sigterm_after']} record: "
              f"exit 0 on every rank, stopped at steps {stops}, preempted "
              f"{[r['end']['preempted'] for r in ranks]}; latest {latest}, its verification "
              f"{problems or 'clean'}; MESH.json of step 2: pp {mesh['pipe_parallel_size']} x "
              f"vpp {mesh['pipe_virtual_size']} x dp {mesh['data_parallel_size']}")
        if stops != [stop] * world or latest != f"global_step{stop}" or problems or (
                mesh["pipe_parallel_size"], mesh["pipe_virtual_size"]) != (pp, vpp):
            raise AssertionError(f"phase 20 (d): ranks stopped at {stops}, latest {latest}, "
                                 f"{problems}, {mesh}")
        # (b) the probe row's logits at the step-4 weights against the CPU's
        t_cpu = time.monotonic()
        card = torch.from_numpy(np.load(logs / "probe_logits.npy"))
        cpu = dist_cpu_logits(ckpt / f"global_step{stop}", piped_cfg)
        scale = cpu.abs().max().item()
        err = (card - cpu).abs().max().item() / scale
        uniform = ((cpu.amax(-1) - cpu.amin(-1)) / 2).max().item() / scale
        say(f"  (b) probe row ({DIST['probe_tokens']} tokens) at the step-{stop} weights, the "
              f"four ranks' forward vs the f32 CPU forward of the merged checkpoint: "
              f"max_abs_err={err * scale:.4e} max|logit|={scale:.4e} err/max|logit|={err:.3e} "
              f"(tol {DIST['logit_tol']}; constant logits would give >= {uniform:.3e}) "
              f"({time.monotonic() - t_cpu:.1f}s)")
        if not uniform > DIST["logit_tol"] or not err <= DIST["logit_tol"]:
            raise AssertionError(f"phase 20 (b): err {err}, constant logits {uniform}")
        # (a) the child's losses of steps 3-4 against the four ranks'
        join_runner(*child, "phase 20's one-rank child", root / "child" / "logs")
        one = dist_records(root / "child" / "logs", 1)[0]
        got = [one["steps"][s]["loss"] for s in range(3, stop + 1)]
        want = [ranks[0]["steps"][s]["loss"] for s in range(3, stop + 1)]
        diffs = [abs(a - b) for a, b in zip(got, want)]
        say(f"  (a) a one-rank child resumed the step-2 checkpoint: steps 3-{stop} losses "
              f"{got}; the four ranks' {want}; |diff| {diffs} (tol {DIST['loss_tol']})")
        if not all(math.isfinite(x) for x in got + want) or max(diffs) > DIST["loss_tol"]:
            raise AssertionError(f"phase 20 (a): losses {got} vs {want}")
        # (a) the pipelined backward of steps 3-4 against the child's from the same weights
        steps = range(3, stop + 1)
        worst = {}
        for s in steps:
            norms = one["steps"][s]["grad_norm"], ranks[0]["steps"][s]["grad_norm"]
            worst[f"grad norm, step {s}"] = abs(norms[1] - norms[0]) / norms[0]
            child_m = one["steps"][s]["moment_sq"]
            for k, v in child_m.items():
                piped = sum(r["steps"][s]["moment_sq"].get(k, 0.0) for r in ranks)
                worst[f"{k} first moment, step {s}"] = abs(
                    math.sqrt(piped) - math.sqrt(v)) / math.sqrt(v)
        far = max(worst, key=worst.get)
        say(f"  (a) the pipelined backward of steps 3-{stop} against the child's from the same "
            f"weights: global gradient norms {[ranks[0]['steps'][s]['grad_norm'] for s in steps]}, "
            f"the child's {[one['steps'][s]['grad_norm'] for s in steps]}; the largest relative "
            f"difference over them and {len(child_m)} layers' Adam first moments "
            f"{worst[far]:.3e} ({far}; tol {PIPE['update_rtol']})")
        if not all(math.isfinite(v) for v in worst.values()) or worst[far] > PIPE["update_rtol"]:
            raise AssertionError(f"phase 20 (a): {far} differs by {worst[far]} from the child's")
        # (c) K2-K5 a step over the two stages of each data rank, the child's
        child_launches = stage_launches([one], stop)
        for d in range(dp):
            stages = [ranks[p * dp + d] for p in range(pp)]
            got_l = stage_launches(stages, 2)
            if got_l != child_launches or any(v <= 0 for v in got_l.values()):
                raise AssertionError(f"phase 20 (c): data rank {d}'s stages launched {got_l} in "
                                     f"step 2, the one-rank child {child_launches} in step {stop}")
        plain = {r: rec["end"]["plain"] for r, rec in enumerate(ranks + [one])}
        if any(sum(v.values()) for v in plain.values()):
            raise AssertionError(f"phase 20 (c): plain versions ran on the card: {plain}")
        by_rank = [stage_launches([r], 2) for r in ranks]
        say(f"  (c) launches in step 2 over the two stages of each data rank "
              f"{child_launches}, the one-rank child's in step {stop} the same (K4 twice a layer "
              f"under every_pipe_stage); by rank {by_rank}; no plain version on any rank")
        # (e) memory and parameters beside the child's
        for r, rec in enumerate(ranks):
            end = rec["end"]
            say(f"  (e) rank {r} (stage {r // dp}, data rank {r % dp}): max_memory_allocated "
                  f"{end['max_allocated'] / 1e9:.3f} GB (the child's "
                  f"{one['end']['max_allocated'] / 1e9:.3f} GB); parameters "
                  f"{end['param_bytes'] / 1e9:.4f} GB (the child's "
                  f"{one['end']['param_bytes'] / 1e9:.4f}), optimizer state "
                  f"{end['optimizer_bytes'] / 1e9:.4f} GB (the child's "
                  f"{one['end']['optimizer_bytes'] / 1e9:.4f})")
        # the transport's bytes and waits, the predicted bubble, the step times
        arch = piped_cfg["transformer_architecture"]
        act = PIPE["mbs"] * arch["sequence_length"] * arch["hidden_size"] * 2  # bf16
        for r, rec in enumerate(ranks):
            st = {k: rec["steps"][3]["stats"].get(k, 0) - rec["steps"][2]["stats"].get(k, 0)
                  for k in rec["steps"][3]["stats"]}
            want_b = transport_per_step(pp, vpp, PIPE["gas"], r // dp, act)
            step_s = rec["steps"][3]["t"] - rec["steps"][2]["t"] - PIPE["pause_s"]
            wait_s = st.get("p2p_recv_wait_ns", 0) / 1e9
            say(f"  rank {r}: step 3 sends {st.get('p2p_send_bytes', 0)} bytes by the "
                  f"transport (the schedule's count {want_b}), receives "
                  f"{st.get('p2p_recv_bytes', 0)}; all-reduce {st.get('all_reduce_bytes', 0)}, "
                  f"all-gather {st.get('all_gather_bytes', 0)}, broadcast "
                  f"{st.get('broadcast_bytes', 0)} bytes; step {step_s * 1e3:.1f} ms, of it "
                  f"{wait_s * 1e3:.1f} ms waiting for the transport (share "
                  f"{wait_s / step_s:.3f})")
            if st.get("p2p_send_bytes", 0) != want_b:
                raise AssertionError(f"phase 20: rank {r} sent {st.get('p2p_send_bytes')} "
                                     f"bytes in step 3, the schedule {want_b}")
        from scaling_tpu_torch.obs.report import load_run_dir, pipeline_section

        say("  obs report's pipeline section over the four ranks' run directory (rank 0's "
            "spans):")
        for line in pipeline_section(load_run_dir(root / "piped"))[1:]:
            say(f"    {line}")
        child_step = one["steps"][stop]["t"] - one["steps"][stop - 1]["t"] - PIPE["pause_s"]
        say(f"  step time with four ranks sharing one card, in the script with phase 19's "
            f"beside them (not a scaling figure), steps 3-4: "
              f"{[round((ranks[0]['steps'][s]['t'] - ranks[0]['steps'][s - 1]['t'] - PIPE['pause_s']) * 1e3, 1) for s in (3, 4)]} "
              f"ms; the child's step {stop} {child_step * 1e3:.1f} ms (host clock between step "
              f"records, less the pause; run wall {run_s:.1f}s)")
        total: dict = {}
        for rec in ranks:
            for k, v in rec["end"]["kernel"].items():
                total[k] = total.get(k, 0) + v
        out = {"pipe_4ranks": total}
        if sliced is not None:
            join_runner(*sliced, "phase 21 (c)'s two ranks", root / "sliced" / "logs")
            out.update(slices_check(dist_records(root / "sliced" / "logs", 2), one, sliced_cfg,
                                    say_slices))
        return out
    finally:
        for thread, _ in runners:
            thread.join(timeout=PIPE["timeout_s"])
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------- phase 21: sequence splitting
def step_delta(rec: dict, step: int, field: str) -> dict:
    """``field``'s counters in ``step``: its record's less the step before's."""
    now, before = rec["steps"][step][field], rec["steps"][step - 1][field]
    return {k: now.get(k, 0) - before.get(k, 0) for k in set(now) | set(before)}


def split_check(what: str, ranks: list, ref: dict, steps: list, ref_steps: list,
                groups: list, want_launches: dict, want_bytes: dict, say,
                last=None, phase: str = "21") -> dict:
    """The checks of a phase 21 (or 22) launch against its reference's
    records: the losses of ``steps`` against ``ref_steps`` (0.02); the global
    gradient norm and each logical layer's Adam first moment, summed over
    the ranks' pieces, relative ``PIPE["update_rtol"]``; K2-K5 in step
    ``last`` (the last of ``steps`` by default) summed over each group of
    ranks equal to ``want_launches``, no plain version; each rank's
    collective bytes of that step equal to ``want_bytes`` (by
    ``collectives.STATS`` key). Prints the readings, each rank's memory and
    the step times; returns the launches of the run."""
    got = [ranks[0]["steps"][s]["loss"] for s in steps]
    want = [ref["steps"][s]["loss"] for s in ref_steps]
    diffs = [abs(a - b) for a, b in zip(got, want)]
    say(f"  {what}: losses of steps {steps} {got}; the reference's {want}; |diff| {diffs} "
        f"(tol {DIST['loss_tol']})")
    if not all(math.isfinite(x) for x in got + want) or max(diffs) > DIST["loss_tol"]:
        raise AssertionError(f"phase {phase} {what}: losses {got} vs {want}")
    worst = {}
    for s, r in zip(steps, ref_steps):
        norms = ref["steps"][r]["grad_norm"], ranks[0]["steps"][s]["grad_norm"]
        worst[f"grad norm, step {s}"] = abs(norms[1] - norms[0]) / norms[0]
        for k, v in ref["steps"][r]["moment_sq"].items():
            split = sum(rec["steps"][s]["moment_sq"].get(k, 0.0) for rec in ranks)
            worst[f"{k} first moment, step {s}"] = abs(
                math.sqrt(split) - math.sqrt(v)) / math.sqrt(v)
    far = max(worst, key=worst.get)
    say(f"  {what}: global gradient norms {[ranks[0]['steps'][s]['grad_norm'] for s in steps]}, "
        f"the reference's {[ref['steps'][r]['grad_norm'] for r in ref_steps]}; the largest "
        f"relative difference over them and the layers' Adam first moments {worst[far]:.3e} "
        f"({far}; tol {PIPE['update_rtol']})")
    if not all(math.isfinite(v) for v in worst.values()) or worst[far] > PIPE["update_rtol"]:
        raise AssertionError(f"phase {phase} {what}: {far} differs by {worst[far]}")
    last = steps[-1] if last is None else last
    for group in groups:
        launched = {k: sum(step_delta(ranks[r], last, "kernel").get(k, 0) for r in group)
                    for k in DIST_KERNELS}
        if launched != want_launches:
            raise AssertionError(f"phase {phase} {what}: ranks {group} launched {launched} in "
                                 f"step {last}, the layout's count {want_launches}")
    plain = {r: rec["end"]["plain"] for r, rec in enumerate(ranks)}
    if any(sum(v.values()) for v in plain.values()):
        raise AssertionError(f"phase {phase} {what}: plain versions ran on the card: {plain}")
    say(f"  {what}: K2-K5 in step {last} over each of {groups}: {want_launches} (the layout's "
        f"count from the reference's); no plain version on any rank")
    for r, rec in enumerate(ranks):
        moved = step_delta(rec, last, "stats")
        for key, n in want_bytes.items():
            if moved.get(key, 0) != n:
                raise AssertionError(f"phase {phase} {what}: rank {r} moved {moved.get(key, 0)} "
                                     f"{key} in step {last}, the count from the shapes {n}")
        step_s = rec["steps"][last]["t"] - rec["steps"][last - 1]["t"] - DIST["pause_s"]
        say(f"  {what} rank {r}: step {last} moved "
            + ", ".join(f"{k} {v}" for k, v in sorted(moved.items())
                        if k.endswith("_bytes") and v)
            + f" (the count from the shapes: {want_bytes}); max_memory_allocated "
            f"{rec['end']['max_allocated'] / 1e9:.3f} GB (the reference's "
            f"{ref['end']['max_allocated'] / 1e9:.3f} GB); step {step_s * 1e3:.1f} ms "
            "(host clock between step records, less the pause; ranks share the card)")
    total: dict = {}
    for rec in ranks:
        for k, v in rec["end"]["kernel"].items():
            total[k] = total.get(k, 0) + v
    return total


def split_config(prefixes: dict, root: Path, name: str, cp: int, variant: str,
                 dp: int) -> dict:
    """Phase 19's config at cp x dp (ZeRO-1 when dp > 1) with ``variant``
    attention, for ``SPLIT["steps"]`` steps, not saving."""
    config = dist_config(prefixes, root, name, dp, 1, SPLIT["steps"], save=False)
    config["topology"].update(context_parallel_size=cp, context_parallel_variant=variant)
    config["runner"]["default_gpu_count"] = cp * dp
    return config


def split_phase(base: dict, reference, device: str = "cuda", say=print) -> dict:
    """Phase 21 (a) and (b): see the module docstring (21). ``reference``
    (a ``Future``) gives phase 19's one-rank records once every process of
    phase 19 has ended; the runs start then. Started beside phase 19's
    ranks, they took the card's used memory to 80.47-81.56 GB of its 85.02;
    after its four ranks, beside its resume child, to 67.80-77.70 (PERF.md
    "PR 20"). Returns the launches of each run, summed over its ranks, by
    path."""
    cp, dp = SPLIT["cp"], SPLIT["dp"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_split_"))
    runs = {"ring": (cp, "ring", dp), "ulysses": (cp, "ulysses", 1)}
    runners = {}
    try:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        configs = {name: split_config(base["prefixes"], root, name, *layout)
                   for name, layout in runs.items()}
        ref = reference.result(timeout=DIST["timeout_s"])
        for name, cfg in configs.items():
            runners[name] = start_runner(cfg)
        for name, (thread, result) in runners.items():
            join_runner(thread, result, f"phase 21 ({name})", root / name / "logs")
        arch = configs["ring"]["transformer_architecture"]
        layers, seq = arch["num_layers"], arch["sequence_length"]
        heads, kv_heads = arch["num_attention_heads"], arch["attention_num_kv_heads"]
        d = arch["hidden_size"] // heads
        s_loc, base_launch = seq // cp, step_delta(ref, SPLIT["steps"], "kernel")
        one = {k: base_launch.get(k, 0) for k in DIST_KERNELS}
        out = {}
        for name, (_, variant, run_dp) in runs.items():
            world = cp * run_dp
            ranks = dist_records(root / name / "logs", world)
            b = TRAINER["mbs"] // run_dp  # a data rank's micro-batch
            kv = 2 * b * s_loc * kv_heads * d * 2  # K and V of a slice, bf16
            seg = b * s_loc * 4
            if variant == "ring":
                # per layer: (cp - 1) K/V and segment hops each way, cp f32 dK/dV hops
                want_bytes = {"ring_send_bytes": layers * (
                    2 * (cp - 1) * (kv + seg) + cp * 2 * kv)}
                launches = dict(one, flash_attention_fwd=0, flash_attention_bwd=0)
            else:
                q = b * s_loc * heads * d * 2
                # per layer: q, k, v and the output each way; the segment ids' gather
                want_bytes = {"all_to_all_bytes": layers * 2 * (2 * q + kv),
                              "all_gather_bytes": layers * cp * seg}
                launches = one
            label = {"ring": f"(a) ring, cp {cp} x dp {run_dp} with ZeRO-1",
                     "ulysses": f"(b) Ulysses, cp {cp}"}[name]
            out[f"split_{name}"] = split_check(
                label, ranks, ref, [1, 2], [1, 2], [[r] for r in range(world)], launches,
                want_bytes, say)
        return out
    finally:
        for thread, _ in runners.values():
            thread.join(timeout=SPLIT["timeout_s"])
        shutil.rmtree(root, ignore_errors=True)


def slices_check(ranks: list, child: dict, config: dict, say) -> dict:
    """Phase 21 (c): the two stages at pp 2 x S token slices, resumed from
    phase 20's step-2 checkpoint, against phase 20's one-rank child."""
    from scaling_tpu_torch.parallel.pipeline_schedule import executor_schedule

    S, stop = SPLIT["ts"], PIPE["stop_step"]
    arch, topo = config["transformer_architecture"], config["topology"]
    act = topo["micro_batch_size"] * arch["sequence_length"] * arch["hidden_size"] * 2 // S
    steps = list(range(3, stop + 1))
    want = stage_launches([child], stop)
    launches = {k: S * want[k] if k in ("rms_norm", "rms_norm_bwd") else 0
                for k in DIST_KERNELS}
    total = split_check(f"(c) token slices, pp 2 x S {S}, {topo['activation_checkpointing_type']}",
                        ranks, child, steps, steps, [[0, 1]], launches, {}, say)
    for stage, rec in enumerate(ranks):
        sends = sum(i.name in ("send_activation", "send_grad") for i in executor_schedule(
            2, stage, topo["gradient_accumulation_steps"], 1, S).instructions())
        moved = step_delta(rec, stop, "stats").get("p2p_send_bytes", 0)
        say(f"  (c) stage {stage}: the transport sent {moved} bytes in step {stop} in "
            f"{sends} hops of {act} (1/{S} of an unsliced micro-batch's); the schedule's "
            f"count {sends * act}")
        if moved != sends * act:
            raise AssertionError(f"phase 21 (c): stage {stage} sent {moved} bytes, the "
                                 f"schedule's count {sends * act}")
    say("  (c) the step-2 checkpoint: not compared, phase 20's one-rank child saves none")
    return {"split_slices": total}


# ------------------------------------- phase 22: ZeRO-3 and sequence parallelism
def zero3_config(prefixes: dict, root: Path) -> dict:
    """Phase 19's config at dp x mp with ZeRO-3 and sequence parallelism,
    ``ZERO3["steps"]`` steps saving every ``ZERO3["save_interval"]``."""
    config = dist_config(prefixes, root, "zero3", ZERO3["dp"], ZERO3["mp"], ZERO3["steps"])
    config["topology"]["sequence_parallel"] = True
    config["optimizer"] = dict(config["optimizer"], zero=True, zero_stage=3)
    config["trainer"]["save_interval"] = ZERO3["save_interval"]
    return config


def zero3_counts(arch: dict, dp: int, mp: int, mbs: int) -> dict:
    """What a rank of the dp x mp ZeRO-3, sequence-parallel layout holds and
    moves in a step of one micro-batch of ``mbs`` sequences, from the
    shapes: ``param_bytes`` at rest (each leaf over the model group where
    JAX's spec splits it, over the data group where ``spec_with_data_axis``
    places the data axis); ``param_gather_bytes`` (each sliced leaf's model
    slice gathered in the forward, and again in the backward where autograd
    keeps it: the matrices but the embedding table, and the norm gains),
    ``grad_reduce_scatter_bytes`` (each sliced leaf's f32 gradient), and
    ``seq_gather_bytes`` / ``seq_reduce_scatter_bytes`` (2L + 1 region
    entries and exits, each one way in the forward and the other in the
    backward, of the whole local sequence's activations)."""
    from scaling_tpu_torch.models.transformer import TransformerConfig, TransformerModel
    from scaling_tpu_torch.parallel.parallel_module import (
        data_slice_dim, jax_param_key, jax_partition_spec, to_jax_layout)

    cfg = TransformerConfig.from_dict({"topology": {"micro_batch_size": 1,
                                                    "gradient_accumulation_steps": 1},
                                       "transformer_architecture": arch})
    a = cfg.transformer_architecture
    model = TransformerModel(a, device="meta")
    size = torch.empty((), dtype=a.dtype).element_size()
    at_rest = gathered = reduced = 0
    for name, p in model.named_parameters():
        key = jax_param_key(model, name)
        spec = jax_partition_spec(key, p.ndim)
        n = p.numel() // (mp if "model" in spec else 1)
        sliced = data_slice_dim(key, spec, tuple(to_jax_layout(key, p).shape), dp) is not None
        at_rest += size * n // (dp if sliced else 1)
        if sliced:
            kept = (p.ndim == 2 and not name.endswith("embedding.weight")) or (
                "norm" in name and name.endswith(".weight"))
            gathered += size * n * (2 if kept else 1)
            reduced += 4 * n
    act = size * mbs * a.sequence_length * a.hidden_size
    seq = (4 * a.num_layers + 2) * act
    return {"param_bytes": at_rest, "param_gather_bytes": gathered,
            "grad_reduce_scatter_bytes": reduced, "seq_gather_bytes": seq,
            "seq_reduce_scatter_bytes": seq}


def zero3_phase(base: dict, ref: dict, device: str = "cuda", say=print) -> dict:
    """Phase 22: see the module docstring (22). ``ref``: phase 19's one-rank
    records. Returns the launches of the run, summed over its
    ranks, by path."""
    from scaling_tpu_torch.resilience import read_mesh_meta
    from scaling_tpu_torch.tune.costmodel import memory_gb_per_device
    from scaling_tpu_torch.tune.layouts import Layout, ModelSpec

    dp, mp = ZERO3["dp"], ZERO3["mp"]
    world = dp * mp
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_zero3_"))
    config = zero3_config(base["prefixes"], root)
    runner = None
    try:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.monotonic()
        runner = start_runner(config)
        log_dir = root / "zero3" / "logs"
        join_runner(*runner, "phase 22", log_dir)
        run_s = time.monotonic() - t0
        ranks = dist_records(log_dir, world)
        arch = config["transformer_architecture"]
        mbs = config["topology"]["micro_batch_size"]
        want = zero3_counts(arch, dp, mp, mbs)
        base_launch = step_delta(ref, DIST["ref_steps"], "kernel")
        one = {k: base_launch.get(k, 0) for k in DIST_KERNELS}
        last = ZERO3["steps"]
        moving = {k: v for k, v in want.items() if k != "param_bytes"}
        total = split_check(f"(a, b, d, e) dp {dp} x mp {mp}, ZeRO-3, sequence parallel", ranks,
                            ref, [1, 2], [1, 2], [[r] for r in range(world)], one, moving, say,
                            last=last, phase="22")
        # (c) the merged step-2 checkpoint against the ranks' logits at its save
        step_dir = root / "zero3" / "ckpt" / f"global_step{ZERO3['save_interval']}"
        mesh = read_mesh_meta(step_dir)
        named = (mesh["optimizer"]["zero_stage"], mesh["topology"].get("sequence_parallel"))
        t_cpu = time.monotonic()
        card = torch.from_numpy(np.load(log_dir / f"probe_logits_step{ZERO3['save_interval']}"
                                                  ".npy"))
        cpu = dist_cpu_logits(step_dir, config)
        scale = cpu.abs().max().item()
        err = (card - cpu).abs().max().item() / scale
        uniform = ((cpu.amax(-1) - cpu.amin(-1)) / 2).max().item() / scale
        say(f"  (c) MESH.json of step {ZERO3['save_interval']}: zero_stage {named[0]}, "
            f"sequence_parallel {named[1]}; the probe row ({DIST['probe_tokens']} tokens) at "
            f"its weights, the four ranks' forward vs the f32 CPU forward of the merged "
            f"checkpoint: max_abs_err={err * scale:.4e} max|logit|={scale:.4e} "
            f"err/max|logit|={err:.3e} (tol {DIST['logit_tol']}; constant logits would give >= "
            f"{uniform:.3e}) ({time.monotonic() - t_cpu:.1f}s)")
        if named != (3, True) or not uniform > DIST["logit_tol"] or \
                not err <= DIST["logit_tol"]:
            raise AssertionError(f"phase 22 (c): MESH.json {named}, err {err}, constant "
                                 f"logits {uniform}")
        # (f) the parameters at rest; memory beside phase 19's and the tuner's
        layout = Layout(pp=1, dp=dp, cp=1, mp=mp, micro_batch_size=mbs,
                        gradient_accumulation_steps=1, sp=True, zero_stage=3)
        predicted = memory_gb_per_device(ModelSpec.from_arch(arch), layout)
        for r, rec in enumerate(ranks):
            end = rec["end"]
            say(f"  (f) rank {r}: parameters at rest {end['param_bytes']} bytes (the count "
                f"from the shapes {want['param_bytes']}); max_memory_allocated "
                f"{end['max_allocated'] / 1e9:.3f} GB (phase 19's ZeRO-1 rank 0 "
                f"{ref['zero1_max_allocated'] / 1e9:.3f} GB, the one-rank run's "
                f"{ref['end']['max_allocated'] / 1e9:.3f} GB; the tuner's prediction "
                f"{predicted:.3f} GB)")
            if end["param_bytes"] != want["param_bytes"]:
                raise AssertionError(f"phase 22 (f): rank {r} holds {end['param_bytes']} "
                                     f"parameter bytes, the count {want['param_bytes']}")
        times = [ranks[0]["steps"][s]["t"] - ranks[0]["steps"][s - 1]["t"] - DIST["pause_s"]
                 for s in range(2, last + 1)]
        say(f"  step time with four ranks sharing one card (not a scaling figure), steps "
            f"2-{last}: {[round(t * 1e3, 1) for t in times]} ms (step 2 with its save; host "
            f"clock between step records, less the pause; run wall {run_s:.1f}s)")
        return {"zero3_sp_4ranks": total}
    finally:
        if runner is not None:  # after a failed check: the runner ends on its own
            runner[0].join(timeout=ZERO3["timeout_s"])
        shutil.rmtree(root, ignore_errors=True)


class CardMemory:
    """The card's used memory, every process's (``torch.cuda.mem_get_info``),
    sampled on a thread from ``start`` to ``stop``."""

    def __init__(self, period_s: float = 0.25):
        self.period_s, self.peak = period_s, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="card-memory", daemon=True)

    def _used(self) -> int:
        free, total = torch.cuda.mem_get_info()
        self.total = total
        return total - free

    def _run(self) -> None:
        while not self._stop.is_set():
            self.peak = max(self.peak, self._used())
            time.sleep(self.period_s)

    def start(self) -> "CardMemory":
        self.before, self.own = self._used(), torch.cuda.memory_allocated()
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        return {"before": self.before, "own": self.own, "peak": self.peak, "total": self.total}


def add_launches(rows: list, launches_by_path: dict) -> None:
    """``launches``: the sum over the main-path runs; ``launches_by_path``:
    each run's own count (``launches_by_path`` maps a run's name to the
    counters read just after it)."""
    for r in rows:
        r["launches_by_path"] = {path: counts.get(r["name"], 0)
                                 for path, counts in launches_by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        print(f"  {r['name']}: launches={r['launches']} {r['launches_by_path']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import scaling_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    print(f"== card: {card}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise AssertionError(f"needs compute capability (9, 0), found {cap}")
    print(f"== torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.monotonic()
    laps, last = {}, [t_start]

    def lap(name: str) -> None:  # wall seconds of each phase, printed at the end
        now = time.monotonic()
        laps[name], last[0] = round(now - last[0], 1), now

    print("== build")
    print(f"  kernels built in {build_kernels():.1f}s")
    lap("build")
    print("== kernels vs plain versions")
    errs = check_kernels()
    for name, err in check_training_kernels().items():
        errs[name] = max(err, errs.get(name, 0.0))
    lap("check kernels")
    print("== serve 0.5B (full width and depth, random weights, seed 0)")
    served_by_kv = {kv_dtype: serve(kv_dtype, audit=kv_dtype == "native")
                    for kv_dtype in ("native", "int8")}
    launches_by_path = {f"serve_{kv}": stats["launches"] for kv, stats in served_by_kv.items()}
    serve_native = served_by_kv["native"]
    lap("serve (4)")
    print("== train 0.5B (full width and depth, random weights, seed 0; mbs 4, seq 2048)")
    trained = train()
    launches_by_path["train"] = trained["launches"]
    lap("train (5)")
    for name, arch in generation_models().items():
        print(f"== generate {name} (full width, {GEN['layers']} of 8 layers, random weights, "
              "seed 0)")
        launches_by_path[f"generate_{name}"] = generation_phase(name, arch)
    print(f"== atman: the 0.5B model's logits of {ATMAN['batch']} x {ATMAN['seq']} tokens "
          "under attention controls, both variants")
    launches_by_path["atman"] = atman_phase(generation_models()["0.5b"])
    lap("generate (6)")
    print(f"== moe (phase 15): {MOE['model']}, the 0.5B widths with 8 routed experts (top-2) "
          "under muP: the layer card vs cpu, training, serving")
    launches_by_path.update(moe_phase())
    lap("moe (15)")
    print(f"== features (phase 16): the 0.5B widths cut to {FEATURES['layers']} layers: a "
          "multimodal finetune, the CLIP backbones, local-window heads in cached decode; "
          "phase 5's step under each remat mode")
    launches_by_path.update(features_phase())
    lap("features (16)")
    print("== kernel times (device: torch.profiler; per call: CUDA events)")
    rows = time_kernels(errs)
    lap("kernel times (7)")
    # before the trainer phase, after which torch.profiler now and then drops
    # device events: this run's trace must name K4 and K5
    print("== tuner (phase 18 (c)): the training tuner's prediction for phase 10's run, "
          "calibrated from phase 5's MFU")
    from scaling_tpu_torch.tune import PREDICTION_ENV

    os.environ[PREDICTION_ENV] = json.dumps(observed_run_prediction(trained["mfu"]))
    print("== observe (phase 10): a 5-step Trainer run with the events file and a profiler "
          "window at steps 2-3")
    try:
        observed = observe_train(trained["step_ms"])
    finally:
        os.environ.pop(PREDICTION_ENV, None)
    launches_by_path["observe_train"] = observed["launches"]
    print("== observe: serve bench --run-dir at phase 4's native traffic")
    kept_serve = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_run_"))  # phase 18 (b)'s
    atexit.register(shutil.rmtree, kept_serve, True)
    served = observe_serve(serve_native, keep_run=kept_serve / "run")
    launches_by_path["observe_serve"] = served["launches"]
    lap("observe (10)")
    # last: after the trainer's run the profiler drops device events now and
    # then (on an H100 a kernel's profiled sum fell to half its time after
    # it), so the kernel times are taken before it
    print(f"== trainer: 0.5B at full width, {trainer_arch()['num_layers']} layers, from token "
          "datasets; checkpoints, resume, serve the checkpoint")
    keep = Path(tempfile.mkdtemp(prefix="chip_smoke_base_"))  # phase 12's base, until then
    atexit.register(shutil.rmtree, keep, True)
    trainer_run = trainer_phase(trained["step_ms"], keep=keep)
    launches_by_path["trainer"] = trainer_run["launches"]
    lap("trainer (8)")
    print("== supervise: the trainer phase's run with preemption, prefetch, asynchronous "
          "checkpoints, the watchdog and run_with_resume, in child processes")
    supervised = supervise_phase(trainer_run, trained["step_ms"])
    launches_by_path["supervise"] = supervised["launches"]
    print("== observe (phase 10): obs report over phase 9's run directory")
    try:
        observe_supervised(supervised["run_dir"], supervised["k"])
    finally:
        shutil.rmtree(supervised["run_dir"].parent, ignore_errors=True)
    lap("supervise (9)")
    print("== relaunch (phase 11): the trainer phase's run under the supervisor through a "
          "crash, a hang and a drain, then a second supervisor to the end")
    relaunched = relaunch_phase(trainer_run)
    launches_by_path["relaunch"] = relaunched["launches"]
    lap("relaunch (11)")
    print("== finetune (phase 12): LoRA on the trainer phase's step-6 checkpoint with dropout; "
          "resume, remat, probability dropout, merge and serve")
    finetuned = finetune_phase(trainer_run["base"])
    launches_by_path["finetune"] = finetuned["launches"]
    lap("finetune (12)")
    print("== tooling (phase 17): Megatron data through the Trainer, the C++ pack builder, "
          "a reference checkpoint exported, imported and served, the restore's fault points, "
          "the train bench's micro-batch ladder")
    ladder = {}
    launches_by_path.update(tooling_phase(trainer_run["base"], ladder_out=ladder))
    lap("tooling (17)")
    # phases 19 and 20 side by side (their checks hold no time; their step
    # times, four ranks sharing the card, are no scaling figures either way)
    print(f"== dist (phase 19): phase 8's model and data at dp {DIST['dp']} x mp {DIST['mp']} "
          "with ZeRO-1, four worker processes of runner_main sharing the card (gloo); a "
          "one-rank run beside it; SIGTERM to rank 3; a one-rank resume; phase 20 runs beside "
          "it, its lines follow")
    pipe_lines: list = []
    split_lines: list = []
    zero3_lines: list = []
    one_rank = Future()
    gc.collect()
    torch.cuda.empty_cache()
    card_used = CardMemory().start()
    with ThreadPoolExecutor(2) as pool:
        piped = pool.submit(pipe_phase, trainer_run["base"], "cuda", pipe_lines.append,
                            split_lines.append)
        split = pool.submit(split_phase, trainer_run["base"], one_rank, "cuda",
                            split_lines.append)
        launches_by_path.update(dist_phase(trainer_run["base"], share=one_rank))
        launches_by_path.update(piped.result())
        launches_by_path.update(split.result())
        # phase 22 once every process of 21 (a) and (b) has ended, for the card's memory
        launches_by_path.update(zero3_phase(trainer_run["base"], one_rank.result(), "cuda",
                                            zero3_lines.append))
    used = card_used.stop()
    print(f"== pipe (phase 20), beside phase 19: phase 8's data and the 0.5B model at "
          f"{PIPE['layers']} layers, pp {PIPE['pp']} x vpp {PIPE['vpp']} x dp {PIPE['dp']} with "
          f"ZeRO-1, {PIPE['remat']}, accumulation {PIPE['gas']}: four worker processes of "
          "runner_main sharing the card (gloo); a one-rank child resumes the step-2 checkpoint; "
          "SIGTERM to rank 3")
    print("\n".join(pipe_lines))
    print(f"== split (phase 21), beside phases 19 and 20: (a) ring at cp {SPLIT['cp']} x dp "
          f"{SPLIT['dp']} with ZeRO-1 and (b) Ulysses at cp {SPLIT['cp']}, phase 19's model, "
          f"data and global batch, held to phase 19's one-rank run; (c) pp 2 x "
          f"pipe_token_slices {SPLIT['ts']}, {PIPE['remat']}, resuming phase 20's step-2 "
          "checkpoint beside its one-rank child and held to it")
    print("\n".join(split_lines))
    print(f"== zero3 (phase 22), after phase 21 (a) and (b): phase 19's model, data and global "
          f"batch at dp {ZERO3['dp']} x mp {ZERO3['mp']} with ZeRO-3 and sequence parallelism, "
          f"{ZERO3['steps']} steps saving at step {ZERO3['save_interval']}, held to phase 19's "
          "one-rank run")
    print("\n".join(zero3_lines))
    print(f"  the card's used memory over phases 19-22 (every process's, torch.cuda.mem_get_info "
          f"sampled every 0.25 s): before {used['before'] / 1e9:.2f} GB (this process's own "
          f"allocated {used['own'] / 1e9:.2f} GB), peak {used['peak'] / 1e9:.2f} GB of "
          f"{used['total'] / 1e9:.2f} GB")
    lap("dist, pipe, split, zero3 (19, 20, 21, 22)")
    print("== modes (phase 13): speculative decoding, whole-prompt prefill, separate "
          "forwards; crash replay, drain, a wedged tick and overload in child benches")
    launches_by_path.update(modes_phase(serve_native, served["tokens"]))
    lap("modes (13)")
    print("== fleet (phase 14): workload F through one engine, --replicas 2 and "
          "--replicas-proc 2, a replica killed mid-stream, a drain")
    launches_by_path.update(fleet_phase())
    lap("fleet (14)")
    print("== tuner (phase 18): K1 by block size; the serving tuner's config served; the "
          "training tuner beside the ladder; the dispatch audit of phase 5's step and a tick")
    launches_by_path.update(tuner_phase(kept_serve / "run", trained["mfu"], ladder,
                                        serve_native))
    lap("tuner (18)")
    t, serving = observed["turns"], served["turns"]
    print(f"  obs overhead (medians of the turns): Trainer step ms with all of obs "
          f"{t['on']:.2f}, without the events file and on_step {t['no_events']:.2f}, "
          f"obs stubbed out {t['stub']:.2f}; the first steps with the events file on "
          f"{observed['step_ms']:.2f}, phase 8's {trainer_run['step_ms']:.2f}; serving "
          + ", ".join(f"{kind} {v['tokens_per_s']:.1f} tokens/s and {v['tick_ms']:.3f}ms a tick"
                      for kind, v in serving.items())
          + f", phase 4's {serve_native['tokens_per_s']:.1f} and "
          f"{serve_native['wall_s'] / serve_native['ticks'] * 1e3:.3f}ms; a span "
          f"{observed['span_ms'] * 1e3:.1f}us, telemetry.on_step + flush "
          f"{observed['telemetry_ms']:.3f}ms")
    print("== launches on the main paths")
    add_launches(rows, launches_by_path)
    print(f"== phase seconds: {laps}")
    print(f"== done in {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--supervise-child"]:
        sys.exit(supervise_child(sys.argv[2]))
    if sys.argv[1:2] == ["--supervise-runner"]:
        sys.exit(relaunch_supervisor(sys.argv[2]))
    if any(a.startswith("--payload=") for a in sys.argv[1:]):
        sys.exit(relaunch_worker() if "CHIP_SMOKE_RECORDS" in os.environ else dist_worker())
    sys.exit(main())
