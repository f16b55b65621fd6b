#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Record the card (``nvidia-smi`` name and power limit) and build the three
   CUDA kernels from ``klab_multimodalmodel_tpu_torch/csrc``, one ``nvcc``
   per source, all at once; print ptxas's registers and spills of every
   kernel instantiation; build the port's C++ host runtime.
   b. The port's JPEG decoder on the card's host (no model): every fixture
      of ``tests/torch_jpeg/`` decoded natively at Pillow's draft scale for
      256 px, its pixels held to the manifest's digest of Pillow's decode,
      and ``load_image_bytes_resized`` (decode and resize) to the digest of
      the JAX package's; the fixtures that Pillow cannot write (4:4:0,
      4:1:1, arithmetic coding, lossless) at every draft scale too, a
      lossless frame refused at a draft scale; prints the decode and load
      ms per image (median of 5, one thread) of the COCO sizes, the 1/8
      drafts and those fixtures (by scale), with the host CPU's model
      name.
2. Hold each kernel against its plain PyTorch version at the shapes of both
   main paths, and time kernel, plain version and the library yardstick
   (``F.scaled_dot_product_attention``, forward or forward+backward) with
   CUDA events, beside the least time the card could take. Times are device
   times: the host enqueues each timed loop behind a device-side sleep (see
   ``time_both``), and the host's time per call of the kernel's wrapper
   and of SDPA is printed beside them at the forward kernels' shapes:
   - T5 forward: captioning shapes at rate 0 (fp32, bf16); training shapes
     (batch 32, bf16) at rate 0.1 against the plain version under the same
     Philox mask, once more with uniform probabilities (any keep bit that
     differed would show), and the keep fraction over 52 M probabilities;
   - T5 backward: the three training shapes (encoder self 320x320 with
     dBias, decoder self 128x128 with relpos+causal bias and dBias, cross
     128x320 with a key mask) at rate 0.1 in fp32 and bf16 against the plain
     backward, dq, dk, dv and dBias bitwise equal across two runs, and the
     time with dBias against without it (the dS scratch and its reduction);
   - at the training shapes, both T5 kernels also timed without dropout and
     without the head bias: what each input costs them;
   - Swin forward: every stage shape with the fp32 and the bf16 softmax
     chain, at captioning (fp32) and training (bf16, batch 32) shapes; then
     swinv2-large's windows (N = 36 and 144) and launches whose windows do
     not split evenly into the kernel's groups (see
     ``swin_extra_cases``), in both input dtypes and both chains. Beside
     each timed Swin shape, a yardstick for the attention part only: SDPA
     on q and k normalized and scaled outside the timed call, with the
     bias (and mask) as its float mask. No single PyTorch call computes
     the whole function, so it is no ``library_ms``.
   Each redesigned kernel's time per request or per step is printed beside
   that of the kernel it replaced (``OLD_PATH_MS``, as ``PERF.md`` records
   it) and beside SDPA's or the yardstick.
3. Caption at full width: SwinV2-base + t5-large text tower + t5-large
   transformer (~1.16 B parameters, fp32, seeded random weights), both
   kernel flags on, three batch-8 requests through ``Captioner``; checks the
   launch counts of every request (24 Swin, 48 T5), the token layout, a
   finite encoder output, and the encoder output against the same weights
   run without the kernels.
4. Train at full width: the reference caption recipe's ``Config`` defaults
   (compute bf16, fp32 parameters, Adam lr 1e-3, frozen towers, both kernel
   flags on), batch 32, one warm-up step and five timed steps with dropout
   on one fixed batch of seeded images, the COCO prompt and seeded captions.
   Checks the launches of every step (T5 forward 96, 72 of them at rate
   0.1; T5 backward 72, 48 with dBias; Swin 24), finite and falling losses,
   frozen towers bitwise unchanged, both relative-position tables moved;
   then, at batch 8 with dropout off, the loss and every trainable
   gradient with the kernels against the same weights without them, and in
   bf16 compute against the forward kernel followed by the plain backward
   (the backward kernel's roundings) and against the path without kernels
   (see ``TOL_TRAIN_GRAD``).
   Prints step time, images/s, peak memory and one profiled step (with the
   optimizer's device time).
5. The ``train_with_swin`` recipe and the training options:
   a. the SwinV2 tower trainable (``image_model_train``), both kernel flags
      on, otherwise phase 4's set-up: one warm-up and five timed steps.
      Checks the launches of every step (phase 4's: the Swin kernel's 24
      forwards; its backward is a recompute in plain PyTorch), finite and
      falling losses, the text tower bitwise unchanged, every SwinV2 tensor
      moved (each logit scale and the position-bias MLP included), and the
      trainable count (t5-large + projection + the SwinV2 tower). Prints
      step time, images/s, peak memory, the profiled step's busy share and
      the Swin backward's device time in it.
   b. batch 8, dropout off, on 5a's weights: the loss and every SwinV2
      gradient with the Swin kernel against the same path without it,
      checked at phase 4's tolerances in fp32 compute, printed beside them
      in bf16 compute, with a reading that splits the bf16 gap (see
      ``swin_kernel_vs_none``).
   c. three timed steps each of the frozen towers and Adam's first moment
      stored in bf16, of Adafactor, and of ``remat`` 'full' and
      'dots_saveable' (frozen towers, kernel flags on, batch 32), in one
      table beside phase 4's step: step ms, device busy ms, the optimizer's
      device time and share, peak memory. Under remat each step launches
      the T5 forward 96 + 72 times (the recompute).
6. The training loop: ``train(config)`` at full width (the Config
   defaults, both kernel flags on, batch 32, 2 epochs) on the synthetic
   dataset (64 rows of 256 px, the COCO prompt; 2 updates and 2 validation
   batches an epoch), two runs in a temporary result directory: A
   uncached; C with ``cache_frozen_features`` (epoch 1 fills, epoch 2 trains
   from the cache). First one step twice from the same state and generator
   (the determinism reading). Checks the launches of every step and
   validation batch (full step 96 / 72 / 24 T5 forward / backward / Swin,
   cached step 72 / 72 / 0, full val batch 96 / 0 / 24, cached val batch
   72 / 0 / 0), C's losses against A's, the cache files and
   ``metrics.jsonl``. Prints each step kind's device span (CUDA events,
   nothing synchronized inside the loop) and peak memory, one profiled
   full and one profiled cached step, images/s per epoch, the host time the
   deferred fill blocks, and each save's size, stall and background write;
   the free disk before it. (A halted and resumed run is phase 10b's.)
7. The evaluation path on phase 3's weights (the same seed) and requests:
   a. beam search (``num_beams`` 4) through ``Captioner.caption``: one
      warm-up and three timed batch-8 requests; checks every request's
      launches (24 Swin, 48 T5 forward: the encoder runs once, before its
      output is repeated per beam), the token layout, ``num_beams=1``
      through the router against phase 3's greedy tokens, and the beams
      with the kernels against the same weights without them (identical
      rows counted; for each row that differs the two best scores and
      their margin printed). Prints request ms, decoder passes, ms per
      pass, busy share and peak memory.
   b. sampling (temperature 0.7, top-k 50, top-p 0.9) from a CUDA
      generator: two runs from one seed are equal, every drawn token has a
      finite warped logit under the same decode steps, ``top_k=1`` gives
      the greedy tokens.
   c. ``caption_stream`` (chunk 4): its final texts equal ``caption``'s;
      prints the time to the first yield.
   d. ``evaluation.run`` over a COCO-layout directory whose 40
      ``val2017/*.jpg`` are the fixture JPEGs in turn, with four seeded
      references each, at batch 32 (a ragged tail of 8), with
      ``num_beams`` 1 and 4, the files read by the port's own
      ``load_image_resized`` (native decode and resize; timed); checks the
      launches, the 40 loads and ``metrics.json``'s keys and finite
      values; prints images/s and the loader's ms per image.
8. The reference's artifacts at full width, needing nothing the card's
   machine lacks (no ``transformers``, ``tokenizers``, ``safetensors`` or
   Pillow), in a temporary directory that is removed afterwards:
   a. phase 3's seeded weights exported through ``checkpoint.export_hf``:
      the t5-large LM as a HF ``model.safetensors`` (a minimal writer kept
      here) and the SwinV2 tower as ``pytorch_model.bin``; a seeded
      T5-layout ``tokenizer.json`` (32,000 unigram pieces with a
      Precompiled charsmap of full-width letters, 100 sentinels); then
      ``python -m klab_multimodalmodel_tpu_torch convert-hf`` in a
      subprocess. Checks the converted ``transformer`` and ``image_model``
      bitwise against phase 3's, ``language_model`` against the LM's
      encoder, and ``load_pretrained_params`` (strict) on all of them.
      Prints the GB written and read and each step's seconds.
   b. three batch-8 requests through ``Captioner`` with
      ``load_tokenizer(<dir>/tokenizer.json)`` on images of COCO sizes
      (375x500, 480x640, 640x427, ...) through the native bicubic resize.
      Checks every request's launches (24 Swin, 48 T5), a finite encoder
      output and the encoder against the same weights without kernels, the
      prompt's ids (``tokenizer(prompt)``'s one C++ call against the ids
      one text at a time, and the decode back to the prompt), the charsmap, and that every caption,
      and the text of as many seeded rows of ordinary ids, is a ``str``
      that survives encode and decode (random weights emit mostly special
      ids); counts the rows that re-encode to their own ids. Prints request
      ms, resize ms per image, and encode us per caption one by one against
      ``tokenizer()``, and in a long batch on one thread against the
      default threads.
   c. ``train(config)`` from the converted directory with its
      ``tokenizer.json`` and ``native_tokenizer``, batch 32, one epoch of 2
      updates and 2 validation batches over a COCO-layout directory of the
      fixture JPEGs (64 a split). Checks every step's launches (phase 6's
      full step), finite losses, the text tower equal to the converted
      one, and one loader batch's ids against the tokenizer's ids one text
      at a time. Prints step spans and the loader's encode ms per batch.
      Then ``python -m klab_multimodalmodel_tpu_torch caption`` in a
      subprocess on three fixture JPEGs with the run's directory: one
      caption line per file.
9. The serving stack on phase 3's weights (the same seed), fp32, both
   kernel flags on, the byte tokenizer and the COCO prompt. Each of the 16
   requests carries a fixture's JPEG bytes (the fixtures in turn), which
   the services decode natively; each image, decoded from the same bytes,
   is first captioned alone (batch 1): every served token row must equal
   its image's own row, or differ only at a knife edge (greedy's top-2
   margin there under ``KNIFE_EDGE_REL``, printed).
   a. ``CaptionService`` (max_batch 8, window 5 ms) behind
      ``CaptionHTTPServer`` on 127.0.0.1: ``/healthz`` 503 before the
      warmup and 200 after; one round of 16 concurrent ``/caption``
      requests from 16 client threads; every response 200 with a ``str``;
      24 Swin + 48 T5 launches per dispatched batch. Prints p50/p90
      request ms, captions/s, mean batch rows and one profiled round's
      busy share.
   b. ``ContinuousCaptionService`` (16 slots, engine chunk 4, max_prefill
      8) under the same load: 24 + 48 launches per prefill, no fallback;
      the same readings beside 9a's, plus the tick's span (enqueue to
      reap), passes per tick and live slots; then eight arrivals through
      a ``DecodeEngine`` with staggered inserts against ``greedy_decode``
      of the same encoder rows, an idle slot's cache index run past the
      buffer.
   c. ``/caption_stream`` on 9a's server: the last event is ``/caption``'s
      text; prints the time to the first event. Then a JPEG body cut in
      half gets 400 "bad image" with the decoder's reason, and the next
      ``/caption`` is answered as before; the first body with 16 zero
      bytes in place of its EOI marker gets 200 and the same caption.
   d. ``Captioner(speculative_draft=4)`` on phase 3's three batch-8
      requests against greedy (knife-edge rule); prints decoder passes,
      accepted drafts and request ms beside greedy's, timed in turn.
   e. ``Captioner(decode_int8=True)``: one decode step's logits against the
      same weights held as Q s in fp32 (``TOL_INT8_DEQUANT_REL``); prints
      the token rows equal to fp32 greedy's, request ms and peak memory
      beside fp32's in turn, and the int8 tree's bytes.
   Then ``serve --replicas 2`` on one card must exit with the JAX
   package's message.
10. Data-parallel training (DDP), phase 6's set-up (the Config defaults,
   both kernel flags, ``cache_frozen_features``, 64 synthetic rows, 2
   epochs, global batch 32) with the transformer's depth cut to 2 + 2
   blocks of t5-large (the launches per step follow: ``step_launches``),
   the per-rank memory reckoned and printed first:
   c. one rank over NCCL (world 1, this process's own process group):
      the DDP reducer on NCCL on the card, at batch 32 and dropout 0. It
      runs both epochs, since it is also 10a's one-process reference.
   a. two ranks sharing the one card (``cuda:0`` given explicitly, gloo on
      CUDA tensors: NCCL refuses two ranks on one device), launched by
      ``torch.distributed.run``, which runs this script again with
      ``--ddp-rank SPEC`` (the ranks' output in
      ``chiprun_out/phase10_ranks.log``); batch 16 per rank, dropout 0.
      Checks: the ranks' losses equal each other; per-step train losses
      and ``min_val_loss`` against 10c within ``TOL_DDP``; every trainable
      tensor's update against 10c's (cosine, and the largest difference
      under Adam's bound, see ``TOL_DDP``); the frozen towers bitwise
      unchanged on each rank; each rank's launches per step and
      validation batch (no dropout launch); the checkpoint
      written by rank 0 alone and loading with ``strict=True``. Prints
      per rank the step spans and peak memory, the global images/s, and
      one profiled rank-0 full step with the all-reduce's device and host
      time and the busy share.
   b. the same two-rank command with dropout 0.1: uninterrupted, halted
      after update 3, and run again to resume; the resumed losses and
      parameters equal the uninterrupted run's bitwise (or within phase
      6's determinism reading), and the two ranks' first dropout masks
      differ.
   A rank that fails, or a launcher that exits non-zero, fails the run.
11. Mixture of experts at full width: phase 4's set-up with 4 experts,
   top-2, capacity factor 1.25 and aux weight 0.01 in every MLP of the
   t5-large transformer (24 + 24 blocks, each expert d_ff 4096), its
   memory reckoned and printed before anything is built (batch 32, or 16
   where 32 is reckoned over ``MOE_MEMORY_LIMIT_GB``):
   a. one warm-up and three timed ``Trainer`` steps, dropout on: phase 4's
      launches per step (MoE adds no attention launch), finite and falling
      losses, finite balance losses, the frozen towers bitwise unchanged,
      every router and expert slice moved; prints step ms, images/s, peak
      memory and one profiled step's busy share with the device time under
      the routing, the experts' FFN and the einsums' backward.
   b. batch 8, dropout off, on 11a's weights, fp32 compute: the loss and
      every trainable gradient with the kernels against the same path
      without them (``TOL_TRAIN_GRAD``); the routing assignments of the two
      runs compared token by token, the router's top-k margin printed at
      each flip (no tolerance widened for one).
   c. three batch-8 greedy requests through ``Captioner`` on 11a's weights
      (fp32, both kernel flags): 24 Swin and 48 T5 launches each, the
      tokens equal to a stepwise ``decode_step`` oracle, and eight rows
      through a ``DecodeEngine`` against ``greedy_decode`` (9b's rule);
      request ms beside phase 3's.
12. The GPipe schedule at full width: phase 4's set-up at batch 16 with
   the T5 kernel off (the JAX package refuses it with a pipeline), the
   transformer's stacks as 4 stages of 8 microbatches, and the same
   weights at one stage: one warm-up and two timed steps each (Swin 24
   launches, T5 0), step ms and peak memory of each; then, dropout off and
   fp32 compute, the loss and every gradient of 4 stages against 1
   (``TOL_TRAIN_GRAD``).
13. Sharded training (FSDP2 over fsdp, tensor parallelism over tensor) at
   t5-3b's full width (d_model 1024, 32 heads of d_kv 128, d_ff 16384),
   its depth cut to 1 + 1 blocks, behind the default towers; bf16 compute,
   Adam, both kernel flags, batch 16, dropout 0; every run from the same
   seeded weights and rows. The per-rank memory of each layout is reckoned
   first (``parallel.partitioning.per_rank_bytes``).
   a. one process (world 1): one warm-up and one timed ``Trainer`` step,
      the reference of 13b-c; phase 4's checks (launches of every step,
      finite losses, frozen towers unchanged).
   b. ``(1, 2, 1)``: fsdp 2, batch 8 per rank; then its checkpoint, which
      rank 0 alone writes, restored into a one-process ``Trainer`` here.
   c. ``(1, 1, 2)``: tensor 2, 16 rows on both ranks: the transformer runs
      16 of 32 heads per rank (the text tower whole on both); after the
      compared steps one step at dropout 0.1, then every parameter that no
      tensor rank splits must be bitwise equal on both ranks.
   13b and 13c run as one job of two ranks on the one card (gloo on CUDA
   tensors, as phase 10): a ``RankServer`` of ``torch.distributed.run``
   that runs this script again with ``--rank-server DIR``, started as
   phase 1 ends and kept for phases 14 and 15's jobs (the ranks' output
   in ``chiprun_out/phase13_15_ranks.log``). Checks: each rank's launches per
   step (T5 forward 27, backward 3, 2 with dBias, Swin 24;
   ``step_launches``); the first step's gradients of every trainable
   tensor and both steps' losses against 13a's (``TOL_SHARD``; the
   updates after both steps are printed beside them); the checkpoint
   restored bitwise. Prints per rank the step spans, peak memory, and in
   one profiled 13c step gloo's host time and the busy share (13b's, of a
   10-13 s step, are in ``PERF.md``). Then the T5 kernels at 13c's
   per-rank shapes (bf16, 16 heads of d_kv 128) against their plain
   versions with and without ``head_offset``, and their times per step
   beside the plain versions', SDPA's and the bound.
14. Sequence parallelism over the seq axis: t5-large cut to 2 + 2 blocks
   behind the default towers at full depth, bf16, Adam, batch 16,
   dropout 0 for the compared steps, every run from the same seeded
   weights and rows.
   a. one process, both kernel flags: one warm-up and two timed steps, a
      profiled step, one step at dropout 0.1; a'. the same with the T5
      kernel off. The references of b and c.
   b. ``(1, 1, 1, 2)``, the all-gather path, both kernel flags: each rank
      runs its half of every T5 stack's positions (the K/V gathered over
      the seq group, the kernels keyed on the global query with
      ``q_offset``); c. the same with ``--seq_attention ring`` and the T5
      kernel off (the ring staged through the host: gloo refuses CUDA
      tensors for point-to-point). Checks: each rank's launches per step
      equal a's (T5 forward 30, backward 6, 4 with dBias, Swin 24) or
      a''s (Swin 24), c's ring turning 36 times a step; the first step's
      gradients and three losses against a's or a''s (``TOL_SHARD``); the
      dropout-0.1 step's loss against the one process's on the same
      stream (b draws the same masks; c's ring draws Philox masks where
      a' draws the generator's: two draws); every parameter bitwise equal
      on both ranks.
   d. one step at batch 2 with the prompt padded to 2048 ids (2112 encoder
      positions), the T5 kernel off: peak memory of a' and, per rank, of
      b' (c's trainer on the all-gather path) and c; the ring's must be
      below b''s.
   b and c (with their d steps) run as one job of phase 13's two ranks.
   a takes a loss at dropout 0.1 with no update (``dropout_probe``)
   before and after its first step, as b and c do: phase 18's
   references. Prints per rank the step spans,
   peak memory, and in one profiled step gloo's host time and the busy
   share.
   e. The T5 kernels at a 14b rank's shapes (bf16, batch 16, 16 heads of
      d_kv 64, half of each stack's queries against every key) against
      their plain versions at rate 0.1 with and without ``q_offset``, and
      their times per step beside the plain versions', SDPA's and the
      bound.
15. Experts and pipeline stages on ranks: t5-large cut to 2 + 2 blocks
   behind the default towers, bf16, Adam, batch 16, dropout 0 for
   the compared steps, every run from the same seeded weights and rows.
   The per-rank state of each run is reckoned first
   (``parallel.partitioning.per_rank_bytes``).
   a. one process: the MoE model (4 experts, top-2, capacity factor 1.25,
      both kernel flags) and the pipelined one (2 stages, 4 microbatches,
      the T5 kernel off, the Swin kernel on), each a warm-up, one timed
      step, a profiled step and one step at dropout 0.1. The references
      of b and c (a's MoE run is phase 16's too).
   b. ``(1, 1, 1, 1, 1, 2)``: each rank holds and runs 2 of the 4 experts
      of every MoE layer; c. ``(1, 1, 1, 1, 2, 1)``: each rank holds and
      runs one stage (1 + 1 blocks), the microbatches shifted between the
      ranks through the host. Both in one job of phase 13's two ranks,
      which then leave while the four of phases 16 to 19 start. Checks: each rank's launches per
      step equal a's (b: T5 forward 30, backward 6, 4 with dBias, Swin
      24; c: Swin 24); every loss, the dropout step's too, within 5e-4 of
      a's and the first step's gradients at cosine >= 0.999
      (``TOL_SPLIT``); under 0.1 % of b's first-step token-routings
      flipped against a's (the count printed); the replicated parameters
      bitwise equal on both ranks; each run's checkpoint, which rank 0
      writes from both ranks' parts, restored bitwise into a one-process
      ``Trainer`` here. Prints per rank the step spans, peak memory and
      the state it holds beside the reckoning and a's, and in one profiled
      step gloo's host time and the busy share.
16. MoE on a sharded mesh: phase 15a's MoE model (its 15a run the
   reference) over four ranks sharing the card in one job of a
   four-rank ``RankServer`` (gloo on CUDA tensors), which runs phases
   17's to 20's runs too (one start of four processes; the ranks'
   output in ``chiprun_out/phase16_19_ranks.log``). The rank jobs of
   phases 13 to 20 run beside phases of this process that need nothing
   of theirs, so the script runs its phases in the order 1-4, 13 (6
   beside its job), 14 (8 beside), 15 (12 beside), then the four-rank
   runs beside 7, 10, 5 and 9 (20a alone first, beside 7), then the
   checks of 16 to 20, and 11, whose MoE step needs most of the card,
   last (see ``main``):
   b. ``(1, 2, 1, 1, 1, 2)``: fsdp 2 x expert 2, both fsdp ranks on all
      16 rows (the MoE layers' and the stacks' dropout draws at a rank's
      rows: split rows would not hold one process's masks), FSDP2
      sharding the bank slices and the rest; c. ``(1, 1, 2, 1, 1, 2)``:
      tensor 2 x expert 2, the four ranks on the same 16 rows, rank (t, e)
      running d_ff columns t of experts e. Each a warm-up, one timed step,
      a profiled step and a step at dropout 0.1; the per-rank state
      reckoned first. Checks (``TOL_SPLIT``): the ranks' losses equal,
      every loss within 5e-4 of 15a's, the first step's gradients
      (gathered and joined) at cosine >= 0.999, under 0.1 % of the
      token-routings flipped, each rank's launches per step equal 15a's,
      the router and every parameter a tensor x expert group holds alike
      bitwise equal across it, the state held equal to the reckoning,
      and each run's checkpoint restored bitwise into a one-process
      ``Trainer`` here against the whole parameters rank 0 gathered for
      it (one gather). Prints per rank the step spans, peak memory, and in one profiled
      step gloo's host time and the busy share.
17. GPipe stages on a sharded mesh: phase 15a's pipelined model (its 15a
   run the reference: 2 stages, 4 microbatches, the T5 kernel off, the
   Swin kernel on) over the four ranks of phase 16's job: a. ``(1, 2, 2, 1, 1,
   1)`` with the stages unsharded, fsdp 2 x tensor 2 (every block an FSDP2
   unit gathered at each tick of the one-process schedule), a warm-up and
   one timed step; b. ``(1, 2, 1, 1, 2, 1)``: fsdp 2 x pipe 2, 8 rows a
   rank; c. ``(1, 1, 2, 1, 2, 1)``: tensor 2 x pipe 2, the four ranks on
   the same 16 rows; b and c each a warm-up, one timed step, a profiled
   step and a step at dropout 0.1 (each rank its rows of one process's
   masks). The per-rank state reckoned first; checks as phase 16's
   (``TOL_SPLIT``; no routings): the ranks' losses equal and within 5e-4
   of 15a's, the dropout step's too, the first step's gradients gathered
   and joined at cosine >= 0.999, launches per step equal 15a's (Swin 24,
   T5 0), what a tensor x pipe group holds alike bitwise equal across it,
   the state held equal to the reckoning, each checkpoint restored
   bitwise into a one-process ``Trainer`` (the ranks gather the whole
   state once, for the checkpoint). Prints per rank the step spans, peak
   memory, and in one profiled step gloo's host time and the busy share.
18. Sequence parallelism beside FSDP2 and tensor parallelism: phase 14's
   model (its 14a, 14a' and 14c runs the references) over the four ranks
   of phase 16's job: a. ``(1, 2, 1, 2)``: fsdp 2 x seq 2 on the
   all-gather path, both kernel flags (both fsdp ranks on all 16 rows);
   b. ``(1, 1, 2, 2)``: tensor 2 x seq 2, the same flags (the
   transformer's T5 kernels at heads 8..15 and seq rank 1's rows at
   once); c. the same mesh on the ring, the T5 kernel off. Each a loss at
   dropout 0.1 with no update, a warm-up, a step at dropout 0.1 and one
   timed step. Checks (``TOL_SPLIT``): the ranks' losses equal, the first
   loss and the first step's gradients against 14a's (14a''s for the
   ring), both dropout losses against 14a's probes before and after its
   first step (14c's for the ring: one process with the T5 kernel off
   draws the generator's masks, the ring Philox's), launches per step
   equal 14a's (a''s), every trainable shard bitwise equal across each
   seq group, the state held equal to the reckoning, a's checkpoint
   restored bitwise into a one-process ``Trainer``. d. The T5 kernels at
   an 18b rank's transformer shapes (8 heads at ``head_offset`` 8 and
   ``q_offset``) against their plain versions with both offsets at once
   and with none, and their times per step beside the plain versions',
   SDPA's and the bound.
19. MoE under sequence parallelism: phase 15a's MoE model (its 15a run,
   16a, the reference, with its losses at dropout 0.1 before and after
   its first step) over the four ranks of phase 16's job, all 16 rows on
   every rank: a. ``(1, 1, 1, 2, 1, 2)``: seq 2 x expert 2, rank (s, e)
   running seq rank s's positions and experts e (DDP over each expert
   slice's two seq ranks); b. ``(1, 1, 2, 2, 1, 1)``: tensor 2 x seq 2,
   rank (t, s) running d_ff columns and heads t at positions s. Each
   routing group spans the seq ranks. Each a loss at dropout 0.1 with no
   update, a warm-up, a step at dropout 0.1 and one timed step. Checks:
   the ranks' losses equal, the first loss within 1e-5 (a) or 5e-5 (b)
   of 16a's, the first step's gradients gathered and joined at cosine
   >= 0.9999 (a) or 0.999 (b) (``TOL_MOE_SEQ``), both dropout losses
   within 5e-4 of 16a's probes, under 0.1 % of the first step's
   token-routings flipped against 16a's (the seq ranks' rows joined),
   launches per step equal 16a's, every trainable parameter and shard
   bitwise equal across each seq group, the state held equal to the
   reckoning, a's checkpoint restored bitwise into a one-process
   ``Trainer``. Prints per rank the step spans, peak memory and the
   state held, and each routing call's tokens dropped at capacity beside
   16a's.
20. Sharded init and per-shard checkpoints at t5-11b's width, in the
   four-rank job (see the comment above ``INIT_MESH``): a. t5-11b at full
   depth initialized at fsdp 2 x tensor 2 (the job's first run, while the
   card is nearly empty), each rank's parameters and peak against the
   reckoning, eight samples bitwise one process's; b. at 1 + 1 blocks: the
   init, a step, a per-shard checkpoint restored at fsdp 4 and in one
   process bitwise, a second step on each layout; c. the T5 kernels at
   b's per-rank shapes.
21. Prints the ``{"kernels": [...]}`` line (with each kernel's launches in
   one phase-5a step, in phase 6's full and cached steps, in one phase-7a
   beam request, in one phase-8b request and one phase-8c step, in one
   batch of phase 9a, in one full step of a phase-10a rank, in one
   phase-11a step and one phase-11c request, in one phase-12 step, in one
   step of a phase-13c rank, in one step of a phase-14b rank, in one step
   of a phase-15b and of a phase-15c rank, in one step of a phase-16b
   and of a phase-16c rank, in one step of a phase-17b and of a
   phase-17c rank, in one step of a phase-18a and of a phase-18b rank,
   in one step of a phase-19a and of a phase-19b rank, and in one step
   of a phase-20b rank), then
   ``{"ok": true, ...}`` as the last line.

It needs one card and exits non-zero, printing no result, where
``torch.cuda.is_available()`` is false. Full results also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from collections.abc import Generator

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "klab_multimodalmodel_tpu_torch/csrc/"
TPU_KERNELS = "klab_multimodalmodel_tpu/ops/fused_attention.py"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    # Both forwards replace modes of the one forward Pallas kernel.
    "t5_attention_fwd": (CSRC + "t5_attention_fwd.cu", TPU_KERNELS + ":109"),
    "t5_attention_bwd": (CSRC + "t5_attention_bwd.cu", TPU_KERNELS + ":179"),
    "swin_attention_fwd": (CSRC + "swin_attention_fwd.cu",
                           TPU_KERNELS + ":109"),
}

# Per-path times of the kernels that this tree's kernels replaced, as
# PERF.md section 6 records them (chip_smoke.py on NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside this run's: (kernel, path): (ms, what, source).
OLD_PATH_MS = {
    ("t5_attention_fwd", "training"): (
        160.49, "scalar kernel", "PERF.md section 6, row 1"),
    ("t5_attention_bwd", "training"): (
        300.07, "scalar kernels", "PERF.md section 6, row 3"),
    ("t5_attention_fwd", "captioning"): (
        2.03, "scalar fp32 kernel", "PERF.md section 6, row 1f"),
    ("swin_attention_fwd", "training"): (
        6.32, "block per (window, head)", "PERF.md section 6, row 2"),
    ("swin_attention_fwd", "captioning"): (
        1.742, "block per (window, head)", "PERF.md section 6, row 2f"),
}

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): memory,
# fp32 outside the tensor cores (fp32 inputs), bf16 tensor cores (bf16).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}

# Kernel vs plain version: summation order; bf16 also rounds q/k, the
# probabilities and the output (one bf16 ulp of a result near 2-4 is 0.016).
TOL_FP32 = dict(rtol=0.0, atol=1e-4)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
# Gradients, largest error over largest value: dS and the dropped
# probabilities are rounded to bf16 before their products in bf16; the bias
# gradient sums the fp32 dS in both versions.
TOL_GRAD = {"float32": 1e-4, "bfloat16": 2e-2, "dbias": 1e-4}
# Swin with a bf16 softmax chain: a logit can round one bf16 ulp apart (fp32
# dot products summed in another order), which moves one probability by up
# to ~28 % at logits in [32, 64). Such flips are rare: at most 1e-4 of the
# outputs may fall outside the bf16 tolerance above, and the mean error
# stays under 1e-3.
TOL_SWIN_BF16_CHAIN = dict(outside=1e-4, mean=1e-3)
# Keep fraction of the dropout at rate 0.1.
TOL_KEEP = 1e-3
# Encoder output with kernels vs without, relative to its largest value:
# fp32 summation order compounded over 24 + 24 + 24 layers.
TOL_ENCODER_REL = 1e-3
# Training at batch 8, dropout off, on the same weights: the loss within
# 1e-2 relative; every trainable tensor's gradient at cosine >= 0.99 and a
# norm within 2 %, all of them together at cosine >= 0.999 (TOL_TRAIN_GRAD).
# That holds the kernels against the path without them in fp32 compute, where
# the two differ by summation order only, and in bf16 compute against the
# forward kernel followed by the plain backward, which rounds as the backward
# kernel does. The path without kernels rounds otherwise in bf16: its
# autograd rounds dP to bf16 (the gradient of the probabilities' cast) before
# dS = P (dP - sum dP P) subtracts two near-equal numbers, where the backward
# kernel, as the TPU kernel, keeps dP in fp32; and its forwards round
# differently from the kernels'. Single deep-decoder q/k gradients move by a
# few % under either. Against that path every tensor is held at cosine >= 0.9
# and a norm within 15 % (TOL_TRAIN_GRAD_BF16_VS_NONE).
TOL_TRAIN_LOSS_REL = 1e-2
TOL_TRAIN_GRAD = dict(cosine=0.99, norm=0.02, total=0.999)
TOL_TRAIN_GRAD_BF16_VS_NONE = dict(cosine=0.9, norm=0.15, total=0.999)

BATCH, REQUESTS, SEED = 8, 3, 0
TRAIN_BATCH, CMP_BATCH, STEPS, RATE = 32, 8, 5, 0.1
T5_H, T5_D, SWIN_N, SWIN_D = 16, 64, 64, 32
T5_LAYERS = 24
SRC_LEN, TGT_LEN, IMG_TOKENS = 256, 128, 64
ENC_LEN = IMG_TOKENS + SRC_LEN


def build_report() -> list[dict]:
    """ptxas's registers and spills of every kernel instantiation that this
    process built, printed one line each (names demangled by ``c++filt``
    where the toolkit's machine has it)."""
    from klab_multimodalmodel_tpu_torch.ops import cuda_build

    rows = [dict(source=name, **r)
            for name, log in cuda_build.build_logs.items()
            for r in cuda_build.ptxas_report(log)]
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(r["function"] for r in rows),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) != len(rows):
        names = [r["function"] for r in rows]
    for r, name in zip(rows, names):
        r["kernel"] = name.replace("(anonymous namespace)::", "").split("(")[0]
        print(f"  {r['source']}: {r['kernel']}: {r['registers']} registers, "
              f"spill stores {r['spill_stores']} B, spill loads "
              f"{r['spill_loads']} B")
    return rows


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    check(bool(out), "nvidia-smi printed no card")
    return out.splitlines()[0]


# Clock cycles of the device-side sleep that holds the queue while the host
# enqueues a timed loop: ~25 ms at the H100's 1.98 GHz, longer than any
# loop's enqueue in phase 2.
HOLD_CYCLES = 50_000_000


def time_both(fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn()``: CUDA events around
    ``iters`` back-to-back calls that the host enqueues behind a device-side
    sleep (``torch.cuda._sleep``), so the device runs them from its queue
    without waiting for the host, and the host clock over the enqueue. A
    small kernel's wrapper can take longer on the host than the kernel on
    the card; back-to-back events would then time the host. Inputs stay warm
    in L2, as they are when the preceding projection has just written
    them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms (see ``time_both``)."""
    return time_both(fn, iters, warmup)[0]


def host_ms(fn, runs: int = 3) -> float:
    """Median host-clock time of ``fn()`` in ms, each run ending in a
    device synchronize (a request-level time)."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def sdpa_backends(fn) -> list[str]:
    """The ATen attention ops one call of ``fn`` ran (the SDPA backend)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted({e.key for e in prof.key_averages()
                   if e.key.startswith("aten::_scaled_dot_product")
                   or e.key.startswith("aten::_efficient_attention")
                   or e.key.startswith("aten::_flash_attention")})


# ---------------------------------------------------------------------------
# Phase 1b: JPEG decoding on the card's host (no model)
# ---------------------------------------------------------------------------

# The JPEG fixtures and their manifest (tests/torch_jpeg/make_fixtures.py):
# Pillow's RGB decode at the draft scale for 256 px, and the JAX package's
# load_image_bytes_resized(data, 256), as SHA-256 digests taken where Pillow
# is installed. Phases 1b, 7d, 8c and 9 decode these files.
JPEG_DIR = os.path.join(REPO, "tests", "torch_jpeg")
JPEG_SIZE = 256
JPEG_REPS = 5  # timed decodes of each fixture (the median is printed)


def jpeg_fixtures() -> list[tuple[str, bytes, dict]]:
    """(file name, bytes, manifest entry) of every fixture, by name."""
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for name in sorted(manifest):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            out.append((name, f.read(), manifest[name]))
    return out


def host_cpu() -> str:
    """The host CPU: ``/proc/cpuinfo``'s model name, or ``lscpu``'s, or
    where neither names it (a sandboxed kernel may not), its vendor, family
    and model numbers; then the architecture and the cores."""
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "")
    if name in ("", "unknown"):
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=60).stdout
            name = next((line.split(":", 1)[1].strip()
                         for line in out.splitlines()
                         if line.startswith("Model name")), name)
        except (OSError, subprocess.SubprocessError):
            pass
    if name in ("", "unknown") and "vendor_id" in info:
        name = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return (f"{name or 'unnamed CPU'} ({platform.machine()}, "
            f"{os.cpu_count()} cores)")


def median_ms(fn, reps: int = JPEG_REPS) -> float:
    """Median host-clock time of ``fn()`` in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def jpeg_phase(card: str) -> dict:
    """Phase 1b: every fixture decoded by the port's C++ decoder at the
    draft scale for 256 px, its pixels held to the manifest's digest of
    Pillow's decode, and the port's ``load_image_bytes_resized`` (decode
    and resize) to the JAX package's; the encoder's fixtures (4:4:0,
    4:1:1, arithmetic coding, lossless) at every draft scale too; the
    median decode and load ms of each, on one host thread."""
    import hashlib

    import numpy as np

    from klab_multimodalmodel_tpu_torch import native
    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_bytes_resized)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    t_phase = time.perf_counter()
    cpu = host_cpu()
    files = {}
    for name, data, entry in jpeg_fixtures():
        w, h = entry["size"]
        scale = native.draft_scale(w, h, JPEG_SIZE)
        check(scale == entry["draft_scale"], f"{name}: draft scale 1/{scale}"
              f", the manifest's 1/{entry['draft_scale']}")
        decoded = native.decode_jpeg(data, scale)
        check(list(decoded.shape) == entry["decode_shape"]
              and sha(decoded) == entry["decode"],
              f"{name}: the native decode {decoded.shape} differs from "
              "Pillow's (the manifest's digest)")
        resized = load_image_bytes_resized(data, JPEG_SIZE)
        check(sha(resized) == entry["resized_256"],
              f"{name}: load_image_bytes_resized differs from the JAX "
              "package's (the manifest's digest)")
        files[name] = dict(
            kind=entry["kind"], size=[w, h], draft_scale=scale,
            bytes=len(data),
            decode_ms=median_ms(lambda: native.decode_jpeg(data, scale)),
            load_ms=median_ms(lambda: load_image_bytes_resized(
                data, JPEG_SIZE)))
        # The encoder's fixtures (4:4:0, 4:1:1, arithmetic coding,
        # lossless) at every draft scale: Pillow's digest, or (a lossless
        # frame at a draft scale, which Pillow does not decode) a refusal.
        for s, want in entry.get("decode_scales", {}).items():
            s = int(s)
            if want is None:
                try:
                    native.decode_jpeg(data, s)
                    refused = False
                except ValueError:
                    refused = True
                check(refused, f"{name}: decoded at 1/{s}, where Pillow "
                      "does not decode it")
                continue
            check(sha(native.decode_jpeg(data, s)) == want,
                  f"{name}: the native decode at 1/{s} differs from "
                  "Pillow's (the manifest's digest)")
            files[name].setdefault("scale_ms", {})[s] = median_ms(
                lambda: native.decode_jpeg(data, s))
    for name, f in files.items():
        if f["kind"] in ("coco", "draft_s8") or "scale_ms" in f:
            print(f"phase 1b [{card}; host {cpu}]: {name} ({f['bytes']} "
                  f"bytes, draft 1/{f['draft_scale']}): decode "
                  f"{f['decode_ms']:.3f} ms, decode + resize to {JPEG_SIZE} "
                  f"{f['load_ms']:.3f} ms (median of {JPEG_REPS}, one "
                  "thread)" + ("; by scale " + ", ".join(
                      f"1/{s} {ms:.3f} ms" for s, ms in f["scale_ms"].items())
                      if "scale_ms" in f else ""))
    coco = [f["decode_ms"] for f in files.values() if f["kind"] == "coco"]
    seconds = time.perf_counter() - t_phase
    print(f"phase 1b [{card}; host {cpu}]: {len(files)} fixture JPEGs "
          f"decoded natively, every decode and resize equal to the "
          f"manifest's digests (Pillow's and the JAX package's); COCO sizes "
          f"{min(coco):.3f}-{max(coco):.3f} ms a decode; {seconds:.1f} s")
    return dict(host_cpu=cpu, files=files, seconds=seconds)


def coco_layout(root: str, counts: dict, captions) -> str:
    """An MSCOCO-layout directory under ``root`` ('mscoco' in its name, as
    ``build_dataset`` asks): for each phase in ``counts``, that many images
    in ``{phase}2017/``, the fixture JPEGs in turn (copied), and
    ``captions(i)``'s captions of image i in
    ``annotations/captions_{phase}2017.json``. Returns its path."""
    import shutil

    d = os.path.join(root, "mscoco2017")
    os.makedirs(os.path.join(d, "annotations"))
    names = [name for name, _, _ in jpeg_fixtures()]
    for phase, n in counts.items():
        os.makedirs(os.path.join(d, f"{phase}2017"))
        images, anns = [], []
        for i in range(n):
            file_name = f"{i:012d}.jpg"
            shutil.copyfile(os.path.join(JPEG_DIR, names[i % len(names)]),
                            os.path.join(d, f"{phase}2017", file_name))
            images.append({"id": i, "file_name": file_name})
            for text in captions(i):
                anns.append({"id": len(anns), "image_id": i,
                             "caption": text})
        with open(os.path.join(d, "annotations",
                               f"captions_{phase}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
    return d


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class T5Shape:
    name: str
    path: str          # "captioning" (per request) or "training" (per step)
    B: int
    Q: int
    K: int
    bias: bool         # a learned head bias (with dBias in the backward)
    mask: int          # keys masked at the end of every row, -1 for none
    rate: float
    per_path: int      # launches in one request or one training step
    causal: bool = False


def t5_shapes() -> list[T5Shape]:
    # Captioning: text tower at the COCO prompt's 30 ids bucketed to 32 (2
    # pad keys masked), main encoder at 64 image tokens + those 32.
    # Training, batch 32: text tower at 256 (the prompt padded: 226 pad
    # keys), main encoder at 320 (the same pads), decoder self-attention at
    # 128 with relpos + causal bias and no key mask, cross-attention 128 x
    # 320 with the encoder's key mask and no bias.
    pad = SRC_LEN - 30
    return [
        T5Shape("text", "captioning", BATCH, 32, 32, True, 2, 0.0, 24),
        T5Shape("encoder", "captioning", BATCH, 96, 96, True, 2, 0.0, 24),
        T5Shape("text", "training", TRAIN_BATCH, SRC_LEN, SRC_LEN, True, pad,
                0.0, T5_LAYERS),
        T5Shape("encoder", "training", TRAIN_BATCH, ENC_LEN, ENC_LEN, True,
                pad, RATE, T5_LAYERS),
        T5Shape("decoder", "training", TRAIN_BATCH, TGT_LEN, TGT_LEN, True,
                -1, RATE, T5_LAYERS, causal=True),
        T5Shape("cross", "training", TRAIN_BATCH, TGT_LEN, ENC_LEN, False,
                pad, RATE, T5_LAYERS),
    ]


def t5_inputs(sh: T5Shape, dtype, gen, H: int = T5_H, D: int = T5_D):
    import torch

    dev = "cuda"
    q = torch.randn(sh.B, H, sh.Q, D, generator=gen, device=dev)
    k, v, do = (torch.randn(sh.B, H, n, D, generator=gen, device=dev)
                for n in (sh.K, sh.K, sh.Q))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    bias = None
    if sh.bias:
        bias = torch.randn(H, sh.Q, sh.K, generator=gen, device=dev)
        if sh.causal:
            # The last Q rows of the causal mask (all of them at Q == K; a
            # last seq rank's otherwise).
            i = torch.arange(sh.K, device=dev)
            bias = bias + torch.where(i[sh.K - sh.Q:, None] >= i[None, :],
                                      0.0, -1e9)
    kmask = None
    if sh.mask >= 0:
        kmask = torch.ones(sh.B, sh.K, dtype=torch.int32, device=dev)
        kmask[:, sh.K - sh.mask:] = 0
    return q, k, v, do, bias, kmask


def sdpa_mask(bias, kmask, dtype):
    """The additive float mask SDPA takes for (bias, key mask)."""
    import torch

    parts = []
    if bias is not None:
        parts.append(bias[None])
    if kmask is not None:
        parts.append(torch.where(kmask[:, None, None, :] > 0, 0.0, -1e9))
    if not parts:
        return None
    out = parts[0] if len(parts) == 1 else parts[0] + parts[1]
    return out.to(dtype)


def io_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def check_t5_fwd(gen, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from klab_multimodalmodel_tpu_torch.ops import (draw_seed, t5_attention,
                                                    t5_attention_fwd,
                                                    t5_attention_plain)
    shapes, errs, errs16 = [], [], []
    for sh in t5_shapes():
        seed = draw_seed(gen) if sh.rate else None
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _, bias, kmask = t5_inputs(sh, dtype, gen)
            got = t5_attention(q, k, v, bias, kmask, sh.rate, seed)
            torch.cuda.synchronize()
            want = t5_attention_plain(q, k, v, bias, kmask, sh.rate, seed)
            err = max_err(got, want)
            tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
            check(torch.allclose(got.float(), want.float(), **tol),
                  f"t5 fwd {sh.name} {sh.path} {dtype}: max abs err {err}")
            (errs if dtype == torch.float32 else errs16).append(err)
            if sh.rate:
                # Uniform probabilities: each key weighs 1/(0.9 K), so one
                # keep bit that differed from the plain version's would move
                # an output by ~|v|/(0.9 K), far above the tolerance.
                z = torch.zeros_like(q)
                got = t5_attention(z, k, v, None, None, sh.rate, seed)
                want = t5_attention_plain(z, k, v, None, None, sh.rate, seed)
                check(torch.allclose(got.float(), want.float(), **tol),
                      f"t5 fwd {sh.name} uniform P {dtype}: keep bits "
                      f"differ (max abs err {max_err(got, want)})")
        # Time in the path's dtype: fp32 for captioning, bf16 for training.
        dtype = torch.float32 if sh.path == "captioning" else torch.bfloat16
        q, k, v, _, bias, kmask = t5_inputs(sh, dtype, gen)
        # Training calls that need a gradient also write the row stats.
        stats = sh.path == "training" and sh.name != "text"
        iters = 20 if sh.path == "training" else 50
        ms, host = time_both(lambda: t5_attention_fwd(
            q, k, v, bias, kmask, sh.rate, seed, stats), iters)
        plain = time_ms(lambda: t5_attention_plain(q, k, v, bias, kmask,
                                                   sh.rate, seed), iters)
        # What the kernel's inputs cost it at the training shapes: the same
        # call without dropout and without the head bias.
        costs = {}
        if sh.path == "training" and sh.rate:
            costs["rate0_ms"] = time_ms(lambda: t5_attention_fwd(
                q, k, v, bias, kmask, 0.0, None, stats), iters)
        if sh.path == "training" and bias is not None:
            costs["no_bias_ms"] = time_ms(lambda: t5_attention_fwd(
                q, k, v, None, kmask, sh.rate, seed, stats), iters)
        mask = sdpa_mask(bias, kmask, dtype)
        if mask is not None:
            mask = mask.expand(sh.B, T5_H, sh.Q, sh.K).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=sh.rate, scale=1.0)
        lib, lib_host = time_both(sdpa, iters)
        nbytes = (io_bytes(q, k, v, q) + io_bytes(bias, kmask)
                  + (8 * sh.B * T5_H * sh.Q if stats else 0))
        flops = 4 * sh.B * T5_H * sh.Q * sh.K * T5_D
        b, by = bound_ms(nbytes, flops, dtype_name(dtype))
        shapes.append(dict(
            name=sh.name, path=sh.path, shape=[sh.B, T5_H, sh.Q, sh.K, T5_D],
            dtype=dtype_name(dtype), rate=sh.rate, per_path=sh.per_path,
            ms=ms, plain_ms=plain, library_ms=lib, library=sdpa_backends(sdpa),
            bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
            host_ms=host, library_host_ms=lib_host, **costs))
        print(f"t5 fwd {sh.path} {sh.name} B={sh.B} Q={sh.Q} K={sh.K} "
              f"{dtype_name(dtype)} rate={sh.rate}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b:.4f} ms ({by}) "
              f"[{card}]" + "".join(f", {k.removesuffix('_ms')} {v:.4f} ms"
                                    for k, v in costs.items())
              + f"; host per call: wrapper {host:.4f} ms, sdpa "
              f"{lib_host:.4f} ms")

    # Keep fraction over 32*16*320*320 = 52.4 M probabilities: q = 0 and
    # v = 1 make every output (kept keys)/(0.9 K).
    z = torch.zeros(TRAIN_BATCH, T5_H, ENC_LEN, T5_D, device="cuda")
    out = t5_attention(z, z, torch.ones_like(z), None, None, RATE,
                       draw_seed(gen))
    keep = float(out[..., 0].double().mean() * (1 - RATE))
    print(f"dropout keep fraction over {z[..., 0].numel() * ENC_LEN} "
          f"probabilities: {keep:.6f} (0.9 +- {TOL_KEEP})")
    check(abs(keep - (1 - RATE)) <= TOL_KEEP, f"keep fraction {keep}")
    return dict(name="t5_attention_fwd", mode="plain (T5), rates 0 and 0.1",
                max_abs_err=max(errs), max_abs_err_bf16=max(errs16),
                keep_fraction=keep, shapes=shapes)


def check_t5_bwd(gen, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from klab_multimodalmodel_tpu_torch.ops import (draw_seed,
                                                    t5_attention_bwd,
                                                    t5_attention_bwd_plain,
                                                    t5_attention_fwd)
    shapes, errs, rels16 = [], [], []
    for sh in t5_shapes():
        if sh.path != "training" or sh.name == "text":
            continue  # the frozen text tower takes no backward
        seed = draw_seed(gen)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, bias, kmask = t5_inputs(sh, dtype, gen)
            _, stats = t5_attention_fwd(q, k, v, bias, kmask, RATE, seed,
                                        True)
            got = t5_attention_bwd(q, k, v, do, bias, kmask, RATE, seed,
                                   stats, sh.bias)
            torch.cuda.synchronize()
            want = t5_attention_bwd_plain(q, k, v, do, bias, kmask, RATE,
                                          seed, sh.bias)
            for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
                if w is None:
                    check(g is None, f"{name} without a bias")
                    continue
                tol = TOL_GRAD["dbias" if name == "dbias"
                               else dtype_name(dtype)]
                r = rel_err(g, w)
                check(g.dtype == w.dtype and r <= tol,
                      f"t5 bwd {sh.name} {dtype} {name}: rel err {r}")
                if dtype == torch.float32:
                    errs.append(max_err(g, w))
                else:
                    rels16.append(r)
            if sh.bias and dtype == torch.bfloat16:
                again = t5_attention_bwd(q, k, v, do, bias, kmask, RATE,
                                         seed, stats, True)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"t5 bwd {sh.name}: two runs differ (dq, dk, dv and "
                      "dBias must be bitwise reproducible)")
        # Time in bf16, as training runs it.
        dtype = torch.bfloat16
        q, k, v, do, bias, kmask = t5_inputs(sh, dtype, gen)
        _, stats = t5_attention_fwd(q, k, v, bias, kmask, RATE, seed, True)
        ms = time_ms(lambda: t5_attention_bwd(q, k, v, do, bias, kmask, RATE,
                                              seed, stats, sh.bias), 10, 2)
        # With dBias the dS scratch (B, H, Q, K) fp32 is written once and
        # read once by the reduction over b.
        no_dbias_ms = scratch_bytes = no_bias_ms = None
        if sh.bias:
            no_dbias_ms = time_ms(lambda: t5_attention_bwd(
                q, k, v, do, bias, kmask, RATE, seed, stats, False), 10, 2)
            scratch_bytes = 2 * 4 * sh.B * T5_H * sh.Q * sh.K
        if bias is not None:
            no_bias_ms = time_ms(lambda: t5_attention_bwd(
                q, k, v, do, None, kmask, RATE, seed, stats, False), 10, 2)
        rate0_ms = time_ms(lambda: t5_attention_bwd(
            q, k, v, do, bias, kmask, 0.0, None, stats, sh.bias), 10, 2)
        plain = time_ms(lambda: t5_attention_bwd_plain(
            q, k, v, do, bias, kmask, RATE, seed, sh.bias), 10, 2)
        # Library: SDPA forward + backward with the same dropout rate and a
        # float mask that requires grad where the bias does, minus its
        # forward.
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        bias_leaf = (bias.detach().requires_grad_() if bias is not None
                     else None)

        def sdpa_fwd():
            mask = sdpa_mask(bias_leaf, kmask, dtype)
            return F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, dropout_p=RATE, scale=1.0)

        def sdpa_fwd_bwd():
            inputs = leaves + ([bias_leaf] if bias_leaf is not None else [])
            return torch.autograd.grad(sdpa_fwd(), inputs, do)

        lib_fwd = time_ms(sdpa_fwd, 10, 2)
        lib = time_ms(sdpa_fwd_bwd, 10, 2) - lib_fwd
        # Reads q, k, v, dO, the bias, the key mask and the row stats once;
        # writes dq, dk, dv (the sizes of q, k, v) and dBias (the bias's).
        nbytes = (io_bytes(q, k, v, do) + io_bytes(q, k, v)
                  + io_bytes(bias, kmask, stats)
                  + (io_bytes(bias) if sh.bias else 0))
        # The gradients' four products plus the logits again (the inputs do
        # not hold P): 10 B H Q K D.
        flops = 10 * sh.B * T5_H * sh.Q * sh.K * T5_D
        b, by = bound_ms(nbytes, flops, "bfloat16")
        shapes.append(dict(
            name=sh.name, path="training", shape=[sh.B, T5_H, sh.Q, sh.K,
                                                  T5_D],
            dtype="bfloat16", rate=RATE, dbias=sh.bias, per_path=sh.per_path,
            ms=ms, plain_ms=plain, library_ms=lib,
            library=sdpa_backends(sdpa_fwd_bwd), bound_ms=b, bound_by=by,
            bytes=nbytes, flops=flops, no_dbias_ms=no_dbias_ms,
            dbias_scratch_bytes=scratch_bytes, rate0_ms=rate0_ms,
            no_bias_ms=no_bias_ms))
        print(f"t5 bwd training {sh.name} B={sh.B} Q={sh.Q} K={sh.K} bf16 "
              f"dbias={sh.bias}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"sdpa bwd {lib:.4f} ms ({shapes[-1]['library']}), bound "
              f"{b:.4f} ms ({by}) [{card}]")
        print(f"  without dropout {rate0_ms:.4f} ms" + (
            f", without the bias {no_bias_ms:.4f} ms"
            if no_bias_ms is not None else "") + f" [{card}]")
        if sh.bias:
            print(f"  without dBias {no_dbias_ms:.4f} ms: the dS scratch "
                  f"({scratch_bytes} bytes written and read) and its "
                  f"reduction cost {ms - no_dbias_ms:.4f} ms [{card}]")
    return dict(name="t5_attention_bwd", mode="T5, rate 0.1, dBias",
                max_abs_err=max(errs), max_rel_err_bf16=max(rels16),
                shapes=shapes)


def swin_stage_cases(batch: int):
    """(stage, windows B*nW, heads, nW of the shifted mask, unshifted
    blocks, shifted blocks, feature side) per stage of SwinV2-base at
    256 px."""
    from klab_multimodalmodel_tpu_torch.config import SwinV2Size

    size = SwinV2Size()
    side = size.image_size // size.patch_size
    out = []
    for si, (depth, heads) in enumerate(zip(size.depths, size.num_heads)):
        nW = (side // size.window_size) ** 2 if side > size.window_size else 1
        shifted = depth // 2 if side > size.window_size else 0
        out.append((si, batch * nW, heads, nW, depth - shifted, shifted,
                    side))
        side //= 2
    return out


def swin_extra_cases():
    """(case, windows Bn, heads, window side, feature side) beyond
    swinv2-base's stages: swinv2-large's windows at a small batch, and
    launches whose windows do not split evenly into the kernel's groups
    (with Bn H >= 2048 it puts G = 2 windows in a block, so an odd number
    of windows per mask position leaves a last block of one)."""
    return [("N=36 (window 6, nW=4)", 32, 4, 6, 12),
            ("N=144 (window 12, nW=4)", 32, 4, 12, 24),
            ("33 windows a mask position, G=2", 132, 16, 8, 16),
            ("65 windows unmasked, G=2", 65, 32, 8, 8)]


def swin_tables(gen, H: int, w: int, side: int):
    """A per-head logit scale, the position bias (H, N, N) and, where the
    feature map is larger than the window, the shifted-window mask."""
    import torch

    from klab_multimodalmodel_tpu_torch.models.swinv2 import (
        shifted_window_mask)
    scale = (torch.log(torch.tensor(10.0, device="cuda"))
             + 0.5 * torch.randn(H, generator=gen, device="cuda"))
    bias = 16 * torch.sigmoid(torch.randn(H, w * w, w * w, generator=gen,
                                          device="cuda"))
    wmask = None
    if side > w:
        wmask = torch.tensor(shifted_window_mask(side, side, w, w // 2),
                             device="cuda")
    return scale, bias, wmask


def chain_errors(got, want) -> dict:
    """Against the plain version with a bf16 softmax chain: the share of
    outputs outside the bf16 tolerance, the mean and the largest error."""
    e = (got.float() - want.float()).abs()
    out = float((e > TOL_BF16["atol"] + TOL_BF16["rtol"]
                 * want.float().abs()).float().mean())
    return dict(max=float(e.max()), mean=float(e.mean()), outside=out)


def chain_ok(c: dict) -> bool:
    return (c["outside"] <= TOL_SWIN_BF16_CHAIN["outside"]
            and c["mean"] <= TOL_SWIN_BF16_CHAIN["mean"])


def swin_yardstick(q, k, v, scale, bias, wmask):
    """SDPA on the attention part alone, as a yardstick: q and k
    L2-normalized and q scaled by its head's clamped logit scale outside
    the timed call, the bias (plus the window mask) as the float mask, in
    the input dtype. The port never calls it."""
    import torch
    import torch.nn.functional as F

    from klab_multimodalmodel_tpu_torch.ops.fused_attention import (
        LOG_MAX_SCALE)

    def l2n(x):
        x32 = x.float()
        return x32 * torch.rsqrt((x32 * x32).sum(-1, keepdim=True) + 1e-24)
    s = torch.exp(torch.clamp(scale, max=LOG_MAX_SCALE))
    qs = (l2n(q) * s[None, :, None, None]).to(q.dtype)
    kn = l2n(k).to(k.dtype)
    mask = bias[None]
    if wmask is not None:
        mask = mask + wmask.repeat(q.shape[0] // wmask.shape[0], 1,
                                   1)[:, None]
    mask = mask.to(q.dtype)
    return lambda: F.scaled_dot_product_attention(qs, kn, v, attn_mask=mask,
                                                  scale=1.0)


def check_swin_extra(gen) -> list[dict]:
    """``swin_extra_cases`` in both input dtypes and both chains against the
    plain version, at the tolerances of the stage shapes."""
    import torch

    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    swin_attention_plain)
    out = []
    for case, Bn, H, w, side in swin_extra_cases():
        scale, bias, wmask = swin_tables(gen, H, w, side)
        for wm in [None] + ([wmask] if wmask is not None else []):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(Bn, H, w * w, SWIN_D, generator=gen,
                                       device="cuda").to(dt)
                           for _ in range(3))
                for sm in (torch.float32, torch.bfloat16):
                    got = swin_attention(q, k, v, scale, bias, wm, sm)
                    torch.cuda.synchronize()
                    want = swin_attention_plain(q, k, v, scale, bias, wm, sm)
                    what = (f"swin {case} masked={wm is not None} {dt} "
                            f"chain {dtype_name(sm)}")
                    if sm == torch.float32:
                        tol = TOL_FP32 if dt == torch.float32 else TOL_BF16
                        err = dict(max=max_err(got, want))
                        check(torch.allclose(got.float(), want.float(),
                                             **tol),
                              f"{what}: max abs err {err['max']}")
                    else:
                        err = chain_errors(got, want)
                        check(chain_ok(err), f"{what}: {err}")
                    out.append(dict(case=case, shape=[Bn, H, w * w, SWIN_D],
                                    masked=wm is not None,
                                    dtype=dtype_name(dt),
                                    chain=dtype_name(sm), **err))
    print(f"swin beyond swinv2-base ({len(out)} checks: N=36, N=144, "
          f"ragged groups; both dtypes and chains): worst fp32-chain max abs "
          f"err {max(c['max'] for c in out if c['chain'] == 'float32'):.2e},"
          f" worst bf16-chain share outside "
          f"{max(c['outside'] for c in out if 'outside' in c):.2e}")
    return out


def check_swin(gen, card: str) -> dict:
    import torch

    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    swin_attention_plain)
    shapes, errs, errs16, chain = [], [], [], []
    for path, batch, dtype in (("captioning", BATCH, torch.float32),
                               ("training", TRAIN_BATCH, torch.bfloat16)):
        for si, Bn, H, nW, n_plain, n_shift, side in swin_stage_cases(batch):
            w = int(SWIN_N ** 0.5)
            scale, bias, wmask = swin_tables(gen, H, w, side)
            for masked, count in ((False, n_plain), (True, n_shift)):
                if count == 0:
                    continue
                wm = wmask if masked else None
                for dt in (torch.bfloat16, torch.float32):
                    q, k, v = (torch.randn(Bn, H, SWIN_N, SWIN_D,
                                           generator=gen,
                                           device="cuda").to(dt)
                               for _ in range(3))
                    got = swin_attention(q, k, v, scale, bias, wm)
                    torch.cuda.synchronize()
                    want = swin_attention_plain(q, k, v, scale, bias, wm)
                    err = max_err(got, want)
                    tol = TOL_FP32 if dt == torch.float32 else TOL_BF16
                    check(torch.allclose(got.float(), want.float(), **tol),
                          f"swin stage {si} masked={masked} {dt}: max abs "
                          f"err {err}")
                    (errs if dt == torch.float32 else errs16).append(err)
                    if path == "captioning":
                        # The bf16 softmax chain at every stage shape.
                        got = swin_attention(q, k, v, scale, bias, wm,
                                             torch.bfloat16)
                        torch.cuda.synchronize()
                        want = swin_attention_plain(q, k, v, scale, bias, wm,
                                                    torch.bfloat16)
                        c = chain_errors(got, want)
                        chain.append(dict(stage=si, masked=masked,
                                          dtype=dtype_name(dt), **c))
                        check(chain_ok(c), f"swin bf16 chain stage {si} "
                              f"masked={masked} {dt}: {c}")
                q, k, v = (torch.randn(Bn, H, SWIN_N, SWIN_D, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(3))
                ms, host = time_both(lambda: swin_attention(q, k, v, scale,
                                                            bias, wm))
                plain = time_ms(lambda: swin_attention_plain(
                    q, k, v, scale, bias, wm), 20)
                yard_fn = swin_yardstick(q, k, v, scale, bias, wm)
                yard = time_ms(yard_fn)
                nbytes = io_bytes(q, k, v, q, bias, scale, wm)
                flops = 4 * Bn * H * SWIN_N * SWIN_N * SWIN_D
                b, by = bound_ms(nbytes, flops, dtype_name(dtype))
                shapes.append(dict(
                    stage=si, path=path, shape=[Bn, H, SWIN_N, SWIN_D],
                    masked=masked, dtype=dtype_name(dtype), per_path=count,
                    ms=ms, host_ms=host, plain_ms=plain, library_ms=None,
                    yardstick_ms=yard,
                    yardstick=sdpa_backends(yard_fn), bound_ms=b,
                    bound_by=by, bytes=nbytes, flops=flops))
                print(f"swin {path} stage {si} Bn={Bn} H={H} masked={masked}"
                      f" {dtype_name(dtype)}: kernel {ms:.4f} ms, plain "
                      f"{plain:.4f} ms, yardstick (attention part only) "
                      f"{yard:.4f} ms, bound {b:.4f} ms ({by}) [{card}]")
    print(f"swin bf16 softmax chain vs plain: worst share outside the bf16 "
          f"tolerance {max(c['outside'] for c in chain):.2e}, worst mean "
          f"{max(c['mean'] for c in chain):.2e}, worst max "
          f"{max(c['max'] for c in chain):.4f} (tolerance share "
          f"{TOL_SWIN_BF16_CHAIN['outside']}, mean "
          f"{TOL_SWIN_BF16_CHAIN['mean']})")
    extra = check_swin_extra(gen)
    return dict(name="swin_attention_fwd",
                mode="cosine (SwinV2), fp32 and bf16 softmax chains",
                max_abs_err=max(errs), max_abs_err_bf16=max(errs16),
                bf16_chain=chain, extra_shapes=extra, shapes=shapes,
                library_note="none: no single PyTorch call computes it "
                             "(per-head clamped logit scale on L2-normalized"
                             " q and k; SDPA takes one scalar scale and no "
                             "normalization)")


def path_totals(entry: dict) -> None:
    """Sum each timing over one request's (captioning) or one training
    step's (training) launches of the kernel."""
    entry["paths"] = {}
    for path in ("captioning", "training"):
        sh = [s for s in entry["shapes"] if s["path"] == path]
        if not sh:
            continue
        tot = {k: sum(s[k] * s["per_path"] for s in sh)
               for k in ("ms", "plain_ms", "bound_ms")}
        for key in ("library_ms", "yardstick_ms"):
            vals = [s.get(key) for s in sh]
            tot[key] = (None if None in vals else
                        sum(s[key] * s["per_path"] for s in sh))
        t_bytes = sum(s["bytes"] * s["per_path"] for s in sh)
        t_ops = sum(s["flops"] * s["per_path"] / PEAK_FLOP_PER_S[s["dtype"]]
                    for s in sh)
        tot["bound_by"] = ("bytes" if t_bytes / PEAK_BYTES_PER_S >= t_ops
                           else "operations")
        tot["launches_per_path"] = sum(s["per_path"] for s in sh)
        entry["paths"][path] = tot


def print_path_totals(entry: dict, card: str) -> None:
    """Each path's total of a kernel beside that of the kernel it replaced
    (``OLD_PATH_MS``) and SDPA's or the Swin yardstick's, and, for the T5
    forward, kernel against plain at each training shape."""
    for path, tot in entry["paths"].items():
        per = "request" if path == "captioning" else "training step"
        old = OLD_PATH_MS.get((entry["name"], path))
        if tot["library_ms"] is not None:
            lib = f"sdpa {tot['library_ms']:.4f} ms"
        else:
            lib = (f"yardstick (attention part only) "
                   f"{tot['yardstick_ms']:.4f} ms")
        print(f"{entry['name']} per {per} ({tot['launches_per_path']} "
              f"launches): kernel {tot['ms']:.4f} ms"
              + (f" ({old[1]}: {old[0]} ms, {old[2]})" if old else "")
              + f", {lib}, plain {tot['plain_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}) [{card}]")
    if entry["name"] == "t5_attention_fwd":
        for s in entry["shapes"]:
            if s["path"] == "training":
                print(f"  {s['name']} {s['shape']} rate={s['rate']}: kernel "
                      f"{s['ms']:.4f} ms vs plain {s['plain_ms']:.4f} ms "
                      f"({s['plain_ms'] / s['ms']:.2f}x)")


# ---------------------------------------------------------------------------
# Phase 3: captioning at full width
# ---------------------------------------------------------------------------


def decoder_passes(ids) -> int:
    """Decoder passes the greedy loop made: it writes columns 1..step and
    stops at max_length - 1 or once every row has emitted eos (id 1)."""
    rows = ids.tolist()
    last = len(rows[0]) - 1
    if all(1 in r[1:] for r in rows):
        last = min(last, max(r.index(1, 1) for r in rows))
    return last


# The host ranges that phases 4-5 read apart in their profiles: the Swin
# backward (a recompute in plain PyTorch, SwinAttentionFn) and the
# optimizer's step.
SWIN_BWD_SPAN, OPT_SPAN = "SwinAttentionFnBackward", "Optimizer.step"


def profile_readings(prof, ranges) -> dict:
    """What ``profile_device`` reads from a finished ``torch.profiler``
    run, from the profiler's raw events: the device events that are no
    user annotation (kernels and copies: count, and per name count and ms)
    and the device-side annotations (ms per name), and for every host
    range whose name ``ranges(name)`` accepts, per name, its calls, host ms
    and the ms of the device events that it and the host ranges nested in
    it launched. These are ``key_averages()``'s ``count``,
    ``self_device_time_total``, ``cpu_time_total`` and
    ``device_time_total`` (``profile_against_averages`` holds them against
    it), without turning each event into a ``FunctionEvent``: on a step of
    ~10^4 kernels that takes the profiler's own reading 10-30 s of host
    time."""
    import bisect

    import torch
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels, annotations, wanted = {}, {}, []
    launched = {}  # a host event's correlation id: the device us it launched
    spans = {}  # per thread: (start, end, correlation id) of host events
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        name = _rewrite_name(name=name, with_wildcard=True)
        if e.device_type() == cuda:
            us = e.duration_ns() / 1e3
            if e.is_user_annotation():
                annotations[name] = annotations.get(name, 0.0) + us
                continue
            count, total = kernels.get(name, (0, 0.0))
            kernels[name] = (count + 1, total + us)
            link = e.linked_correlation_id()
            if link > 0:
                launched[link] = launched.get(link, 0.0) + us
            continue
        if e.device_type() != cpu:
            continue
        thread = e.start_thread_id()
        sync = not e.is_async() and thread == e.end_thread_id()
        if sync and e.linked_correlation_id() == 0:
            spans.setdefault(thread, []).append(
                (e.start_ns(), e.end_ns(), e.correlation_id()))
        if ranges(name):
            wanted.append((name, thread if sync else None, e.start_ns(),
                           e.end_ns()))
    for events in spans.values():
        events.sort()
    starts = {t: [ev[0] for ev in events] for t, events in spans.items()}
    host = {}
    for name, thread, t0, t1 in wanted:
        # The device time under a range: what the host events that lie
        # within it on its thread (itself among them) launched; none under
        # an asynchronous one.
        events = spans.get(thread, []) if thread is not None else []
        i = bisect.bisect_left(starts.get(thread, []), t0)
        dev = 0.0
        while i < len(events) and events[i][0] < t1:
            if events[i][1] <= t1:
                dev += launched.get(events[i][2], 0.0)
            i += 1
        calls, cpu_us, dev_us = host.get(name, (0, 0.0, 0.0))
        host[name] = (calls + 1, cpu_us + (t1 - t0) / 1e3, dev_us + dev)
    return dict(kernels=kernels, annotations=annotations, ranges=host)


def profile_against_averages(prof, got: dict, ranges) -> None:
    """``profile_readings``' ``got`` against ``key_averages()`` of the same
    run (the profiler's own reading, 10-30 s of host time on a step):
    printed side by side, and checked (kernel count and busy time, 1e-6
    relative)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    avg = prof.key_averages()
    ker = [e for e in avg if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)]
    want_n = sum(e.count for e in ker)
    want_busy = sum(e.self_device_time_total for e in ker)
    got_n = sum(c for c, _ in got["kernels"].values())
    got_busy = sum(us for _, us in got["kernels"].values())
    print(f"  profile read from raw events vs key_averages: device events "
          f"{got_n} vs {want_n}, busy {got_busy / 1e3:.6f} vs "
          f"{want_busy / 1e3:.6f} ms")
    for e in avg:
        if e.device_type != cuda and ranges(e.key):
            calls, cpu_us, dev_us = got["ranges"].get(e.key, (0, 0.0, 0.0))
            print(f"    {e.key[:60]}: calls {calls} vs {e.count}, host "
                  f"{cpu_us / 1e3:.3f} vs {e.cpu_time_total / 1e3:.3f} ms, "
                  f"device {dev_us / 1e3:.3f} vs "
                  f"{e.device_time_total / 1e3:.3f} ms")
    check(got_n == want_n and abs(got_busy - want_busy)
          <= 1e-6 * max(want_busy, 1.0),
          f"the profile's raw reading: {got_n} device events, "
          f"{got_busy:.3f} us; key_averages: {want_n}, {want_busy:.3f}")


def profile_device(fn, wall_ms: float, card: str, what: str,
                   spans: tuple[str, ...] = (),
                   collectives: bool = False,
                   against_averages: bool = False) -> dict:
    """One more run of ``fn`` under ``torch.profiler``: the device time of
    its kernels, their share of the (unprofiled) wall time, and the kernels
    that take most of it. The profiler slows the host, so the share is taken
    against the time measured without it. ``spans``: names of host ranges
    (an autograd node such as ``SwinAttentionFnBackward``, or
    ``Optimizer.step``) whose kernels' device time is read apart, under
    ``span_ms``: of the ranges whose name holds the span's, the largest
    total (a nested range of the same name holds no more); their host time
    under ``span_host_ms``, summed over the ranges of the largest name.
    ``collectives``: also the host and device time of the process group's
    collectives: the ranges of the backend's work (``gloo:`` or
    ``nccl:``, on gloo's own threads: host time there, and the device time
    of the copies they run), and the ``c10d::`` operators' calls.
    ``against_averages``: the reading also held against the profiler's own
    (``profile_against_averages``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def ranges(name: str) -> bool:
        return (any(span in name for span in spans) or (collectives and (
            name.startswith(("gloo:", "nccl:", "c10d::")))))

    # A host range opened by record_function (torch.optim's
    # "Optimizer.step#...") also leaves a device-side annotation that spans
    # its first to its last kernel, gaps included: it is no kernel, and
    # counting it would count its kernels twice.
    got = profile_readings(prof, ranges)
    if against_averages:
        profile_against_averages(prof, got, ranges)
    annotations = {k: us / 1e3 for k, us in got["annotations"].items()}
    busy_ms = sum(us for _, us in got["kernels"].values()) / 1e3
    if busy_ms == 0:
        print("device time: not measured (the profiler saw no device "
              "events)")
        return dict(busy_ms=None)
    top = sorted(got["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    span_ms, span_host_ms = {}, {}
    for span in spans:
        named = [(k, v) for k, v in got["ranges"].items() if span in k]
        widest = max(named, key=lambda kv: kv[1][2], default=None)
        span_ms[span] = widest[1][2] / 1e3 if widest else None
        span_host_ms[span] = (dict(calls=widest[1][0], name=widest[0],
                                   ms=widest[1][1] / 1e3)
                              if widest else None)
    out = dict(busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
               kernel_launches=sum(c for c, _ in got["kernels"].values()),
               top=[dict(name=k[:120], ms=us / 1e3, count=c)
                    for k, (c, us) in top], span_ms=span_ms,
               span_host_ms=span_host_ms, annotation_span_ms=annotations)
    if collectives:
        work = {k: v for k, v in got["ranges"].items()
                if k.startswith(("gloo:", "nccl:"))}
        out["collectives"] = dict(
            host_ms=sum(v[1] for v in work.values()) / 1e3,
            device_ms=sum(v[2] for v in work.values()) / 1e3,
            work={k: v[0] for k, v in work.items()},
            calls={k: v[0] for k, v in got["ranges"].items()
                   if k.startswith("c10d::")})
        print(f"  collectives: host {out['collectives']['host_ms']:.3f} ms, "
              f"device {out['collectives']['device_ms']:.3f} ms, calls "
              f"{out['collectives']['calls']}")
    print(f"device busy {busy_ms:.2f} ms of a {wall_ms:.2f} ms {what} "
          f"({100 * busy_ms / wall_ms:.1f}%), "
          f"{out['kernel_launches']} kernel launches [{card}]")
    for t in out["top"]:
        print(f"  {t['ms']:8.3f} ms  x{t['count']:<6d} {t['name']}")
    for key, ms in sorted(annotations.items(), key=lambda a: -a[1])[:8]:
        print(f"  (not in busy: the device-side annotation {key} spans "
              f"{ms:.3f} ms)")
    if len(annotations) > 8:
        print(f"  ({len(annotations) - 8} shorter device-side annotations "
              "not printed)")
    for span, ms in span_ms.items():
        host = span_host_ms[span]
        print(f"  device ms under {span}: "
              + ("not measured (no such range)" if ms is None
                 else f"{ms:.3f} ({100 * ms / busy_ms:.1f}% of busy); host "
                      f"{host['ms']:.3f} ms over {host['calls']} calls of "
                      f"{host['name']}"))
    return out


def caption(card: str) -> dict:
    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    t5_attention)
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                 seed=SEED)
    t0 = time.perf_counter()
    model = MultiModalModel(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(cfg.seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, built and initialized in "
          f"{build_s:.2f} s [{card}]")
    check(n_params > 1.1e9, f"full width expected, got {n_params} params")
    tok = ByteTokenizer()
    cap = Captioner(cfg, model, tok)
    rng = np.random.default_rng(SEED)
    size = cfg.swin.image_size
    requests = [rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)
                for _ in range(REQUESTS + 1)]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cap.caption(requests[0])  # warm-up: cuBLAS/cuDNN set-up, first builds
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    swin_attention.launches = 0
    t5_attention.launches = 0
    per_request, all_ids, texts = [], [], []
    for images in requests[1:]:
        s0, t0_count = swin_attention.launches, t5_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = cap.caption_launch(images)
        texts.append(cap.caption_finish(ids))  # reads back: synchronizes
        ms = (time.perf_counter() - t0) * 1e3
        n_swin = swin_attention.launches - s0
        n_t5 = t5_attention.launches - t0_count
        check(n_swin == 24, f"Swin kernel launches per request {n_swin}")
        check(n_t5 == 48, f"T5 kernel launches per request {n_t5}")
        check(tuple(ids.shape) == (BATCH, cfg.generate_max_length),
              f"token shape {tuple(ids.shape)}")
        check(bool((ids[:, 0] == 0).all()), "column 0 is the start token")
        check(bool(((ids >= 0) & (ids < cfg.transformer_t5.vocab_size))
                   .all()), "token ids in the vocabulary")
        per_request.append(dict(ms=ms, passes=decoder_passes(ids.cpu())))
        all_ids.append(ids)
    launches = dict(swin=swin_attention.launches, t5=t5_attention.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Encoder half alone, then through the same weights without kernels.
    images = requests[1]
    encode_ms = host_ms(lambda: cap._encode_prefill(images, None))
    enc, _ = cap._encode_prefill(images, None)
    check(tuple(enc.shape) == (BATCH, cfg.swin.num_patches_out + 32,
                               cfg.transformer_t5.d_model),
          f"encoder output shape {tuple(enc.shape)}")
    check(bool(torch.isfinite(enc).all()), "encoder output is finite")

    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False,
                                    use_pallas_t5_attention=False)
    plain_model = MultiModalModel(plain_cfg)
    plain_model.load_state_dict(model.state_dict(), strict=True)
    plain_cap = Captioner(plain_cfg, plain_model, tok)
    enc_plain, _ = plain_cap._encode_prefill(images, None)
    rel = float((enc - enc_plain).abs().max() / enc_plain.abs().max())
    print(f"encoder output, kernels vs none: max abs diff / max abs = "
          f"{rel:.3e} (tolerance {TOL_ENCODER_REL})")
    check(rel <= TOL_ENCODER_REL, f"encoder kernel-vs-plain rel diff {rel}")
    plain_ids = plain_cap.caption_launch(images)
    agree = float((plain_ids == all_ids[0]).float().mean())
    del plain_model, plain_cap

    mean_ms = sum(r["ms"] for r in per_request) / len(per_request)
    device = profile_device(
        lambda: cap.caption_finish(cap.caption_launch(images)), mean_ms,
        card, "request")
    decode_ms_per_token = sum(
        (r["ms"] - encode_ms) / r["passes"] for r in per_request) / len(
            per_request)
    result = dict(card=card, parameters=n_params, batch=BATCH,
                  requests=per_request, first_request_ms=first_ms,
                  request_ms=mean_ms, encode_ms=encode_ms,
                  decode_ms_per_token=decode_ms_per_token,
                  captions_per_s=BATCH / (mean_ms / 1e3),
                  peak_memory_gb=peak_gb, launches=launches,
                  encoder_rel_diff_vs_plain=rel,
                  token_agreement_vs_plain=agree, device=device,
                  sample_captions=texts[0][:2])
    print("captioning " + json.dumps(result))
    result["greedy_ids"] = [ids.tolist() for ids in all_ids]  # for phase 7
    return result


# ---------------------------------------------------------------------------
# Phase 4: training at full width
# ---------------------------------------------------------------------------


def train_batch(cfg, batch: int, seed: int) -> dict:
    """Seeded uint8 images, the COCO prompt padded to max_source_length
    with its mask, and seeded byte-tokenizer captions (random words of
    lowercase letters) padded to max_target_length."""
    import numpy as np

    from klab_multimodalmodel_tpu_torch.data.datasets import COCO_PROMPT
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    rng = np.random.default_rng(seed)
    tok = ByteTokenizer()
    size = cfg.swin.image_size
    src = tok([COCO_PROMPT] * batch, max_length=cfg.max_source_length)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    captions = [" ".join("".join(rng.choice(letters, rng.integers(2, 9)))
                         for _ in range(rng.integers(4, 16)))
                for _ in range(batch)]
    tgt = tok(captions, max_length=cfg.max_target_length)
    return dict(images=rng.integers(0, 256, (batch, size, size, 3),
                                    dtype=np.uint8),
                source_ids=src.input_ids, source_mask=src.attention_mask,
                target_ids=tgt.input_ids, target_mask=tgt.attention_mask)


def launch_counts() -> dict:
    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    t5_attention,
                                                    t5_attention_bwd)
    return dict(t5_fwd=t5_attention.launches,
                t5_fwd_dropout=t5_attention.launches_dropout,
                t5_bwd=t5_attention_bwd.launches,
                t5_bwd_dbias=t5_attention_bwd.launches_dbias,
                swin=swin_attention.launches)


def reset_counts() -> None:
    from klab_multimodalmodel_tpu_torch.ops import (swin_attention,
                                                    t5_attention,
                                                    t5_attention_bwd)
    t5_attention.launches = t5_attention.launches_dropout = 0
    t5_attention_bwd.launches = t5_attention_bwd.launches_dbias = 0
    swin_attention.launches = 0


def step_launches(text: int, enc: int, dec: int, dropout: bool = True,
                  towers: bool = True, backward: bool = True) -> dict:
    """The kernels' launches in one call of the cascade: the text tower's
    ``text`` layers (no dropout, no backward; skipped with the towers, from
    cached features), the transformer's ``enc`` self-attentions and
    ``dec`` self- and cross-attentions (at rate > 0 with ``dropout``; each
    with a backward, the self-attentions with dBias), the Swin tower's 24
    windows attentions (with the towers)."""
    fwd = enc + 2 * dec
    return dict(t5_fwd=fwd + (text if towers else 0),
                t5_fwd_dropout=fwd if dropout else 0,
                t5_bwd=fwd if backward else 0,
                t5_bwd_dbias=enc + dec if backward else 0,
                swin=24 if towers else 0)


STEP_LAUNCHES = step_launches(T5_LAYERS, T5_LAYERS, T5_LAYERS)
# Trainable parameters of phase 4's step: t5-large (shared embedding, both
# stacks) and the vision projection; phase 5a adds the SwinV2 tower's.
TRAINABLE_T5_PROJ = 738_716_672


def free() -> None:
    """Collect what the caller has dropped and return the card's cached
    blocks, so the next model starts from an empty card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def timed_steps(trainer, batch, gen, steps: int, expected: dict,
                what: str) -> tuple[list[float], list[float], dict]:
    """(step ms, losses, launches of one step): ``steps`` steps after the
    caller's warm-up, the launch counts set to 0 just before them and read
    just after, each step's launches checked against ``expected``."""
    import torch

    reset_counts()
    step_ms, losses = [], []
    for _ in range(steps):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        check(got == expected, f"{what}: launches in one step {got}, "
              f"expected {expected}")
    return step_ms, losses, got


def loss_and_grads(trainer, batch: dict) -> tuple[float, dict]:
    """Loss and trainable gradients of one deterministic (dropout off)
    forward and backward, no update."""
    import torch

    from klab_multimodalmodel_tpu_torch.data.image_ops import (
        normalize_images)
    model = trainer.model
    model.zero_grad(set_to_none=True)
    b = trainer.to_device(batch)
    images = normalize_images(b["images"], dtype=trainer.policy.compute_dtype)
    loss = model(images, b["source_ids"], b["target_ids"], b["source_mask"],
                 b["target_mask"], deterministic=True).loss
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def plain_backward_attention():
    """A stand-in for the model's ``t5_attention`` in the comparisons of
    phase 4: the forward kernel, then the plain backward
    (``t5_attention_bwd_plain``: the backward kernel's math and
    roundings)."""
    import torch

    from klab_multimodalmodel_tpu_torch.ops import (t5_attention_bwd_plain,
                                                    t5_attention_fwd)

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, bias_h, kmask, seed, rate, head_offset,
                    q_offset):
            out, _ = t5_attention_fwd(q, k, v, bias_h, kmask, rate, seed,
                                      head_offset=head_offset,
                                      q_offset=q_offset)
            ctx.rate, ctx.offsets = rate, (head_offset, q_offset)
            ctx.save_for_backward(q, k, v, bias_h, kmask, seed)
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, bias_h, kmask, seed = ctx.saved_tensors
            need_dbias = bias_h is not None and ctx.needs_input_grad[3]
            dq, dk, dv, dbias = t5_attention_bwd_plain(
                q, k, v, dout, bias_h, kmask, ctx.rate, seed, need_dbias,
                *ctx.offsets)
            return dq, dk, dv, dbias, None, None, None, None, None

    def attention(q, k, v, bias_h=None, kmask=None, dropout_rate=0.0,
                  seed=None, head_offset=0, q_offset=0):
        return Fn.apply(q, k, v, bias_h, kmask, seed, float(dropout_rate),
                        head_offset, q_offset)
    return attention


PATHS = {
    "kernels": (True, None, None),
    "plain_backward": (True, plain_backward_attention, None),
    "none": (False, None, None),
}


def path_grads(cfg, state: dict, compute_dtype: str, batch: dict,
               path: str) -> tuple[float, dict]:
    """Loss and trainable gradients on the weights ``state``, dropout off,
    in ``compute_dtype``, through ``PATHS[path]``."""
    import torch

    from klab_multimodalmodel_tpu_torch.models import t5
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    kernels, t5_attention, attention = PATHS[path]
    c = dataclasses.replace(cfg, compute_dtype=compute_dtype,
                            use_pallas_attention=kernels,
                            use_pallas_t5_attention=kernels)
    t = Trainer(c)
    t.init_state(state_dict=state)
    saved = t5.t5_attention, t5.dot_product_attention
    if t5_attention is not None:
        t5.t5_attention = t5_attention()
    if attention is not None:
        t5.dot_product_attention = attention()
    try:
        out = loss_and_grads(t, batch)
    finally:
        t5.t5_attention, t5.dot_product_attention = saved
    del t
    torch.cuda.empty_cache()
    return out


def agreement(a: tuple[float, dict], b: tuple[float, dict], what: str,
              tol: dict | None) -> dict:
    """Loss and per-tensor gradient agreement of run ``a`` against run
    ``b``; printed, and checked against ``tol`` unless it is None."""
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    check(grads_a.keys() == grads_b.keys(), "the same trainable tensors")
    loss_rel = abs(loss_a - loss_b) / abs(loss_b)
    worst_cos, worst_norm = (1.0, ""), (0.0, "")
    dot = na = nb = 0.0
    cosines, norms = {}, {}
    for n, ga in grads_a.items():
        # fp64 sums: fp32 ones over ~10^8 elements can put the cosine of
        # all tensors together above 1.
        gb = grads_b[n].double()
        ga = ga.double()
        d, x, y = float((ga * gb).sum()), float(ga.norm()), float(gb.norm())
        cos, norm = d / (x * y), abs(x / y - 1)
        check(math.isfinite(cos) and math.isfinite(norm),
              f"gradient of {n}: cosine {cos}, norm ratio off by {norm}")
        worst_cos = min(worst_cos, (cos, n))
        worst_norm = max(worst_norm, (norm, n))
        cosines[n], norms[n] = cos, y
        dot, na, nb = dot + d, na + x * x, nb + y * y
    total = dot / math.sqrt(na * nb)
    # How many tensors fall under cosine 0.99, and how large the worst one's
    # gradient is beside the largest (a small gradient that cancels over
    # many positions moves most under a change of rounding).
    below = sum(c < 0.99 for c in cosines.values())
    worst_share = norms[worst_cos[1]] / max(norms.values())
    tols = ("not checked" if tol is None else
            f"tolerances: loss {TOL_TRAIN_LOSS_REL}, cosine >= "
            f"{tol['cosine']}, norm {tol['norm']}, all >= {tol['total']}")
    print(f"training, {what} (batch {CMP_BATCH}, dropout off): loss "
          f"{loss_a:.6f} vs {loss_b:.6f}, rel {loss_rel:.2e}; worst "
          f"gradient cosine {worst_cos[0]:.6f} ({worst_cos[1]}, its gradient's"
          f" norm {worst_share:.2e} of the largest); {below} tensors under "
          f"cosine 0.99; worst norm ratio off by {worst_norm[0]:.2e} "
          f"({worst_norm[1]}); all {len(grads_a)} tensors together: cosine "
          f"{total:.6f} ({tols})")
    if tol is not None:
        check(loss_rel <= TOL_TRAIN_LOSS_REL,
              f"{what}: loss rel diff {loss_rel}")
        check(worst_cos[0] >= tol["cosine"],
              f"{what}: gradient cosine {worst_cos}")
        check(worst_norm[0] <= tol["norm"],
              f"{what}: gradient norm {worst_norm}")
        check(total >= tol["total"],
              f"{what}: gradient cosine of all tensors {total}")
    return dict(loss_a=loss_a, loss_b=loss_b, loss_rel=loss_rel,
                worst_cosine=worst_cos, worst_norm_rel=worst_norm,
                total_cosine=total, tolerance=tol, under_0_99=below,
                worst_cosine_norm_share=worst_share)


def compare_paths(cfg, state: dict, batch: dict) -> dict:
    """Kernels against none on the weights ``state`` in fp32 compute; in
    bf16 compute the kernels against the forward kernel with the plain
    backward, then against none (see TOL_TRAIN_GRAD)."""
    out = {}
    kernels = path_grads(cfg, state, "float32", batch, "kernels")
    none = path_grads(cfg, state, "float32", batch, "none")
    out["float32"] = dict(kernels_vs_none=agreement(
        kernels, none, "float32, kernels vs none", TOL_TRAIN_GRAD))
    del kernels, none
    runs = {p: path_grads(cfg, state, "bfloat16", batch, p) for p in PATHS}
    bf16 = {}
    for a, b, tol in (
            ("kernels", "plain_backward", TOL_TRAIN_GRAD),
            ("kernels", "none", TOL_TRAIN_GRAD_BF16_VS_NONE)):
        bf16[f"{a}_vs_{b}"] = agreement(runs[a], runs[b],
                                        f"bfloat16, {a} vs {b}", tol)
    out["bfloat16"] = bf16
    return out


def train(card: str) -> dict:
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                 seed=SEED)
    check(cfg.compute_dtype == "bfloat16" and cfg.lr == 1e-3
          and cfg.lr_scheduler == "" and not cfg.image_model_train,
          "the reference caption recipe's Config defaults")
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    model = trainer.init_state(
        torch.Generator(device="cuda").manual_seed(cfg.seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"training model: {n_params} parameters, {n_train} trainable, "
          f"built in {time.perf_counter() - t0:.2f} s [{card}]")
    check(n_train > 7e8, f"trainable t5-large expected, got {n_train}")
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    relpos = {s: getattr(model.transformer, s).relative_attention_bias
              .weight.detach().clone() for s in ("encoder", "decoder")}
    batch = train_batch(cfg, TRAIN_BATCH, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(trainer.train_step(batch, gen))]  # warm-up step
    first_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    step_ms, timed, _ = timed_steps(trainer, batch, gen, STEPS, STEP_LAUNCHES,
                                    "training step")
    losses += timed
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"losses (warm-up, then {STEPS} steps, dropout on): "
          + ", ".join(f"{x:.4f}" for x in losses))
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for n, p in model.named_parameters():
        if n in frozen:
            check(torch.equal(p, frozen[n]), f"frozen {n} changed")
    for s, w in relpos.items():
        moved = float((getattr(model.transformer, s).relative_attention_bias
                       .weight.detach() - w).abs().max())
        print(f"{s} relative_attention_bias moved by {moved:.3e}")
        check(moved > 0, f"{s} relative_attention_bias did not move")
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"train step: {mean_ms:.2f} ms mean over {STEPS} "
          f"({', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{TRAIN_BATCH / (mean_ms / 1e3):.2f} images/s, first step "
          f"{first_ms:.2f} ms, peak memory {peak_gb:.2f} GB [{card}]")
    device = profile_device(lambda: trainer.train_step(batch, gen), mean_ms,
                            card, "training step", (OPT_SPAN,))

    # Kernels against none (and, in bf16, against the plain backward):
    # batch 8, dropout off, the same weights, in fp32 and in bf16 compute.
    cmp_batch = train_batch(cfg, CMP_BATCH, SEED + 2)
    state = model.state_dict()
    vs_plain = compare_paths(cfg, state, cmp_batch)
    result = dict(card=card, parameters=n_params, trainable=n_train,
                  batch=TRAIN_BATCH, losses=losses, first_step_ms=first_ms,
                  step_ms=step_ms, mean_step_ms=mean_ms,
                  images_per_s=TRAIN_BATCH / (mean_ms / 1e3),
                  peak_memory_gb=peak_gb, launches=launches,
                  launches_per_step=STEP_LAUNCHES, device=device,
                  vs_plain=vs_plain)
    print("training " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# Phase 5: the train_with_swin recipe and the training options
# ---------------------------------------------------------------------------

OPTION_STEPS = 3
# Phase 5c's runs: the _tpu_fast recipes' storage, Adafactor, and the two
# remat policies, each with the frozen towers and both kernel flags on.
OPTIONS = {
    "bf16 frozen towers + bf16 Adam mu": dict(frozen_param_dtype="bfloat16",
                                              adam_mu_dtype="bfloat16"),
    "adafactor": dict(optimizer="adafactor"),
    "remat full": dict(remat="full"),
    "remat dots_saveable": dict(remat="dots_saveable"),
}
# Under remat each of the transformer's 72 attention calls runs its forward
# kernel again in the backward's recompute, at the same rate.
REMAT_LAUNCHES = dict(STEP_LAUNCHES, t5_fwd=96 + 72, t5_fwd_dropout=72 + 72)


def train_swin(card: str) -> tuple[dict, dict]:
    """5a: the train_with_swin recipe at full width, the SwinV2 tower
    trainable, both kernel flags on, batch 32, bf16. Returns the results
    and the trained weights (a state dict on the card) for 5b."""
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    cfg = Config(image_model_train=True, use_pallas_attention=True,
                 use_pallas_t5_attention=True, seed=SEED)
    trainer = Trainer(cfg)
    model = trainer.init_state(
        torch.Generator(device="cuda").manual_seed(cfg.seed))
    n_swin = sum(p.numel() for p in model.image_model.parameters())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"train_with_swin model: {n_train} trainable parameters, "
          f"{n_swin} of them the SwinV2 tower's [{card}]")
    check(n_train == TRAINABLE_T5_PROJ + n_swin and 8e7 < n_swin < 9e7,
          f"trainable t5-large + projection + SwinV2-base expected, got "
          f"{n_train} ({n_swin} Swin)")
    text = {n: p.detach().clone()
            for n, p in model.language_model.named_parameters()}
    swin = {n: p.detach().clone()
            for n, p in model.image_model.named_parameters()}
    batch = train_batch(cfg, TRAIN_BATCH, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = float(trainer.train_step(batch, gen))  # warm-up step
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = timed_steps(trainer, batch, gen, STEPS,
                                            STEP_LAUNCHES, "train_with_swin")
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [first] + losses
    print(f"train_with_swin losses (warm-up, then {STEPS} steps, dropout "
          f"on): " + ", ".join(f"{x:.4f}" for x in losses))
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for n, p in model.language_model.named_parameters():
        check(torch.equal(p, text[n]), f"text tower {n} changed")
    moved = {n: float((p.detach() - swin[n]).abs().max())
             for n, p in model.image_model.named_parameters()}
    still = [n for n, m in moved.items() if m == 0]
    check(not still, f"Swin tensors that did not move: {still}")
    print(f"every SwinV2 tensor moved ({len(moved)}), the least by "
          f"{min(moved.values()):.3e} "
          f"({min(moved, key=moved.get)}); the text tower is unchanged")
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"train_with_swin step: {mean_ms:.2f} ms mean over {STEPS} "
          f"({', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{TRAIN_BATCH / (mean_ms / 1e3):.2f} images/s, first step "
          f"{first_ms:.2f} ms, peak memory {peak_gb:.2f} GB [{card}]")
    device = profile_device(lambda: trainer.train_step(batch, gen), mean_ms,
                            card, "train_with_swin step",
                            (SWIN_BWD_SPAN, OPT_SPAN))
    state = model.state_dict()
    del trainer, model, text, swin
    free()
    result = dict(card=card, trainable=n_train, swin_parameters=n_swin,
                  batch=TRAIN_BATCH, losses=losses, first_step_ms=first_ms,
                  step_ms=step_ms, mean_step_ms=mean_ms,
                  images_per_s=TRAIN_BATCH / (mean_ms / 1e3),
                  peak_memory_gb=peak_gb, launches=launches,
                  launches_per_step=per_step, device=device,
                  swin_backward_ms=device.get("span_ms", {}).get(
                      SWIN_BWD_SPAN),
                  least_swin_move=min(moved.values()))
    return result, state


def swin_kernel_vs_none(state: dict) -> dict:
    """5b: batch 8, dropout off, the 5a weights: the loss and every SwinV2
    gradient with the Swin kernel against the same path without it (the T5
    kernels on in both), checked at phase 4's tolerances in fp32 compute
    and printed beside them in bf16 compute. The two paths differ by
    design in bf16: the one without the kernel (as the JAX package's)
    rounds q̂ and k̂ to bf16 before their product, the kernel's recompute
    (as the JAX package's) keeps them fp32. A third bf16 run, the path
    without the kernel with its attention replaced by
    ``swin_attention_reference``, tells whether the gap comes from that
    difference or from bf16 rounding at large."""
    from klab_multimodalmodel_tpu_torch.config import Config

    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    cfg = Config(image_model_train=True, use_pallas_attention=True,
                 use_pallas_t5_attention=True, seed=SEED)
    batch = train_batch(cfg, CMP_BATCH, SEED + 3)
    out = {}
    for dtype, tol in (("float32", TOL_TRAIN_GRAD), ("bfloat16", None)):
        # One model a dtype: the runs without the Swin kernel turn its flag
        # off on the same weights.
        trainer = Trainer(dataclasses.replace(cfg, compute_dtype=dtype))
        trainer.init_state(state_dict=state)
        runs = {flag: swin_grads(trainer, batch, flag)
                for flag in (True, False)}
        out[dtype] = agreement(runs[True], runs[False],
                               f"{dtype}, SwinV2 gradients, Swin kernel vs "
                               "none", tol)
        if dtype == "bfloat16":
            runs["fp32_qk"] = swin_grads(trainer, batch, False, fp32_qk=True)
        del trainer
        free()
    out["bfloat16_vs_fp32_qk"] = agreement(
        runs[True], runs["fp32_qk"], "bfloat16, SwinV2 gradients, Swin "
        "kernel vs none with fp32 q-hat and k-hat", None)
    out["bfloat16_none_vs_fp32_qk"] = agreement(
        runs[False], runs["fp32_qk"], "bfloat16, SwinV2 gradients, none vs "
        "none with fp32 q-hat and k-hat", None)
    return out


def swin_grads(trainer, batch: dict, kernel: bool,
               fp32_qk: bool = False) -> tuple[float, dict]:
    """Loss and the SwinV2 tower's gradients of one deterministic forward
    and backward of ``trainer``'s model, with the Swin kernel or without
    it (its window attentions' flag off for the call); with ``fp32_qk``
    the path without the Swin kernel attends through
    ``swin_attention_reference`` (see ``swin_kernel_vs_none``)."""
    from klab_multimodalmodel_tpu_torch.models import swinv2
    from klab_multimodalmodel_tpu_torch.ops import swin_attention_reference

    windows = [m for m in trainer.model.image_model.modules()
               if isinstance(m, swinv2.WindowAttention)]
    saved = swinv2.WindowAttention._reference_attention
    if fp32_qk:
        swinv2.WindowAttention._reference_attention = (
            lambda self, q, k, v, scale, bias_h, mask:
            swin_attention_reference(q, k, v, scale, bias_h, mask,
                                     self.softmax_dtype))
    for m in windows:
        m.use_pallas = kernel
    try:
        loss, grads = loss_and_grads(trainer, batch)
    finally:
        swinv2.WindowAttention._reference_attention = saved
        for m in windows:
            m.use_pallas = True
    return loss, {n: g for n, g in grads.items()
                  if n.startswith("image_model.")}


def train_options(card: str, phase4: dict) -> dict:
    """5c: three timed steps of each of ``OPTIONS`` at batch 32 with the
    frozen towers and both kernel flags on, beside phase 4's step: step ms,
    the optimizer's device time (profile) and peak memory."""
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    dev4 = phase4["device"]
    rows = {"phase 4 (fp32 frozen towers, Adam)": dict(
        mean_step_ms=phase4["mean_step_ms"],
        peak_memory_gb=phase4["peak_memory_gb"],
        optimizer_ms=dev4.get("span_ms", {}).get(OPT_SPAN),
        optimizer_span_ms=optimizer_span(dev4),
        busy_ms=dev4.get("busy_ms"))}
    for name, overrides in OPTIONS.items():
        cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                     seed=SEED, **overrides)
        trainer = Trainer(cfg)
        model = trainer.init_state(
            torch.Generator(device="cuda").manual_seed(cfg.seed))
        if cfg.frozen_param_dtype == "bfloat16":
            check(all(p.dtype == torch.bfloat16 for n, p in
                      model.named_parameters() if not p.requires_grad),
                  f"{name}: frozen parameters in bf16")
        batch = train_batch(cfg, TRAIN_BATCH, SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        first = float(trainer.train_step(batch, gen))  # warm-up step
        torch.cuda.reset_peak_memory_stats()
        expected = REMAT_LAUNCHES if cfg.remat else STEP_LAUNCHES
        step_ms, losses, per_step = timed_steps(
            trainer, batch, gen, OPTION_STEPS, expected, name)
        losses = [first] + losses
        check(all(math.isfinite(x) for x in losses),
              f"{name}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{name}: loss did not fall {losses}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        mean_ms = sum(step_ms) / len(step_ms)
        print(f"{name}: losses " + ", ".join(f"{x:.4f}" for x in losses)
              + f"; step {mean_ms:.2f} ms ({', '.join(f'{t:.2f}' for t in step_ms)}),"
              f" peak memory {peak_gb:.2f} GB, launches per step {per_step} "
              f"[{card}]")
        device = profile_device(lambda: trainer.train_step(batch, gen),
                                mean_ms, card, f"{name} step", (OPT_SPAN,))
        rows[name] = dict(mean_step_ms=mean_ms, step_ms=step_ms,
                          peak_memory_gb=peak_gb, losses=losses,
                          optimizer_ms=device.get("span_ms", {}).get(
                              OPT_SPAN),
                          optimizer_span_ms=optimizer_span(device),
                          busy_ms=device.get("busy_ms"),
                          launches_per_step=per_step)
        del trainer, model
        free()
    print(f"training options, batch {TRAIN_BATCH}, bf16 compute, "
          f"{OPTION_STEPS} timed steps each [{card}]:")
    print("  (optimizer: its kernels' device time and their share of busy;"
          " span: first to last of its kernels on the device, gaps "
          "included)")
    print(f"  {'run':40s} {'step ms':>9s} {'busy ms':>9s} "
          f"{'optimizer ms (share)':>21s} {'span ms':>9s} {'peak GB':>8s}")
    for name, r in rows.items():
        opt, busy, span = (r["optimizer_ms"], r["busy_ms"],
                           r["optimizer_span_ms"])
        opt_txt = ("not measured" if opt is None or not busy
                   else f"{opt:.3f} ({100 * opt / busy:.1f}%)")
        busy_txt = "not measured" if busy is None else f"{busy:.2f}"
        span_txt = "not measured" if span is None else f"{span:.2f}"
        print(f"  {name:40s} {r['mean_step_ms']:9.2f} {busy_txt:>9s} "
              f"{opt_txt:>21s} {span_txt:>9s} {r['peak_memory_gb']:8.2f}")
    return rows


def optimizer_span(device: dict):
    """The device-side span of the optimizer's step in a profile (see
    ``profile_device``), or None."""
    spans = [ms for key, ms in device.get("annotation_span_ms", {}).items()
             if key.startswith(OPT_SPAN)]
    return spans[0] if spans else None


# ---------------------------------------------------------------------------
# Phase 6: the training loop at full width
# ---------------------------------------------------------------------------

# The synthetic dataset's 64 rows at batch 32: two updates and two
# validation batches an epoch; phase 10b halts after update 3 (epoch 2,
# cursor 1).
LOOP_ROWS, LOOP_EPOCHS, LOOP_HALT = 64, 2, 3
LOOP_UPDATES = LOOP_EPOCHS * LOOP_ROWS // TRAIN_BATCH
# Launches of one call of each step kind that train() makes: a full step
# (images through both towers), a step from cached tower features (the
# towers skipped: no Swin launch, no text-tower launch), and the two kinds of
# validation batch (dropout off, no backward).
def loop_launches(layers: int = T5_LAYERS, dropout: bool = True) -> dict:
    """``LOOP_LAUNCHES`` of a transformer of ``layers`` + ``layers`` blocks
    behind the full text tower."""
    return {
        "full step": step_launches(T5_LAYERS, layers, layers, dropout),
        "cached step": step_launches(T5_LAYERS, layers, layers, dropout,
                                     towers=False),
        "full eval": step_launches(T5_LAYERS, layers, layers, False,
                                   backward=False),
        "cached eval": step_launches(T5_LAYERS, layers, layers, False,
                                     towers=False, backward=False),
    }


LOOP_LAUNCHES = loop_launches()


class LoopRecorder:
    """Wraps the ``Trainer``'s four step methods, and the host calls of the
    loop that ``HOST`` names, while phase 6 drives ``train()``. Per step
    call: its kind, its launches (the counts before and after it), its span
    on the device (CUDA events around it, read after the run: nothing
    synchronizes inside it), its host time and its peak memory.
    ``profile``: {kind: (n, wall_ms)} runs the n-th call of that kind under
    the profiler (``profile_device``), with a synchronize before it, its
    busy share taken against ``wall_ms`` (None: the mean span of the kind's
    calls before it). ``host_ms`` / ``host_calls``: host time and calls of
    each ``HOST`` entry; ``data wait`` is the time the loop waited for the
    loader's next batch. ``expected``: the launches of one call of each
    kind (``LOOP_LAUNCHES``); ``label`` and ``spans`` name the profile and
    the host ranges read apart in it. Each train step's loss is kept (read
    after the run)."""

    METHODS = ("train_step", "train_step_with_features", "eval_step",
               "eval_step_with_features")
    # label: (module, class, method)
    HOST = {
        "to_device": ("train.trainer", "Trainer", "to_device"),
        "fill: start the copy": ("train.trainer", "Trainer", "copy_to_host"),
        "fill: wait for the copy": ("train.trainer", "HostCopy", "wait"),
        "fill: write the cache": ("train.feature_cache",
                                  "FrozenFeatureCache", "put"),
        "cache read": ("train.feature_cache", "FrozenFeatureCache", "get"),
        "cache flush": ("train.feature_cache", "FrozenFeatureCache",
                        "flush"),
        "epoch close (loss sync)": ("obs.metrics", "LossCounter",
                                    "count_and_get_loss"),
        "checkpoint save (stall)": ("checkpoint.io", "CheckpointManager",
                                    "save"),
        "checkpoint wait": ("checkpoint.io", "CheckpointManager", "wait"),
        "checkpoint restore": ("checkpoint.io", "CheckpointManager",
                               "restore"),
    }

    def __init__(self, card: str, profile: dict | None = None,
                 expected: dict | None = None, label: str = "phase-6",
                 spans: tuple[str, ...] = ()):
        self.card = card
        self.profile = profile or {}
        self.expected = expected or LOOP_LAUNCHES
        self.label, self.spans = label, spans
        self.calls: list[dict] = []
        self.profiles: dict = {}
        self.host_ms = {k: 0.0 for k in [*self.HOST, "data wait"]}
        self.host_calls = dict.fromkeys(self.host_ms, 0)

    def __enter__(self):
        import importlib

        from klab_multimodalmodel_tpu_torch.data.pipeline import DataLoader
        from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

        self._saved = [(Trainer, n, getattr(Trainer, n))
                       for n in self.METHODS]
        for name in self.METHODS:
            setattr(Trainer, name, self._step(name, getattr(Trainer, name)))
        for label, (mod, cls_name, name) in self.HOST.items():
            cls = getattr(importlib.import_module(
                f"klab_multimodalmodel_tpu_torch.{mod}"), cls_name)
            self._saved.append((cls, name, getattr(cls, name)))
            setattr(cls, name, self._timed(getattr(cls, name), label))
        self._saved.append((DataLoader, "iter_from", DataLoader.iter_from))
        DataLoader.iter_from = self._timed_iter(DataLoader.iter_from)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)

    def _add(self, label: str, t0: float) -> None:
        self.host_ms[label] += (time.perf_counter() - t0) * 1e3
        self.host_calls[label] += 1

    def _timed(self, orig, label: str):
        rec = self

        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                rec._add(label, t0)
        return call

    def _timed_iter(self, orig):
        rec = self

        def iter_from(loader, start_batch):
            it = orig(loader, start_batch)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    rec._add("data wait", t0)
                yield item
        return iter_from

    def _step(self, name: str, orig):
        import torch

        rec = self

        def call(trainer, batch, *args):
            kind = (("cached " if "image_features" in batch else "full ")
                    + ("eval" if name.startswith("eval") else "step"))
            n = 1 + sum(c["kind"] == kind for c in rec.calls)
            profiled = rec.profile.get(kind, (0, 0))[0] == n
            before = launch_counts()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            box = {}
            if profiled:
                torch.cuda.synchronize()
                wall = rec.profile[kind][1]
                if wall is None:  # the mean span of this kind's calls so far
                    spans = [c["events"][0].elapsed_time(c["events"][1])
                             for c in rec.calls if c["kind"] == kind
                             and not c["profiled"]]
                    wall = sum(spans) / len(spans)
                rec.profiles[kind] = profile_device(
                    lambda: box.setdefault("out", orig(trainer, batch, *args)),
                    wall, rec.card, f"{rec.label} {kind}", rec.spans)
            else:
                t0 = time.perf_counter()
                start.record()
                box["out"] = orig(trainer, batch, *args)
                end.record()
                host = (time.perf_counter() - t0) * 1e3
            after = launch_counts()
            out = box["out"]
            loss = out[0] if isinstance(out, tuple) else out
            rec.calls.append(dict(
                kind=kind, profiled=profiled, events=(start, end),
                loss=loss.detach() if kind.endswith("step") else None,
                host_ms=None if profiled else host,
                launches={k: after[k] - before[k] for k in after},
                peak_gb=torch.cuda.max_memory_allocated() / 1e9))
            return box["out"]
        return call

    def summary(self) -> dict:
        """Per kind: calls, mean device span (profiled calls left out),
        peak memory, and the launches of one call, each call's checked."""
        import torch

        torch.cuda.synchronize()
        out = {}
        for c in self.calls:
            check(c["launches"] == self.expected[c["kind"]],
                  f"train() {c['kind']}: launches {c['launches']}, expected "
                  f"{self.expected[c['kind']]}")
            k = out.setdefault(c["kind"], dict(calls=0, span_ms=[],
                                               host_ms=[], peak_gb=0.0))
            k["calls"] += 1
            k["launches"] = c["launches"]
            k["peak_gb"] = max(k["peak_gb"], c["peak_gb"])
            if not c["profiled"]:
                k["span_ms"].append(c["events"][0].elapsed_time(
                    c["events"][1]))
                k["host_ms"].append(c["host_ms"])
        for k in out.values():
            k["mean_span_ms"] = (sum(k["span_ms"]) / len(k["span_ms"])
                                 if k["span_ms"] else None)
        return out

    def step_losses(self) -> list[float]:
        """Each train step's returned loss, in order."""
        return [float(c["loss"]) for c in self.calls
                if c["loss"] is not None]


def loop_determinism(cfg, card: str) -> dict:
    """One training step twice from the same state and generator (the
    first batch of the loop's epoch 1): loss, gradients and updated
    parameters bitwise equal, or the gap that sets the resume check's
    tolerance."""
    import torch

    from klab_multimodalmodel_tpu_torch.data import get_dataloader
    from klab_multimodalmodel_tpu_torch.text import load_tokenizer
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    loader = get_dataloader(cfg, "train", load_tokenizer(""))
    loader.set_epoch(1)
    batch = next(iter(loader))
    batch.pop("index")
    trainer = Trainer(cfg, num_epochs=LOOP_EPOCHS)
    runs = []
    for _ in range(2):
        model = trainer.init_state()
        gen = torch.Generator(device=trainer.device).manual_seed(
            cfg.seed + 1)
        loss = trainer.train_step(batch, gen)
        runs.append(dict(
            loss=float(loss),
            grads={n: p.grad.detach().clone() for n, p in
                   model.named_parameters() if p.grad is not None},
            params={n: p.detach().clone() for n, p in
                    model.named_parameters() if p.requires_grad}))
    a, b = runs
    gap = dict(loss=abs(a["loss"] - b["loss"]),
               grads=max(max_err(a["grads"][n], b["grads"][n])
                         for n in a["grads"]),
               params=max(max_err(a["params"][n], b["params"][n])
                          for n in a["params"]))
    differing = sorted(n for n in a["grads"]
                       if not torch.equal(a["grads"][n], b["grads"][n]))
    bitwise = not differing and gap["loss"] == 0 and gap["params"] == 0
    print(f"determinism: one step twice from the same state and generator: "
          + ("bitwise equal" if bitwise else
             f"differ by loss {gap['loss']:.3e}, gradients "
             f"{gap['grads']:.3e}, parameters {gap['params']:.3e}; "
             f"{len(differing)} gradients differ, e.g. {differing[:5]}")
          + f" ({len(a['grads'])} gradients) [{card}]")
    del trainer, model, runs, a, b
    free()
    return dict(bitwise=bitwise, gap=gap, differing=differing)


def loop_run(cfg, card: str, what: str, profile=None, phase: str = "6",
             device=None, expected: dict | None = None,
             spans: tuple[str, ...] = ()):
    """``train(cfg, device=device)`` under a ``LoopRecorder``, the launch
    counts set to 0 just before it and read just after: (result, train()'s
    summary)."""
    from klab_multimodalmodel_tpu_torch.train import train

    reset_counts()
    t0 = time.perf_counter()
    with LoopRecorder(card, profile, expected, f"phase-{phase}",
                      spans) as rec:
        out = train(cfg, device=device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    steps = rec.summary()
    print(f"phase {phase} run {what}: {seconds:.2f} s, {out['steps']} updates, "
          f"halted {out['halted']}, losses {out['losses']}, min_val_loss "
          f"{out['min_val_loss']} [{card}]")
    for kind, k in steps.items():
        span = ("not measured" if k["mean_span_ms"] is None
                else f"{k['mean_span_ms']:.2f}")
        print(f"  {kind}: {k['calls']} calls, device span {span} ms mean "
              f"({', '.join(f'{t:.2f}' for t in k['span_ms'])}), host "
              f"({', '.join(f'{t:.2f}' for t in k['host_ms'])}) ms, peak "
              f"{k['peak_gb']:.2f} GB, launches {k['launches']}")
    print("  host ms (calls): " + ", ".join(
        f"{label} {ms:.2f} ({rec.host_calls[label]})"
        for label, ms in rec.host_ms.items() if rec.host_calls[label]))
    for save in out["saves"]:
        print(f"  save {save['name']}: {save['bytes'] / 1e9:.3f} GB, loop "
              f"stall {save['stall_s']:.3f} s, background write "
              f"{save.get('write_s', float('nan')):.3f} s")
    metrics = [json.loads(line) for line in
               open(os.path.join(cfg.result_dir, "metrics.jsonl"))]
    for row in metrics:
        print(f"  epoch {row['epoch']}: {row['img_per_sec']} images/s over "
              f"{row['epoch_seconds']} s (train {row['train_loss']:.6f}, "
              f"val {row['val_loss']:.6f})")
    result = dict(seconds=seconds, steps=int(out["steps"]),
                  step_losses=rec.step_losses(),
                  halted=out["halted"], losses=out["losses"],
                  min_val_loss=out["min_val_loss"], step_kinds=steps,
                  profiles=rec.profiles, saves=out["saves"],
                  metrics=metrics, launches=launches, host_ms=rec.host_ms,
                  host_calls=rec.host_calls)
    return result, out


def same(a, b, tol: float) -> bool:
    """Equal, or within ``tol`` where the determinism reading found a
    gap."""
    return a == b if tol == 0 else abs(a - b) <= tol


def loop_phase(card: str) -> dict:
    """Phase 6: ``train(config)`` at full width on the synthetic dataset, two
    runs: A uncached; C with the frozen-feature cache. Holds C's losses to
    A's. (The halt-and-resume runs moved to phase 10b, which resumes two
    ranks bitwise from a halt.)"""
    import shutil
    import tempfile

    import torch

    from klab_multimodalmodel_tpu_torch.config import Config

    root = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        print(f"phase 6: {free_gb:.1f} GB free on the disk of {root}")
        base = dict(use_pallas_attention=True, use_pallas_t5_attention=True,
                    seed=SEED, data_dir="synthetic", batch_size=TRAIN_BATCH,
                    num_epochs=LOOP_EPOCHS)
        cfg = Config(**base)
        check(cfg.compute_dtype == "bfloat16" and cfg.lr == 1e-3
              and not cfg.image_model_train
              and cfg.transformer_t5.dropout_rate == RATE,
              "the reference caption recipe's Config defaults")
        det = loop_determinism(cfg, card)
        tol_loss = det["gap"]["loss"]

        def config(tag, **kw):
            return Config(**base, result_dir=os.path.join(root, tag), **kw)

        a, out = loop_run(config("A"), card, "A (uncached)",
                            profile={"full step": (4, None)})
        del out
        free()
        shutil.rmtree(os.path.join(root, "A"))

        c, out = loop_run(config("C", cache_frozen_features=True), card,
                            "C (cache_frozen_features)",
                            profile={"cached step": (2, None)})
        check(not c["halted"] and c["steps"] == LOOP_UPDATES,
              f"C halted {c['halted']} after {c['steps']} updates")
        del out
        free()
        cdir = os.path.join(root, "C")
        for tag in ("train", "val"):
            for kind in ("img", "lang"):
                for suffix in ("", ".mask.npy", ".meta.json"):
                    path = os.path.join(cdir, "feature_cache",
                                        f"{tag}.{kind}.feat{suffix}")
                    check(os.path.exists(path), f"{path} missing")
        check(len(c["metrics"]) == LOOP_EPOCHS,
              f"metrics.jsonl: {len(c['metrics'])} lines")
        for phase in ("train", "val"):
            for x, y in zip(c["losses"][phase], a["losses"][phase]):
                check(same(x, y, tol_loss), f"cached {phase} losses "
                      f"{c['losses'][phase]} vs uncached {a['losses'][phase]}")
        shutil.rmtree(cdir)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    full, fill = a["step_kinds"]["full step"], c["step_kinds"]["full step"]
    cached = c["step_kinds"]["cached step"]
    saves = a["saves"] + c["saves"]
    fills = c["host_calls"]["fill: wait for the copy"]
    fill_ms = (c["host_ms"]["fill: wait for the copy"]
               + c["host_ms"]["fill: write the cache"]) / max(fills, 1)
    busy = (a["profiles"]["full step"].get("busy_ms"),
            c["profiles"]["cached step"].get("busy_ms"))
    print(f"phase 6 [{card}]: device span per step: full {full['mean_span_ms']:.2f}"
          f" ms (A), full with the cache's fill {fill['mean_span_ms']:.2f} ms "
          f"(C, epoch 1), cached {cached['mean_span_ms']:.2f} ms (C, epoch "
          f"2); device busy of one profiled full / cached step {busy[0]} / "
          f"{busy[1]} ms; peak memory {full['peak_gb']:.2f} / "
          f"{cached['peak_gb']:.2f} GB; images/s by epoch, C: "
          f"{[r['img_per_sec'] for r in c['metrics']]}, A: "
          f"{[r['img_per_sec'] for r in a['metrics']]}; the deferred fill "
          f"blocks the host {fill_ms:.3f} ms per full step; checkpoint "
          f"{saves[0]['bytes'] / 1e9:.3f} GB, loop stall "
          f"{min(s['stall_s'] for s in saves):.3f}-"
          f"{max(s['stall_s'] for s in saves):.3f} s, background write "
          f"{min(s['write_s'] for s in saves):.3f}-"
          f"{max(s['write_s'] for s in saves):.3f} s over {len(saves)} saves")
    return dict(card=card, free_disk_gb=free_gb, determinism=det,
                runs=dict(A=a, C=c), full_step=full,
                fill_step=fill, cached_step=cached, busy_ms=busy,
                fill_host_ms=fill_ms)


# ---------------------------------------------------------------------------
# Phase 7: the evaluation path (beams, sampling, streaming, evaluation)
# ---------------------------------------------------------------------------

BEAMS, STREAM_CHUNK = 4, 4
SAMPLING = dict(temperature=0.7, top_k=50, top_p=0.9)
EVAL_IMAGES, EVAL_BATCH, EVAL_REFS = 40, 32, 4
REQUEST_LAUNCHES = dict(t5_fwd=48, t5_fwd_dropout=0, t5_bwd=0,
                        t5_bwd_dbias=0, swin=24)


def count_passes(model) -> list:
    """Count the decoder passes of ``model.transformer`` (one
    ``decode_step`` call each) in the returned one-item list."""
    passes = [0]
    step = model.transformer.decode_step

    def counted(*args, **kwargs):
        passes[0] += 1
        return step(*args, **kwargs)

    model.transformer.decode_step = counted
    return passes


def check_layout(ids, cfg, what: str) -> None:
    """(batch, max_length) ids, the start token first, ids in the
    vocabulary, and pad after a row's eos."""
    check(tuple(ids.shape) == (BATCH, cfg.generate_max_length),
          f"{what}: token shape {tuple(ids.shape)}")
    check(bool((ids[:, 0] == 0).all()), f"{what}: column 0 is the start")
    check(bool(((ids >= 0) & (ids < cfg.transformer_t5.vocab_size)).all()),
          f"{what}: token ids in the vocabulary")
    for row in ids.tolist():
        if 1 in row[1:]:
            e = row.index(1, 1)
            check(all(t == 0 for t in row[e + 1:]),
                  f"{what}: pad after eos in {row}")


def in_warped_support(cap, images, ids) -> bool:
    """Every drawn token (up to a row's eos) has a finite warped logit
    under the same model, teacher-forced through the same decode steps."""
    import torch

    from klab_multimodalmodel_tpu_torch.infer.generate import warp_logits

    t5 = cap.model.transformer
    with torch.inference_mode():
        enc, mask = cap._encode_prefill(images, None)
        cache, ok = None, True
        finished = torch.zeros(ids.shape[0], dtype=torch.bool,
                               device=ids.device)
        for s in range(ids.shape[1] - 1):
            logits, cache = t5.decode_step(ids[:, s:s + 1], s, enc,
                                           ids.shape[1], mask, cache=cache)
            warped = warp_logits(logits[:, -1], **SAMPLING)
            chosen = warped.gather(1, ids[:, s + 1:s + 2].long())[:, 0]
            ok &= bool((torch.isfinite(chosen) | finished).all())
            finished |= ids[:, s + 1] == 1
    return ok


def timed_request(cap, passes, images, **kw) -> tuple[float, int, object]:
    """(ms, decoder passes, ids) of one request, host clock around work
    that ends in the ids' read-back."""
    import torch

    passes[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = cap.caption_launch(images, **kw)
    cap.caption_finish(ids)
    return (time.perf_counter() - t0) * 1e3, passes[0], ids


def beam_phase(card, cfg, model, cap, requests, greedy_ids) -> dict:
    """7a: three greedy requests (``num_beams=1`` through the router,
    against phase 3's tokens), then three beam requests, their launches and
    layout, in turns with the greedy ones on the same images; beams with
    the kernels against the same weights without them."""
    import torch

    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.infer.generate import (
        beam_search_decode)
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)

    passes = count_passes(model)
    t0 = time.perf_counter()
    cap.caption(requests[0], num_beams=BEAMS)  # warm-up
    first_ms = (time.perf_counter() - t0) * 1e3
    greedy = []
    for images, want in zip(requests[1:], greedy_ids):
        ms, n, ids = timed_request(cap, passes, images, num_beams=1)
        check(ids.tolist() == want, "num_beams=1 through the router differs "
              "from phase 3's greedy tokens")
        greedy.append(dict(ms=ms, passes=n))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    per_request, beam_ids = [], []
    for images in requests[1:]:
        before = launch_counts()
        ms, n, ids = timed_request(cap, passes, images, num_beams=BEAMS)
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        check(got == REQUEST_LAUNCHES, f"beam request launches {got}, "
              f"expected {REQUEST_LAUNCHES}")
        check_layout(ids, cfg, "beam request")
        per_request.append(dict(ms=ms, passes=n))
        beam_ids.append(ids)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for images, row in zip(requests[1:], greedy):  # greedy again, in turn
        row["ms_after_beams"] = timed_request(cap, passes, images,
                                              num_beams=1)[0]

    images = requests[1]
    enc, mask = cap._encode_prefill(images, None)
    with torch.inference_mode():
        ids_k, scores_k = beam_search_decode(
            model.transformer, enc, mask, cfg.generate_max_length, BEAMS,
            return_scores=True)
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False,
                                    use_pallas_t5_attention=False)
    plain_model = MultiModalModel(plain_cfg)
    plain_model.load_state_dict(model.state_dict(), strict=True)
    plain_cap = Captioner(plain_cfg, plain_model, cap.tokenizer)
    enc_p, mask_p = plain_cap._encode_prefill(images, None)
    with torch.inference_mode():
        ids_p, scores_p = beam_search_decode(
            plain_model.transformer, enc_p, mask_p, cfg.generate_max_length,
            BEAMS, return_scores=True)
    del plain_model, plain_cap
    check(bool((ids_k == beam_ids[0]).all()), "beam search is not "
          "deterministic: the same request gave other tokens")
    same = (ids_k == ids_p).all(dim=1)
    differing = []
    for r in torch.nonzero(~same).flatten().tolist():
        differing.append(dict(
            row=r, best_kernels=float(scores_k[r, 0]),
            best_plain=float(scores_p[r, 0]),
            margin=abs(float(scores_k[r, 0]) - float(scores_p[r, 0])),
            runner_up_gap_kernels=float(scores_k[r, 0] - scores_k[r, 1])))
    print(f"beams, kernels vs none: {int(same.sum())}/{BATCH} rows "
          f"identical")
    for d in differing:
        print(f"  row {d['row']}: best score {d['best_kernels']:.6f} with "
              f"kernels, {d['best_plain']:.6f} without (margin "
              f"{d['margin']:.3e}; winner - runner-up with kernels "
              f"{d['runner_up_gap_kernels']:.3e})")

    mean_ms = sum(r["ms"] for r in per_request) / len(per_request)
    mean_passes = sum(r["passes"] for r in per_request) / len(per_request)
    greedy_ms = sum(r["ms"] + r["ms_after_beams"] for r in greedy) / (
        2 * len(greedy))
    out = dict(num_beams=BEAMS, requests=per_request,
               first_request_ms=first_ms, request_ms=mean_ms,
               passes=mean_passes,
               ms_per_pass=mean_ms / mean_passes, peak_memory_gb=peak_gb,
               greedy_requests=greedy, greedy_request_ms=greedy_ms,
               launches=launches, launches_per_request=REQUEST_LAUNCHES,
               identical_rows_vs_plain=int(same.sum()),
               differing_rows_vs_plain=differing)
    print(f"phase 7a [{card}]: beam request (num_beams {BEAMS}, batch "
          f"{BATCH}) {mean_ms:.2f} ms, {mean_passes:.1f} passes, "
          f"{out['ms_per_pass']:.2f} ms per pass, peak {peak_gb:.2f} GB; "
          f"greedy request in turn {greedy_ms:.2f} ms "
          f"({mean_ms / greedy_ms:.2f}x)")
    return out


def sampling_phase(card, cap, requests, greedy_ids) -> dict:
    """7b: two sampled runs from one generator seed are equal, every token
    lies in the warped support, and top_k=1 gives the greedy tokens."""
    import torch

    def sample(images, seed, **kw):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return cap.caption_launch(images, do_sample=True, generator=gen,
                                  **kw)

    images = requests[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = sample(images, SEED, **SAMPLING)
    cap.caption_finish(a)
    ms = (time.perf_counter() - t0) * 1e3
    b = sample(images, SEED, **SAMPLING)
    check(bool((a == b).all()), "two sampled runs from one seed differ")
    check_layout(a, cap.config, "sampled request")
    other = sample(images, SEED + 1, **SAMPLING)
    check(in_warped_support(cap, images, a),
          "a sampled token lies outside the warped support")
    for images, want in zip(requests[1:], greedy_ids):
        check(sample(images, SEED + 2, top_k=1).tolist() == want,
              "top_k=1 sampling differs from greedy")
    out = dict(request_ms=ms, other_seed_differs=bool((a != other).any()),
               sample_captions=cap.caption_finish(a)[:2], **SAMPLING)
    print(f"phase 7b [{card}]: sampled request {ms:.2f} ms; another seed "
          f"{'differs' if out['other_seed_differs'] else 'is equal'}")
    return out


def streaming_phase(card, cap, requests) -> dict:
    """7c: caption_stream's final texts equal caption's; the time to the
    first yield."""
    import torch

    images = requests[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cap.caption(images)
    caption_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    stream = cap.caption_stream(images, chunk_size=STREAM_CHUNK)
    texts, done = next(stream)
    first_ms = (time.perf_counter() - t0) * 1e3
    yields = 1
    for texts, done in stream:
        yields += 1
    total_ms = (time.perf_counter() - t0) * 1e3
    check(done and texts == want, "the stream's final texts differ from "
          "caption's")
    out = dict(chunk_size=STREAM_CHUNK, first_yield_ms=first_ms,
               stream_ms=total_ms, yields=yields, caption_ms=caption_ms)
    print(f"phase 7c [{card}]: stream (chunk {STREAM_CHUNK}) first yield "
          f"{first_ms:.2f} ms, {yields} yields in {total_ms:.2f} ms "
          f"(caption: {caption_ms:.2f} ms)")
    return out


def evaluation_run(card, cfg, model, root: str) -> dict:
    """7d: ``evaluation.run`` over a COCO-layout directory of EVAL_IMAGES
    fixture JPEGs (the fixtures in turn) with EVAL_REFS seeded references
    each, at batch EVAL_BATCH (a ragged tail), with num_beams 1 and 4. The
    evaluation reads the files through the port's ``load_image_resized``
    (the native JPEG decode and the resize), wrapped here to time it."""
    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch.evaluation import evaluate
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    rng = np.random.default_rng(SEED + 7)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, rng.integers(2, 8)))
             for _ in range(60)]
    refs = [[" ".join(rng.choice(words, rng.integers(5, 12)))
             for _ in range(EVAL_REFS)] for _ in range(EVAL_IMAGES)]
    data_dir = coco_layout(root, {"val": EVAL_IMAGES}, lambda i: refs[i])

    load_s, loads = [0.0], [0]
    real_loader = evaluate.load_image_resized

    def timed_loader(path: str, image_size: int):
        t0 = time.perf_counter()
        img = real_loader(path, image_size)
        load_s[0] += time.perf_counter() - t0
        loads[0] += 1
        return img

    evaluate.load_image_resized = timed_loader
    out = {}
    try:
        for beams in (1, BEAMS):
            run_cfg = dataclasses.replace(
                cfg, num_beams=beams, data_dir=data_dir,
                result_dir=os.path.join(root, f"beams{beams}"))
            reset_counts()
            load_s[0], loads[0] = 0.0, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = evaluate.run(run_cfg, model, ByteTokenizer())
            seconds = time.perf_counter() - t0
            got = launch_counts()
            batches = -(-EVAL_IMAGES // EVAL_BATCH)
            want = {k: v * batches for k, v in REQUEST_LAUNCHES.items()}
            check(got == want, f"evaluation launches {got}, expected {want}")
            with open(os.path.join(run_cfg.result_dir, "metrics.json")) as f:
                written = json.load(f)
            keys = ("CIDEr-D", "BLEU-1", "BLEU-2", "BLEU-3", "BLEU-4",
                    "ROUGE-L")
            check(written == metrics and written["num_images"] == EVAL_IMAGES
                  and all(math.isfinite(written[k]) for k in keys),
                  f"metrics.json {written}")
            check(loads[0] == EVAL_IMAGES, f"the loader read {loads[0]} "
                  f"files, expected {EVAL_IMAGES}")
            out[f"num_beams_{beams}"] = dict(
                seconds=seconds, images_per_s=EVAL_IMAGES / seconds,
                loader_seconds=load_s[0],
                loader_ms_per_image=1e3 * load_s[0] / loads[0],
                **{k: written[k] for k in keys})
            print(f"phase 7d [{card}]: evaluate {EVAL_IMAGES} fixture JPEGs "
                  f"at batch {EVAL_BATCH}, num_beams {beams}: {seconds:.2f} "
                  f"s, {EVAL_IMAGES / seconds:.2f} images/s (the image loader"
                  f" {1e3 * load_s[0]:.2f} ms of it, "
                  f"{1e3 * load_s[0] / loads[0]:.3f} ms per image, on the "
                  f"host while the card idles); CIDEr-D "
                  f"{written['CIDEr-D']:.4f}, BLEU-4 {written['BLEU-4']:.3e}")
    finally:
        evaluate.load_image_resized = real_loader
    return out


def evaluation_phase(card: str, greedy_ids: list) -> dict:
    """Phase 7 on phase 3's weights (the same seed) and requests."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    t_phase = time.perf_counter()
    cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                 seed=SEED)
    model = MultiModalModel(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(cfg.seed))
    cap = Captioner(cfg, model, ByteTokenizer())
    rng = np.random.default_rng(SEED)  # phase 3's requests
    size = cfg.swin.image_size
    requests = [rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)
                for _ in range(REQUESTS + 1)]
    out = dict(beams=beam_phase(card, cfg, model, cap, requests, greedy_ids))
    out["sampling"] = sampling_phase(card, cap, requests, greedy_ids)
    out["streaming"] = streaming_phase(card, cap, requests)
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        out["evaluation"] = evaluation_run(card, cfg, model, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # Profiled last: every timing above ran before this profile.
    beams = out["beams"]
    beams["device"] = profile_device(
        lambda: cap.caption_finish(cap.caption_launch(requests[1],
                                                      num_beams=BEAMS)),
        beams["request_ms"], card, "beam request")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 7: {out['seconds']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# Phase 8: the reference's artifacts (HF checkpoints, a T5 tokenizer.json)
# ---------------------------------------------------------------------------

# The seeded tokenizer.json: <pad>, </s>, <unk> and 31,997 more unigram
# pieces, then 100 sentinels: 32,100 ids against the model's 32,128.
ARTIFACT_PIECES, ARTIFACT_SENTINELS = 32_000, 100
# Full-width letters and the ideographic space that the charsmap maps.
ARTIFACT_CHARSMAP = {"Ａ": "A", "ｂ": "b", "ｃ": "c",
                     "　": " "}
# COCO-like image sizes (height, width): one batch-8 request's images.
COCO_SIZES = [(375, 500), (480, 640), (640, 427), (427, 640), (500, 375),
              (480, 640), (333, 500), (612, 612)]
ENCODE_REPS = 20
ENCODE_MANY = 8192  # texts in 8b's long encode batch
# 8c's COCO-layout directory: images a phase (train and val), the fixture
# JPEGs in turn, each with one of these captions in turn; and the fixtures
# that the caption command captions after 8c.
ARTIFACT_IMAGES = 2 * TRAIN_BATCH
ARTIFACT_CAPTIONS = [
    "A man with a red helmet on a small moped on a dirt road.",
    "A dog jumps over a wooden fence in a park.",
    "Two cats sit on a sunny window sill.",
    "A plate of food with rice and vegetables on a table.",
]
CLI_IMAGES = ("coco_640x480.jpg", "photo_4032x3024.jpg", "cmyk_500x375.jpg")


def write_safetensors(path: str, tensors: dict) -> int:
    """A minimal ``.safetensors`` writer of fp32 tensors: a u64
    little-endian header
    length, the JSON header (8-byte aligned, as the format's own writer
    pads it), then each tensor's bytes. A T5 tied copy (``embed_tokens``,
    a tied ``lm_head``: the storage of ``shared.weight``) is left out, as
    HF's ``save_pretrained`` leaves it out. Returns the bytes written."""
    import struct

    import torch

    tied = ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight",
            "lm_head.weight")
    header, order, seen, offset = {}, [], set(), 0
    for name in sorted(tensors, key=lambda k: (k in tied, k)):
        t = tensors[name]
        if t.data_ptr() in seen:
            continue
        seen.add(t.data_ptr())
        n = t.numel() * t.element_size()
        check(t.dtype == torch.float32, f"{name}: {t.dtype}, not fp32")
        header[name] = {"dtype": "F32",
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        order.append(name)
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(tensors[name].contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return 8 + len(blob) + offset


def seeded_tokenizer_json(path: str, seed: int) -> None:
    """A T5-layout ``tokenizer.json`` made from a seed, as HF writes one for
    a converted spiece.model: a Unigram model (<pad>, </s>, <unk>, every
    printable ASCII character and the metaspace, then seeded lowercase
    pieces with and without the metaspace, with seeded scores), the
    Precompiled charsmap of ``ARTIFACT_CHARSMAP``, Strip(right),
    Replace(/ {2,}/ -> U+2581), Metaspace, and the sentinels as added
    tokens, <extra_id_0> last."""
    import base64

    import numpy as np

    from klab_multimodalmodel_tpu_torch.text.charsmap import build_charsmap

    meta = "▁"
    rng = np.random.default_rng(seed)
    pieces = {c: float(-rng.uniform(12.0, 14.0))
              for c in [chr(i) for i in range(33, 127)] + [meta]}
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(pieces) < ARTIFACT_PIECES - 3:
        word = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        piece = meta + word if rng.random() < 0.6 else word
        pieces.setdefault(piece, float(-rng.uniform(4.0, 12.0)))
    specials = ["<pad>", "</s>", "<unk>"]
    vocab = [[t, 0.0] for t in specials] + [[p, s] for p, s in
                                            pieces.items()]

    def added(i, content):
        return {"id": i, "content": content, "single_word": False,
                "lstrip": False, "rstrip": False, "normalized": False,
                "special": True}

    metaspace = {"type": "Metaspace", "replacement": meta,
                 "prepend_scheme": "always", "split": True}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [added(i, t) for i, t in enumerate(specials)] + [
            added(ARTIFACT_PIECES + ARTIFACT_SENTINELS - 1 - k,
                  f"<extra_id_{k}>")
            for k in reversed(range(ARTIFACT_SENTINELS))],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(
                build_charsmap(ARTIFACT_CHARSMAP)).decode()},
            {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"},
             "content": meta}]},
        "pre_tokenizer": metaspace, "post_processor": None,
        "decoder": metaspace,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab,
                  "byte_fallback": False}}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)


def artifacts_export(card: str, cfg, root: str) -> dict:
    """8a: phase 3's seeded weights exported through ``export_hf`` into a
    HF T5 directory (``model.safetensors`` and the seeded
    ``tokenizer.json``) and a HF SwinV2 directory (``pytorch_model.bin``),
    then ``python -m klab_multimodalmodel_tpu_torch convert-hf`` over
    them. Checks the converted towers bitwise against phase 3's weights and
    loads them with ``load_pretrained_params``."""
    import types

    import torch

    from klab_multimodalmodel_tpu_torch.checkpoint.export_hf import (
        export_swinv2, export_t5_lm, split_towers)
    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        MODEL_FILE, load_pretrained_params)
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)

    timing = {}
    t0 = time.perf_counter()
    model = MultiModalModel(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(cfg.seed))
    phase3 = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    free()
    timing["phase-3 weights to the host"] = time.perf_counter() - t0
    parts = split_towers(phase3)

    t5_dir, swin_dir = os.path.join(root, "t5"), os.path.join(root, "swin")
    out_dir = os.path.join(root, "converted")
    os.makedirs(t5_dir)
    os.makedirs(swin_dir)
    t0 = time.perf_counter()
    t5_bytes = write_safetensors(
        os.path.join(t5_dir, "model.safetensors"),
        export_t5_lm(parts["transformer"], cfg.transformer_t5))
    timing["export t5 (model.safetensors)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    swin_path = os.path.join(swin_dir, "pytorch_model.bin")
    torch.save(export_swinv2(parts["image_model"], cfg.swin), swin_path)
    swin_bytes = os.path.getsize(swin_path)
    timing["export swinv2 (pytorch_model.bin)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seeded_tokenizer_json(os.path.join(t5_dir, "tokenizer.json"), SEED)
    timing["tokenizer.json"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "klab_multimodalmodel_tpu_torch",
         "convert-hf", "--t5_dir", t5_dir, "--swin_dir", swin_dir,
         "--language_model_name", cfg.language_model_name,
         "--transformer_model_name", cfg.transformer_model_name,
         "--image_model_name", cfg.image_model_name, "--output", out_dir],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    timing["convert-hf (subprocess)"] = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"convert-hf exit {proc.returncode}: {proc.stderr[-3000:]}")
    print("phase 8a: convert-hf: " + proc.stdout.strip())
    model_pt = os.path.join(out_dir, "checkpoints", "pretrained", MODEL_FILE)
    written = os.path.getsize(model_pt)

    t0 = time.perf_counter()
    converted = torch.load(model_pt, map_location="cpu", weights_only=True,
                           mmap=True)
    got = split_towers(converted)
    for tower in ("transformer", "image_model", "vision_projection"):
        check(got[tower].keys() == parts[tower].keys(),
              f"converted {tower}: keys differ from phase 3's")
        for k, v in parts[tower].items():
            check(torch.equal(got[tower][k], v),
                  f"converted {tower}.{k} differs from phase 3's")
    lm = parts["transformer"]
    check(sorted(got["language_model"]) == sorted(
        k for k in lm if k == "shared.weight" or k.startswith("encoder.")),
        "converted language_model: not the LM's encoder keys")
    for k, v in got["language_model"].items():
        check(torch.equal(v, lm[k]), f"language_model.{k} is not the "
              "LM's encoder tensor")
    timing["bitwise check of the converted towers"] = (
        time.perf_counter() - t0)
    del converted, got
    t0 = time.perf_counter()
    model = MultiModalModel(cfg)
    loaded = load_pretrained_params(out_dir, types.SimpleNamespace(
        model=model))
    torch.cuda.synchronize()
    timing["load_pretrained_params (strict)"] = time.perf_counter() - t0
    check(loaded == ["image_model", "language_model", "transformer",
                     "vision_projection"], f"loaded {loaded}")
    sizes = dict(t5_safetensors_gb=t5_bytes / 1e9,
                 swin_bin_gb=swin_bytes / 1e9,
                 converted_model_pt_gb=written / 1e9)
    print(f"phase 8a [{card}]: wrote {t5_bytes / 1e9:.3f} GB "
          f"model.safetensors and {swin_bytes / 1e9:.3f} GB "
          f"pytorch_model.bin; convert-hf read {(t5_bytes + swin_bytes) / 1e9:.3f}"
          f" GB and wrote {written / 1e9:.3f} GB; transformer and image_model "
          f"bitwise phase 3's, language_model the LM's encoder; seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in timing.items()))
    return dict(model=model, out_dir=out_dir, timing=timing, sizes=sizes,
                convert_stdout=proc.stdout)


def artifacts_caption(card: str, cfg, model, out_dir: str) -> dict:
    """8b: three batch-8 requests through ``Captioner`` with the converted
    weights and ``load_tokenizer(<dir>/tokenizer.json)``; images of COCO
    sizes through the native bicubic resize."""
    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch.data.datasets import COCO_PROMPT
    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.native import resize_batch
    from klab_multimodalmodel_tpu_torch.text import load_tokenizer
    from klab_multimodalmodel_tpu_torch.text.tokenizer import TokenizerBase

    t0 = time.perf_counter()
    tok = load_tokenizer(os.path.join(out_dir, "tokenizer.json"))
    load_ms = (time.perf_counter() - t0) * 1e3
    check((tok.vocab_size, tok.num_sentinels, tok.pad_id, tok.eos_id,
           tok.unk_id) == (ARTIFACT_PIECES + ARTIFACT_SENTINELS,
                           ARTIFACT_SENTINELS, 0, 1, 2),
          f"tokenizer layout {tok.vocab_size} {tok.num_sentinels}")
    prompt = tok([COCO_PROMPT], max_length=cfg.max_source_length)
    n = int(prompt.attention_mask.sum())
    check(tok.decode(prompt.input_ids[0]) == COCO_PROMPT,
          f"prompt round trip: {tok.decode(prompt.input_ids[0])!r}")
    # The text-at-a-time path (encode_ids, then truncate and pad in
    # Python) against __call__'s one C++ call.
    one = TokenizerBase.__call__(tok, [COCO_PROMPT], cfg.max_source_length)
    check(np.array_equal(one.input_ids, prompt.input_ids)
          and np.array_equal(one.attention_mask, prompt.attention_mask),
          "tokenizer(prompt) vs its ids one text at a time")
    check(tok.encode_ids("Ａ ｂｃ　x  ") ==
          tok.encode_ids("A bc x"), "the charsmap's full-width letters")

    rng = np.random.default_rng(SEED + 8)
    size = cfg.swin.image_size
    raw = [[rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in COCO_SIZES] for _ in range(REQUESTS + 1)]
    resize_batch(raw[0][:1], size)  # builds and loads the library
    resize_ms = {}
    for threads in (1, 0):
        t0 = time.perf_counter()
        for imgs in raw:
            resize_batch(imgs, size, n_threads=threads)
        resize_ms[threads] = ((time.perf_counter() - t0) * 1e3
                              / (len(raw) * BATCH))
    requests = [resize_batch(imgs, size) for imgs in raw]

    cap = Captioner(cfg, model, tok)
    cap.caption(requests[0])  # warm-up
    reset_counts()
    per_request, texts, all_ids = [], [], []
    for images in requests[1:]:
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = cap.caption_launch(images)
        texts.extend(cap.caption_finish(ids))
        per_request.append((time.perf_counter() - t0) * 1e3)
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        check(got == REQUEST_LAUNCHES, f"phase 8b request launches {got}, "
              f"expected {REQUEST_LAUNCHES}")
        all_ids.extend(ids.cpu().tolist())
    launches = launch_counts()

    enc, _ = cap._encode_prefill(requests[1], None)
    check(bool(torch.isfinite(enc).all()), "encoder output is finite")
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False,
                                    use_pallas_t5_attention=False)
    plain = MultiModalModel(plain_cfg)
    plain.load_state_dict(model.state_dict(), strict=True)
    enc_plain, _ = Captioner(plain_cfg, plain, tok)._encode_prefill(
        requests[1], None)
    rel = float((enc - enc_plain).abs().max() / enc_plain.abs().max())
    check(rel <= TOL_ENCODER_REL, f"encoder kernel-vs-plain rel diff {rel}")
    del plain, enc, enc_plain
    free()

    # Random weights emit mostly special ids (the sentinel range and
    # beyond), so their captions are short or empty: seeded rows of ordinary
    # ids go through the same decode and encode beside them.
    special = sum(tok.is_special(i) for row in all_ids for i in row[1:])
    rows = all_ids + rng.integers(3, ARTIFACT_PIECES, (
        len(all_ids), cfg.generate_max_length)).tolist()
    decoded = tok.batch_decode(rows)
    exact = 0
    for row, text in zip(rows, decoded):
        check(isinstance(text, str), f"caption {text!r} is not a str")
        back = tok.encode_ids(text)
        check(tok.decode(back) == text, f"caption {text!r} does not "
              "survive encode and decode")
        exact += back == [i for i in row if not tok.is_special(i)]
    check(decoded[:len(texts)] == texts, "batch_decode vs the captioner's")
    seeded = decoded[len(texts):]
    t0 = time.perf_counter()
    for _ in range(ENCODE_REPS):
        TokenizerBase.__call__(tok, seeded, cfg.generate_max_length)
    python_us = (time.perf_counter() - t0) * 1e6 / (ENCODE_REPS * len(seeded))
    t0 = time.perf_counter()
    for _ in range(ENCODE_REPS):
        tok(seeded, max_length=cfg.generate_max_length)
    batch_us = (time.perf_counter() - t0) * 1e6 / (ENCODE_REPS * len(seeded))
    # A batch long enough for encode_batch's threads (one per KiB of text):
    # one thread against the default.
    many = seeded * (ENCODE_MANY // len(seeded))
    many_bytes = sum(len(t.encode()) for t in many)
    many_ids, many_us = {}, {}
    for threads in (1, 0):
        t0 = time.perf_counter()
        many_ids[threads], _ = tok.encoder.encode_batch(
            many, cfg.generate_max_length, n_threads=threads)
        many_us[threads] = (time.perf_counter() - t0) * 1e6 / len(many)
    check(np.array_equal(many_ids[0], many_ids[1]),
          "encode_batch on threads vs one thread")
    request_ms = sum(per_request) / len(per_request)
    print(f"phase 8b [{card}]: tokenizer.json loaded in {load_ms:.2f} ms; "
          f"prompt {n} ids; requests {', '.join(f'{m:.2f}' for m in per_request)}"
          f" ms (mean {request_ms:.2f}); native bicubic resize of COCO sizes "
          f"to {size}: {resize_ms[1]:.3f} ms per image on one thread, "
          f"{resize_ms[0]:.3f} ms per image in a batch on the pool; encode "
          f"{python_us:.2f} us per caption one by one, {batch_us:.2f} us "
          f"through tokenizer() (the {len(seeded)} seeded rows' texts), "
          f"{many_us[1]:.3f} us on one thread and {many_us[0]:.3f} us on the "
          f"default threads in a batch of {len(many)} ({many_bytes} bytes; "
          f"host CPUs {os.cpu_count()}, {len(os.sched_getaffinity(0))} "
          f"usable); "
          f"encoder "
          f"output kernels vs none {rel:.3e}; {special} of "
          f"{sum(len(r) - 1 for r in all_ids)} generated ids are special; "
          f"{exact} of {len(rows)} rows (captions and seeded rows) re-encode "
          f"to their ids, every one to its text; samples {texts[:2]}, "
          f"{seeded[:2]}")
    return dict(request_ms=per_request, mean_request_ms=request_ms,
                resize_ms_per_image_one_thread=resize_ms[1],
                resize_ms_per_image_pool=resize_ms[0],
                encode_us_per_caption_one_by_one=python_us,
                encode_us_per_caption_tokenizer=batch_us,
                encode_us_per_caption_long_batch_one_thread=many_us[1],
                encode_us_per_caption_long_batch_threads=many_us[0],
                long_batch_texts=len(many), long_batch_bytes=many_bytes,
                host_cpus=os.cpu_count(),
                usable_cpus=len(os.sched_getaffinity(0)),
                tokenizer_load_ms=load_ms, prompt_ids=n,
                encoder_rel_diff_vs_plain=rel, launches=launches,
                special_ids=special, exact_round_trips=exact,
                rows=len(rows), sample_captions=texts[:2],
                sample_seeded=seeded[:2])


def artifacts_train(card: str, cfg, out_dir: str, root: str) -> dict:
    """8c: ``train(config)`` from the converted directory with its
    tokenizer.json and ``native_tokenizer``, batch 32, one epoch of 2
    updates and 2 validation batches over a COCO-layout directory of the
    fixture JPEGs (``ARTIFACT_IMAGES`` a phase); otherwise phase 6's
    Config. Then the ``caption`` command in a subprocess on three fixture
    files with the run's directory."""
    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch.data import get_dataloader
    from klab_multimodalmodel_tpu_torch.text import load_tokenizer
    from klab_multimodalmodel_tpu_torch.text.tokenizer import TokenizerBase

    tok_path = os.path.join(out_dir, "tokenizer.json")
    data_dir = coco_layout(
        root, {"train": ARTIFACT_IMAGES, "val": ARTIFACT_IMAGES},
        lambda i: [ARTIFACT_CAPTIONS[i % len(ARTIFACT_CAPTIONS)]])
    cfg = dataclasses.replace(
        cfg, data_dir=data_dir, batch_size=TRAIN_BATCH, num_epochs=1,
        init_checkpoint=out_dir, tokenizer_path=tok_path,
        native_tokenizer=True, result_dir=os.path.join(root, "run"))
    tok = load_tokenizer(tok_path)
    loader = get_dataloader(cfg, "train", tok)
    loader.set_epoch(1)
    batch = next(iter(loader))
    items = [loader.dataset[int(i)] for i in batch["index"]]
    for key, col, length in (("source", 1, cfg.max_source_length),
                             ("target", 2, cfg.max_target_length)):
        want = TokenizerBase.__call__(tok, [it[col] for it in items], length)
        check(np.array_equal(batch[f"{key}_ids"], want.input_ids)
              and np.array_equal(batch[f"{key}_mask"], want.attention_mask),
              f"loader {key} ids vs the tokenizer's one text at a time")
    encode_ms = {}
    for name, fn in (("tokenizer", lambda t, n: tok(t, max_length=n)),
                     ("one by one",
                      lambda t, n: TokenizerBase.__call__(tok, t, n))):
        t0 = time.perf_counter()
        for _ in range(ENCODE_REPS):
            fn([it[1] for it in items], cfg.max_source_length)
            fn([it[2] for it in items], cfg.max_target_length)
        encode_ms[name] = (time.perf_counter() - t0) * 1e3 / ENCODE_REPS
    loader.close()

    result, out = loop_run(cfg, card, "8c (from the converted directory, "
                           "over fixture JPEGs)", phase="8")
    check(result["steps"] == 2 and not result["halted"],
          f"{result['steps']} updates")
    check(all(math.isfinite(x) for p in ("train", "val")
              for x in result["losses"][p]), f"losses {result['losses']}")
    converted = torch.load(os.path.join(out_dir, "checkpoints", "pretrained",
                                        "model.pt"), map_location="cpu",
                           weights_only=True, mmap=True)
    frozen = out["trainer"].model.language_model.state_dict()
    for k, v in frozen.items():
        check(torch.equal(v.cpu(), converted[f"language_model.{k}"]),
              f"the trained run's text tower {k} is not the converted one")
    del out, converted, frozen
    free()
    full = result["step_kinds"]["full step"]
    print(f"phase 8c [{card}]: step spans "
          f"{', '.join(f'{t:.2f}' for t in full['span_ms'])} ms on the "
          f"device, host {', '.join(f'{t:.2f}' for t in full['host_ms'])} "
          f"ms; the loader's encode of one batch-{TRAIN_BATCH} batch "
          f"(source and target): {encode_ms['tokenizer']:.3f} ms through "
          f"the tokenizer, {encode_ms['one by one']:.3f} ms one text at a "
          f"time; losses {result['losses']}")
    result["loader_encode_ms"] = encode_ms
    result["caption_cli"] = caption_cli(card, cfg.result_dir)
    return result


def caption_cli(card: str, run_dir: str) -> dict:
    """``python -m klab_multimodalmodel_tpu_torch caption`` in a subprocess
    on ``CLI_IMAGES`` (fixture JPEGs) with 8c's run directory: one caption
    line per file, in order."""
    images = [os.path.join(JPEG_DIR, name) for name in CLI_IMAGES]
    cmd = [sys.executable, "-m", "klab_multimodalmodel_tpu_torch", "caption",
           *images, "--result_dir", run_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"the caption command exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    rows = [line.split("\t", 1) for line in proc.stdout.splitlines()
            if "\t" in line]
    check([r[0] for r in rows] == images and all(len(r) == 2 for r in rows),
          f"the caption command printed {proc.stdout[-2000:]!r}, not one "
          f"caption per file")
    print(f"phase 8c [{card}]: the caption command on {len(images)} fixture "
          f"JPEGs ({', '.join(CLI_IMAGES)}) with 8c's run directory: one "
          f"caption per file in {seconds:.2f} s (a new process: start, "
          f"load and caption)")
    return dict(seconds=seconds, images=CLI_IMAGES,
                captions=[r[1] for r in rows])


def artifacts_phase(card: str, **names) -> dict:
    """Phase 8: the reference's artifacts at full width (the Config's
    model names unless ``names`` overrides them), in a temporary directory
    that is removed afterwards."""
    import shutil
    import tempfile

    from klab_multimodalmodel_tpu_torch.config import Config

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        print(f"phase 8: {free_gb:.1f} GB free on the disk of {root}")
        cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                     seed=SEED, **names)
        a = artifacts_export(card, cfg, root)
        model = a.pop("model")
        b = artifacts_caption(card, cfg, model, a["out_dir"])
        del model
        free()
        c = artifacts_train(card, cfg, a["out_dir"], root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 8: {seconds:.1f} s")
    return dict(card=card, free_disk_gb=free_gb, export=a, caption=b,
                train=c, seconds=seconds)



# ---------------------------------------------------------------------------
# Phase 9: the serving stack at full width
# ---------------------------------------------------------------------------

# One round of 16 concurrent clients: every check of the phase holds on
# one round, and the script's time goes to phase 13.
SERVE_CLIENTS, SERVE_ROUNDS = 16, 1
SERVE_MAX_BATCH, SERVE_WINDOW_MS = 8, 5.0
ENGINE_SLOTS, ENGINE_CHUNK, ENGINE_PREFILL = 16, 4, 8
SPEC_DRAFT = 4
# A token row that differs from greedy's (another batch shape, a wider
# chunk) must be a knife edge: at the first differing position, greedy's
# top-1 and top-2 logits within this much of the top-1's size (fp32 products
# at other shapes round apart by ~1e-6 relative).
KNIFE_EDGE_REL = 1e-5
# One int8 decode step's logits against the same weights held as Q s in
# fp32, relative to the largest logit: (x Q^T) s against x (Q s)^T, float
# rounding compounded over the 24 decoder layers.
TOL_INT8_DEQUANT_REL = 1e-4
SERVE_TIMEOUT_S = 120  # every client call and wait of phase 9


def http_call(base: str, path: str, payload=None):
    """(status, JSON body) of a GET (no payload) or a JSON POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def sse_first_event(host: str, port: int, payload: dict):
    """(ms to the first event, every event) of one ``/caption_stream``."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=SERVE_TIMEOUT_S)
    t0 = time.perf_counter()
    conn.request("POST", "/caption_stream", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    check(resp.status == 200, f"/caption_stream status {resp.status}")
    events, first_ms = [], None
    for line in resp:
        if line.startswith(b"data: "):
            if first_ms is None:
                first_ms = (time.perf_counter() - t0) * 1e3
            events.append(json.loads(line[len(b"data: "):]))
    conn.close()
    return first_ms, events


def percentile(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))]


def load_rounds(base: str, rounds) -> dict:
    """Each round: one /caption request per client thread, all at once;
    the next round starts when every response is in. Returns the client
    ms per request, each round's wall ms, and the responses."""
    import threading

    lat, walls, responses = [], [], []
    for payloads in rounds:
        out = [None] * len(payloads)

        def client(i):
            t0 = time.perf_counter()
            status, body = http_call(base, "/caption", payloads[i])
            out[i] = (status, body, (time.perf_counter() - t0) * 1e3)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(payloads))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT_S)
            check(not t.is_alive(), "a client thread hung")
        walls.append((time.perf_counter() - t0) * 1e3)
        for status, body, ms in out:
            check(status == 200 and isinstance(body.get("caption"), str),
                  f"/caption answered {status} {body}")
            lat.append(ms)
        responses.append([body["caption"] for _, body, _ in out])
    n = sum(len(p) for p in rounds)
    return dict(request_ms=lat, round_ms=walls, responses=responses,
                p50_ms=percentile(lat, 0.5), p90_ms=percentile(lat, 0.9),
                captions_per_s=n / (sum(walls) / 1e3))


def greedy_margin(t5, enc, mask, row, s: int) -> float:
    """Greedy's relative top-1 minus top-2 logit at position ``s`` of the
    token row ``row`` (1-D), teacher-forced on the row's own prefix."""
    import torch

    L = len(row)
    tokens = torch.as_tensor(row, device=enc.device)[None].to(torch.int32)
    cache = None
    with torch.inference_mode():
        for t in range(s):
            logits, cache = t5.decode_step(tokens[:, t:t + 1], t, enc, L,
                                           mask, cache=cache)
    top2 = logits[0, -1].float().topk(2).values
    return float(top2[0] - top2[1]) / max(abs(float(top2[0])), 1e-30)


def knife_edges(t5, enc, mask, got_rows, want_rows, what: str) -> dict:
    """Rows of ``got_rows`` against greedy's ``want_rows`` (same encoder
    rows ``enc``/``mask``): equal, or a knife edge at the first difference
    (printed). Fails on any other difference."""
    equal, margins = 0, []
    for i, (got, want) in enumerate(zip(got_rows, want_rows)):
        got, want = list(got), list(want)
        if got == want:
            equal += 1
            continue
        s = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        m = greedy_margin(t5, enc[i:i + 1], mask[i:i + 1], want, s)
        margins.append(m)
        print(f"  {what}: row {i} differs from greedy first at position "
              f"{s}: greedy's relative top-2 margin there {m:.3e} "
              f"(knife edge below {KNIFE_EDGE_REL})")
        check(m < KNIFE_EDGE_REL, f"{what}: row {i} differs from greedy at "
              f"{s} with margin {m:.3e}, no knife edge")
    return dict(rows=len(want_rows), equal=equal, knife_edge_margins=margins)


class ServedRows:
    """The token row behind each served caption, keyed by its image: the
    dynamic batcher's finish stage and the engine scheduler's submit are
    wrapped to record them."""

    def __init__(self):
        self.rows = {}

    @staticmethod
    def key(image) -> bytes:
        import hashlib

        return hashlib.sha1(image.tobytes()).digest()

    def wrap_batcher(self, svc):
        finish = svc._batcher._finalize

        def recording(gen, ids, payloads):
            rows = ids.cpu().tolist()
            for (image, _), row in zip(payloads, rows):
                self.rows[self.key(image)] = row
            return finish(gen, ids, payloads)

        svc._batcher._finalize = recording

    def wrap_scheduler(self, svc):
        sched = svc.scheduler
        submit = sched.submit

        def recording(image, *args, **kwargs):
            row, n_valid = submit(image, *args, **kwargs)
            self.rows[self.key(image)] = row.tolist()
            return row, n_valid

        sched.submit = recording


def serving_encoder_vs_plain(card, cfg, model, tok, images) -> dict:
    """The encoder prefill with the kernels against the same weights
    without them, at every batch the serving path gives it: the dynamic
    batcher's buckets and the engine's prefill buckets (the stream and the
    solo captions run at 1, 9d and 9e at 8). The engine's text width is
    the COCO prompt's bucket, the width ``_encode_prefill`` trims to, so one
    reading per batch covers both services."""
    import torch

    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.serve.service import batch_buckets

    buckets = sorted(set(batch_buckets(SERVE_MAX_BATCH))
                     | set(batch_buckets(ENGINE_PREFILL)))
    cap = Captioner(cfg, model, tok)
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False,
                                    use_pallas_t5_attention=False)
    plain = MultiModalModel(plain_cfg)
    plain.load_state_dict(model.state_dict(), strict=True)
    plain.eval()
    plain_cap = Captioner(plain_cfg, plain, tok)
    out = {}
    for b in buckets:
        before = launch_counts()
        enc, mask = cap._encode_prefill(images[:b], None)
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        check(got == REQUEST_LAUNCHES, f"phase 9 prefill at batch {b} "
              f"launched {got}, expected {REQUEST_LAUNCHES}")
        enc_p, mask_p = plain_cap._encode_prefill(images[:b], None)
        check(tuple(enc.shape) == tuple(enc_p.shape)
              and torch.equal(mask, mask_p),
              f"phase 9 prefill at batch {b}: shapes {tuple(enc.shape)} vs "
              f"{tuple(enc_p.shape)} or masks differ")
        check(bool(torch.isfinite(enc).all()),
              f"phase 9 prefill at batch {b} is finite")
        rel = float((enc - enc_p).abs().max() / enc_p.abs().max())
        check(rel <= TOL_ENCODER_REL, f"phase 9 prefill at batch {b}: "
              f"encoder kernel-vs-plain rel diff {rel}")
        out[b] = rel
    del plain, plain_cap, enc, enc_p
    free()
    print(f"phase 9 [{card}]: encoder prefill, kernels vs none (max abs diff "
          f"/ max abs, tolerance {TOL_ENCODER_REL}) at every serving batch: "
          + ", ".join(f"batch {b} {r:.3e}" for b, r in out.items()))
    return out


def solo_rows(cap, images) -> list:
    """Each image captioned alone (batch 1): its greedy token row."""
    return [cap.caption_launch(img[None])[0].tolist() for img in images]


def served_vs_solo(cap, images, solo, served: ServedRows, what) -> dict:
    """Served rows against each image's row alone, by the knife-edge rule;
    the margins along each image's own batch-1 encoder row."""
    got = [served.rows[ServedRows.key(img)] for img in images]
    out = dict(rows=len(images), equal=0, knife_edge_margins=[])
    for img, g, want in zip(images, got, solo):
        if g == want:
            out["equal"] += 1
            continue
        enc, mask = cap._encode_prefill(img[None], None)
        r = knife_edges(cap.decode_model, enc, mask, [g], [want], what)
        out["knife_edge_margins"] += r["knife_edge_margins"]
    return out


def texts_equal(responses, solo, tok) -> int:
    """How many served captions equal the text of the image's own row
    (a row that differs was held to the knife-edge rule already)."""
    flat = [c for r in responses for c in r]
    return sum(int(a == b) for a, b in zip(
        flat, tok.batch_decode(solo, skip_special_tokens=True)))


def dynamic_phase(card, cfg, model, tok, rounds, images, solo,
                  jpegs) -> dict:
    """9a: CaptionService behind CaptionHTTPServer under SERVE_ROUNDS
    rounds of SERVE_CLIENTS concurrent /caption requests; then 9c, the
    stream, on the same server; then a corrupt JPEG body, which must get
    400 "bad image" from a server that goes on serving."""
    import threading

    import torch

    from klab_multimodalmodel_tpu_torch.serve.http import CaptionHTTPServer
    from klab_multimodalmodel_tpu_torch.serve.service import CaptionService

    svc = CaptionService(cfg, model, tok, max_batch=SERVE_MAX_BATCH,
                         window_ms=SERVE_WINDOW_MS)
    served = ServedRows()
    served.wrap_batcher(svc)
    gate = threading.Event()
    warm = svc.warmup
    svc.warmup = lambda: (gate.wait(SERVE_TIMEOUT_S), warm())[1]
    server = CaptionHTTPServer(svc, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.port}"
    starter = threading.Thread(target=server.start)
    try:
        starter.start()
        code, _ = http_call(base, "/healthz")
        check(code == 503, f"/healthz before warmup: {code}")
        t0 = time.perf_counter()
        gate.set()
        starter.join(timeout=SERVE_TIMEOUT_S)
        warmup_s = time.perf_counter() - t0
        code, _ = http_call(base, "/healthz")
        check(code == 200, f"/healthz after warmup: {code}")

        torch.cuda.synchronize()
        reset_counts()
        before = http_call(base, "/stats")[1]
        out = load_rounds(base, rounds)
        got = launch_counts()
        code, snap = http_call(base, "/stats")
        check(code == 200, f"/stats answered {code}")
        batches = snap["batches"] - before["batches"]
        want = {k: v * batches for k, v in REQUEST_LAUNCHES.items()}
        check(got == want, f"9a launches {got} over {batches} batches, "
              f"expected {want}")
        out.update(batches=batches, launches=got,
                   launches_per_batch=dict(REQUEST_LAUNCHES),
                   mean_batch_rows=snap["mean_batch_occupancy"],
                   stats=snap, warmup_s=warmup_s)
        out["vs_solo"] = served_vs_solo(svc.captioner, images, solo, served,
                                        "9a served row")
        out["texts_equal_solo"] = texts_equal(out["responses"], solo, tok)
        out["device"] = profile_device(
            lambda: load_rounds(base, rounds[:1]),
            sum(out["round_ms"]) / len(out["round_ms"]), card,
            f"round of {SERVE_CLIENTS} concurrent requests (9a)")

        # 9c: the stream's final event is /caption's text.
        import base64

        payload = {"image_b64": base64.b64encode(jpegs[0]).decode()}
        code, body = http_call(base, "/caption", payload)
        first_ms, events = sse_first_event("127.0.0.1", server.port,
                                           dict(payload, chunk_size=
                                                STREAM_CHUNK))
        check(events and events[-1] == {"caption": body["caption"],
                                        "done": True},
              f"9c: the stream's last event {events[-1:]} vs /caption "
              f"{body}")
        stream = dict(first_event_ms=first_ms, events=len(events),
                      chunk_size=STREAM_CHUNK)

        # A cut JPEG: 400 "bad image" with the decoder's reason, and the
        # server still answers the whole file.
        cut = {"image_b64": base64.b64encode(
            jpegs[0][:len(jpegs[0]) // 2]).decode()}
        code, err = http_call(base, "/caption", cut)
        check(code == 400 and err.get("error", "").startswith(
            "bad image: JPEG: truncated"),
              f"a cut JPEG body answered {code} {err}")
        code, again = http_call(base, "/caption", payload)
        check(code == 200 and again == body, f"after the cut body, "
              f"/caption answered {code} {again}, not {body}")
        stream["corrupt_body"] = err["error"]
        # The same file with 16 zero bytes in place of its EOI marker
        # (a baseline file: Pillow decodes it to the same pixels): 200 and
        # the same caption.
        check(jpegs[0].endswith(b"\xff\xd9"), "the first body's EOI")
        no_eoi = {"image_b64": base64.b64encode(
            jpegs[0][:-2] + bytes(16)).decode()}
        code, eoi_less = http_call(base, "/caption", no_eoi)
        check(code == 200 and eoi_less == body, f"the body without EOI "
              f"answered {code} {eoi_less}, not {body}")
        stream["eoi_less_body"] = code
        print(f"phase 9a [{card}]: a cut JPEG body: 400 {err['error']!r}; "
              "the next /caption 200, its caption unchanged; the body "
              "with zero bytes in place of EOI: 200, the same caption")
    finally:
        gate.set()
        starter.join(timeout=SERVE_TIMEOUT_S)
        server.stop()
    print(f"phase 9a [{card}]: dynamic batching (max_batch "
          f"{SERVE_MAX_BATCH}, window {SERVE_WINDOW_MS} ms), "
          f"{SERVE_ROUNDS} rounds x {SERVE_CLIENTS} clients: request p50 "
          f"{out['p50_ms']:.2f} ms, p90 {out['p90_ms']:.2f} ms, "
          f"{out['captions_per_s']:.2f} captions/s, mean batch rows "
          f"{out['mean_batch_rows']:.2f}, {batches} batches, launches per "
          f"batch {REQUEST_LAUNCHES['swin']} Swin + "
          f"{REQUEST_LAUNCHES['t5_fwd']} T5; served rows equal to their "
          f"own batch-1 rows {out['vs_solo']['equal']}/{len(images)}; "
          f"warmup {warmup_s:.2f} s")
    print(f"phase 9c [{card}]: /caption_stream (chunk {STREAM_CHUNK}) first "
          f"event {first_ms:.2f} ms, {len(events)} events, last = /caption")
    del out["responses"]
    return dict(dynamic=out, stream=stream)


def engine_direct(card, cap, images, label: str = "9b") -> dict:
    """9b's engine check (and 11c's): eight arrivals through a DecodeEngine
    of ENGINE_SLOTS slots, four inserted, one tick, four more, against
    greedy_decode of the same encoder rows; the idle slots' cache index
    runs past the buffer."""
    import torch

    from klab_multimodalmodel_tpu_torch.infer.engine import DecodeEngine
    from klab_multimodalmodel_tpu_torch.infer.generate import greedy_decode

    L = cap.config.generate_max_length
    enc, mask = cap._encode_prefill(images, None)
    t5 = cap.decode_model
    with torch.inference_mode():
        want = greedy_decode(t5, enc, mask, L).tolist()
    engine = DecodeEngine(t5, slots=ENGINE_SLOTS, source_width=enc.shape[1],
                          d_model=enc.shape[2], max_length=L,
                          chunk=ENGINE_CHUNK)
    rows = {}
    for part, ticks in ((slice(0, 4), 1), (slice(4, 8), 0)):
        e, m = enc[part], mask[part]
        pre = engine.prefill(e, m)
        for j in range(e.shape[0]):
            engine.insert(pre, e, m, j, tag=part.start + j)
        for _ in range(ticks):
            engine.tick()
            rows.update({t: r.tolist() for t, r, _ in engine.reap()})
    for _ in range(100):
        if not engine.has_live():
            break
        engine.tick()
        rows.update({t: r.tolist() for t, r, _ in engine.reap()})
    check(sorted(rows) == list(range(len(images))),
          f"the engine reaped {sorted(rows)}")
    idle = int(engine.state.cache[0]["self"]["cache_index"].max())
    check(idle > L, f"no slot's index ran past the buffer ({idle} <= {L})")
    out = knife_edges(t5, enc, mask, [rows[i] for i in range(len(images))],
                      want, f"{label} engine row")
    out["idle_cache_index"] = idle
    print(f"phase {label} [{card}]: DecodeEngine ({ENGINE_SLOTS} slots, chunk "
          f"{ENGINE_CHUNK}), staggered inserts: {out['equal']}/"
          f"{out['rows']} rows equal greedy_decode's, knife edges "
          f"{out['knife_edge_margins']}; an idle slot's cache index reached "
          f"{idle} (buffer {L}) without a fault")
    return out


def continuous_phase(card, cfg, model, tok, rounds, images, solo) -> dict:
    """9b: ContinuousCaptionService behind CaptionHTTPServer under the same
    load, with the engine's tick timed and its occupancy sampled."""
    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch.serve.continuous import (
        ContinuousCaptionService)
    from klab_multimodalmodel_tpu_torch.serve.http import CaptionHTTPServer

    svc = ContinuousCaptionService(
        cfg, model, tok, max_batch=SERVE_MAX_BATCH,
        window_ms=SERVE_WINDOW_MS, slots=ENGINE_SLOTS,
        engine_chunk=ENGINE_CHUNK, max_prefill=ENGINE_PREFILL)
    served = ServedRows()
    served.wrap_scheduler(svc)
    server = CaptionHTTPServer(svc, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.port}"
    ticks = []
    try:
        t0 = time.perf_counter()
        server.start()
        warmup_s = time.perf_counter() - t0
        engine = svc.scheduler.engine
        tick, reap = engine.tick, engine.reap

        def timed_tick():
            t = time.perf_counter()
            live = int(engine.active.sum())
            tick()
            ticks.append(dict(live=live, t0=t,
                              enqueue_ms=(time.perf_counter() - t) * 1e3))

        def timed_reap():
            t = time.perf_counter()
            out = reap()
            if ticks and "reap_ms" not in ticks[-1]:
                ticks[-1]["reap_ms"] = (time.perf_counter() - t) * 1e3
                ticks[-1]["span_ms"] = (time.perf_counter()
                                        - ticks[-1]["t0"]) * 1e3
            return out

        engine.tick, engine.reap = timed_tick, timed_reap
        torch.cuda.synchronize()
        reset_counts()
        before = http_call(base, "/stats")[1]
        out = load_rounds(base, rounds)
        got = launch_counts()
        code, snap = http_call(base, "/stats")
        check(code == 200, f"/stats answered {code}")
        prefills = snap["batches"] - before["batches"]
        want = {k: v * prefills for k, v in REQUEST_LAUNCHES.items()}
        check(got == want, f"9b launches {got} over {prefills} prefills, "
              f"expected {want}")
        check(snap["fallback"]["requests"] == 0, "9b fell back to the "
              "dynamic batcher")
        spans = [t["span_ms"] for t in ticks if "span_ms" in t]
        out.update(prefills=prefills, launches=got,
                   mean_prefill_rows=snap["mean_batch_occupancy"],
                   ticks=len(ticks), passes_per_tick=ENGINE_CHUNK,
                   tick_span_ms=float(np.mean(spans)),
                   tick_enqueue_ms=float(np.mean([t["enqueue_ms"]
                                                  for t in ticks])),
                   tick_reap_ms=float(np.mean([t.get("reap_ms", 0.0)
                                               for t in ticks])),
                   mean_live_slots=float(np.mean([t["live"]
                                                  for t in ticks])),
                   stats=snap, warmup_s=warmup_s)
        out["vs_solo"] = served_vs_solo(svc.captioner, images, solo, served,
                                        "9b served row")
        out["texts_equal_solo"] = texts_equal(out["responses"], solo, tok)
        out["device"] = profile_device(
            lambda: load_rounds(base, rounds[:1]),
            sum(out["round_ms"]) / len(out["round_ms"]), card,
            f"round of {SERVE_CLIENTS} concurrent requests (9b)")
    finally:
        server.stop()
    out["direct"] = engine_direct(card, svc.captioner, images[:8])
    print(f"phase 9b [{card}]: continuous batching ({ENGINE_SLOTS} slots, "
          f"chunk {ENGINE_CHUNK}, max_prefill {ENGINE_PREFILL}), same load: "
          f"request p50 {out['p50_ms']:.2f} ms, p90 {out['p90_ms']:.2f} ms, "
          f"{out['captions_per_s']:.2f} captions/s, {prefills} prefills of "
          f"{out['mean_prefill_rows']:.2f} rows ({REQUEST_LAUNCHES['swin']} "
          f"Swin + {REQUEST_LAUNCHES['t5_fwd']} T5 each); {out['ticks']} "
          f"ticks of {ENGINE_CHUNK} passes: tick (enqueue to reap) "
          f"{out['tick_span_ms']:.2f} ms, enqueue {out['tick_enqueue_ms']:.2f}"
          f" ms, reap wait {out['tick_reap_ms']:.2f} ms, "
          f"{out['mean_live_slots']:.2f} of {ENGINE_SLOTS} slots live; "
          f"served rows equal to their own batch-1 rows "
          f"{out['vs_solo']['equal']}/{len(images)}")
    del out["responses"]
    return out


def in_turn(captioners: dict, requests) -> tuple[dict, dict]:
    """Each request through each named Captioner, the order reversed every
    other request (a, b, b, a, ...): ({name: [ms, ...]}, {name: [ids,
    ...]}), the host clock around work that ends in the ids' read-back and
    detokenization."""
    import torch

    names = list(captioners)
    ms = {k: [] for k in names}
    ids = {k: [] for k in names}
    for r, images in enumerate(requests):
        for k in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = captioners[k].caption_launch(images)
            captioners[k].caption_finish(out)
            ms[k].append((time.perf_counter() - t0) * 1e3)
            ids[k].append(out)
    return ms, ids


def speculative_phase(card, cfg, model, tok, requests) -> dict:
    """9d: Captioner(speculative_draft=SPEC_DRAFT) on three batch-8
    requests against greedy (knife-edge rule), passes and accepted drafts,
    request ms beside greedy's in turn."""
    import torch

    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.infer.speculative import (
        speculative_greedy_decode_with_stats)

    greedy = Captioner(cfg, model, tok, speculative_draft=0)
    spec = Captioner(cfg, model, tok, speculative_draft=SPEC_DRAFT)
    spec.caption(requests[0])  # warm-up
    L = cfg.generate_max_length
    times, ids = in_turn({"greedy": greedy, "speculative": spec},
                         requests[1:])
    per = []
    for images, g, s in zip(requests[1:], ids["greedy"],
                            ids["speculative"]):
        enc, mask = greedy._encode_prefill(images, None)
        with torch.inference_mode():
            tok_s, passes, acc = speculative_greedy_decode_with_stats(
                model.transformer, enc, mask, L, draft_len=SPEC_DRAFT)
        check(torch.equal(tok_s, s), "9d: the Captioner's speculative ids "
              "differ from speculative_greedy_decode's")
        r = knife_edges(model.transformer, enc, mask, s.tolist(),
                        g.tolist(), "9d speculative row")
        r.update(passes=passes + 1, greedy_passes=decoder_passes(g.cpu()),
                 accepted=acc.tolist())
        per.append(r)
    out = dict(requests=per, ms=times, draft_len=SPEC_DRAFT)
    print(f"phase 9d [{card}]: speculative (draft {SPEC_DRAFT}) vs greedy, "
          f"in turn: " + "; ".join(
              f"{ts:.2f} vs {tg:.2f} ms, passes {r['passes']} vs "
              f"{r['greedy_passes']}, accepted drafts {sum(r['accepted'])} "
              f"({r['equal']}/{r['rows']} rows equal greedy)"
              for r, ts, tg in zip(per, times["speculative"],
                                   times["greedy"])))
    return out


def int8_phase(card, cfg, model, tok, requests) -> dict:
    """9e: Captioner(decode_int8=True): one decode step's logits against
    the same weights as Q s in fp32; token rows equal to fp32 greedy's;
    request ms and peak memory beside fp32's, in turn; the int8 tree's
    bytes."""
    import torch

    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.infer.quantize import decode_bytes
    from klab_multimodalmodel_tpu_torch.models.t5 import KlabDense

    fp32 = Captioner(cfg, model, tok)
    t0 = time.perf_counter()
    int8 = Captioner(cfg, model, tok, decode_int8=True)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    q = int8.decode_model
    deq = type(q)(q.size, use_pallas=False, dtype=torch.float32,
                  device=int8.device)
    deq.load_state_dict({k: v.float() for k, v in q.state_dict().items()
                         if not k.endswith("qscale")}, strict=True)
    with torch.no_grad():
        for name, mod in q.named_modules():
            if isinstance(mod, KlabDense):
                deq.get_submodule(name).weight.copy_(
                    mod.weight.float() * mod.qscale[:, None])
    images = requests[1]
    enc, mask = fp32._encode_prefill(images, None)
    start = torch.zeros(enc.shape[0], 1, dtype=torch.int32,
                        device=enc.device)
    with torch.inference_mode():
        a = q.decode_step(start, 0, enc, cfg.generate_max_length, mask)[0]
        b = deq.decode_step(start, 0, enc, cfg.generate_max_length, mask)[0]
    rel = rel_err(a, b)
    check(rel <= TOL_INT8_DEQUANT_REL, f"9e: int8 logits vs Q s in fp32 "
          f"{rel:.3e}")
    del deq
    free()
    int8.caption(requests[0])  # warm-up
    times, ids = in_turn({"fp32": fp32, "int8": int8}, requests[1:])
    equal = sum(int(torch.equal(x, y)) for a, b in zip(ids["int8"],
                                                       ids["fp32"])
                for x, y in zip(a, b))
    peak = {}
    for name, cap in (("fp32", fp32), ("int8", int8)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cap.caption(images)
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
    tree = dict(int8=decode_bytes(q), fp32=decode_bytes(model.transformer))
    out = dict(logits_rel_vs_dequantized=rel, rows_equal_fp32=equal,
               rows=BATCH * (len(requests) - 1), ms=times, peak_gb=peak,
               tree_bytes=tree, quantize_s=quantize_s)
    print(f"phase 9e [{card}]: int8 decode: one step's logits vs Q s in "
          f"fp32 {rel:.3e} (tolerance {TOL_INT8_DEQUANT_REL}); token rows "
          f"equal to fp32 greedy's {equal}/{out['rows']}; request ms int8 "
          f"{', '.join(f'{t:.2f}' for t in times['int8'])} vs fp32 "
          f"{', '.join(f'{t:.2f}' for t in times['fp32'])} (in turn); peak "
          f"{peak['int8']:.2f} vs {peak['fp32']:.2f} GB; transformer "
          f"{tree['int8'] / 1e9:.3f} GB int8 tree vs {tree['fp32'] / 1e9:.3f}"
          f" GB fp32; quantized in {quantize_s:.2f} s")
    return out


def serving_phase(card: str) -> dict:
    """Phase 9: the serving stack on phase 3's weights (the same seed)."""
    import base64

    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch import cli
    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.data.datasets import (
        load_image_bytes_resized)
    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    t_phase = time.perf_counter()
    cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                 seed=SEED)
    model = MultiModalModel(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(cfg.seed))
    model.eval()
    tok = ByteTokenizer()
    size = cfg.swin.image_size
    # Each request carries a fixture's JPEG bytes (the fixtures in turn);
    # the references decode the same bytes through the services' own loader.
    fixtures = [data for _, data, _ in jpeg_fixtures()]
    jpegs = [fixtures[i % len(fixtures)]
             for i in range(SERVE_ROUNDS * SERVE_CLIENTS)]
    t0 = time.perf_counter()
    images = np.stack([load_image_bytes_resized(b, size) for b in jpegs])
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(jpegs)
    print(f"phase 9 [{card}]: the {len(jpegs)} requests' JPEG bodies "
          f"decoded and resized to {size} on the host: {decode_ms:.3f} ms "
          "per image (one thread)")
    rounds = [[{"image_b64": base64.b64encode(b).decode()}
               for b in jpegs[r * SERVE_CLIENTS:(r + 1) * SERVE_CLIENTS]]
              for r in range(SERVE_ROUNDS)]
    requests = [np.random.default_rng(SEED).integers(
        0, 256, (BATCH, size, size, 3), dtype=np.uint8)
        for _ in range(REQUESTS + 1)]  # phase 3's
    out = dict(encoder_vs_plain=serving_encoder_vs_plain(
        card, cfg, model, tok, images))
    solo_cap = Captioner(cfg, model, tok)
    solo_cap.caption(images[:1])  # warm-up
    t0 = time.perf_counter()
    solo = solo_rows(solo_cap, images)
    solo_s = time.perf_counter() - t0
    print(f"phase 9: each of the {len(images)} images captioned alone "
          f"(batch 1) in {solo_s:.2f} s [{card}]")
    out.update(dynamic_phase(card, cfg, model, tok, rounds, images, solo,
                             jpegs))
    free()
    out["continuous"] = continuous_phase(card, cfg, model, tok, rounds,
                                         images, solo)
    free()
    out["decode_ms_per_image"] = decode_ms
    out["speculative"] = speculative_phase(card, cfg, model, tok, requests)
    free()
    out["int8"] = int8_phase(card, cfg, model, tok, requests)
    try:
        cli.serve_main(["--result_dir", "absent", "--replicas", "2"])
        check(False, "--replicas 2 on one card was not refused")
    except SystemExit as e:
        check(str(e) == "--replicas 2 > 1 visible devices",
              f"--replicas 2 refused with {e}")
        print(f"phase 9: serve --replicas 2 on one card exits: {e}")
    del model
    free()
    a, b = out["dynamic"], out["continuous"]
    print(f"phase 9 [{card}]: dynamic vs continuous under "
          f"{SERVE_ROUNDS} x {SERVE_CLIENTS} concurrent requests: p50 "
          f"{a['p50_ms']:.2f} vs {b['p50_ms']:.2f} ms, p90 {a['p90_ms']:.2f}"
          f" vs {b['p90_ms']:.2f} ms, {a['captions_per_s']:.2f} vs "
          f"{b['captions_per_s']:.2f} captions/s, busy share "
          f"{(a['device'].get('busy_share') or 0):.3f} vs "
          f"{(b['device'].get('busy_share') or 0):.3f}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 9: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: data-parallel training across processes (DDP)
# ---------------------------------------------------------------------------

DDP_RANKS = 2
DDP_BATCH = TRAIN_BATCH // DDP_RANKS  # per rank; the global batch stays 32
# Both ranks share the one card, given explicitly (LOCAL_RANK 1 has none).
DDP_DEVICE = "cuda:0"
# Phase 10's transformer: t5-large at full width, its depth cut to 2 + 2
# blocks (the text tower and the Swin tower whole; 6 + 6 until phase 15
# took its room): gloo's host all-reduce of the gradients and the
# checkpoints shrink with it.
DDP_LAYERS = 2
T5_DDP = "t5-large-2x2"
T5_NO_DROPOUT = "t5-large-2x2-dropout-0"
DDP_LAUNCHES = loop_launches(DDP_LAYERS)
DDP_LAUNCHES_NO_DROPOUT = loop_launches(DDP_LAYERS, dropout=False)
# One rank's device memory, reckoned before the first run (GB): the fp32
# weights (~0.515 B parameters: the towers' 0.422 B, the 2 + 2 blocks and
# shared embedding's 0.093 B, the projection), the transformer's and the
# projection's fp32 gradients (DDP's bucket views: no second copy), Adam's
# two fp32 moments, activations at 16 rows (phase 6's 35.14 GB peak at 32
# rows less its state, halved, the transformer's part a twelfth: 3.0), and
# the frozen towers' copy that the bitwise check holds.
DDP_MEMORY_GB = dict(weights=2.06, gradients=0.37, adam=0.74,
                     activations=3.0, frozen_copy=1.69)
# Two ranks against one process, bf16 compute: the ranks' GEMMs run at
# batch 16 (other cuBLAS tilings than batch 32's, so other bf16 roundings
# of the activations) and their gradients meet in gloo's fp32 sum. Losses
# within phase 4's 1e-2 (TOL_TRAIN_LOSS_REL). Parameters after the run: each
# trainable tensor's update (final minus initial) at cosine >= 0.99 against
# the one process's, and no element further from the one process's than
# 2 lr per update: Adam moves an element by about lr per update whatever
# its gradient's size, so a gradient near 0 whose sign the rounding flips
# parts the two runs by up to 2 lr an update (4 updates at lr 1e-3: 8e-3,
# which is up to a third of the largest value of t5-large's q kernels,
# initialized at std (1024 * 64) ** -0.5; the largest difference over the
# largest value is printed beside it).
TOL_DDP = dict(loss=TOL_TRAIN_LOSS_REL, update_cosine=0.99,
               param_abs_per_update=2.0)  # x lr


def register_no_dropout() -> None:
    """Phase 10's t5-large of ``DDP_LAYERS`` + ``DDP_LAYERS`` blocks, with
    its dropout and with dropout 0 (for the runs that phase 10 compares
    across world sizes: each rank draws its own masks), and phase 14's and
    15's at dropout 0."""
    from klab_multimodalmodel_tpu_torch import config as tcfg

    cut = dataclasses.replace(tcfg.T5_SIZES["t5-large"],
                              num_layers=DDP_LAYERS,
                              num_decoder_layers=DDP_LAYERS)
    tcfg.register_t5_size(T5_DDP, cut)
    tcfg.register_t5_size(T5_NO_DROPOUT, dataclasses.replace(
        cut, dropout_rate=0.0))
    tcfg.register_t5_size(INIT_T5, dataclasses.replace(
        tcfg.T5_SIZES["t5-11b"], num_layers=INIT_LAYERS,
        num_decoder_layers=INIT_LAYERS, dropout_rate=0.0))
    for name, layers in ((T5_SEQ, SEQ_LAYERS), (T5_SPLIT, SPLIT_LAYERS)):
        tcfg.register_t5_size(name, dataclasses.replace(
            cut, num_layers=layers, num_decoder_layers=layers,
            dropout_rate=0.0))


def ddp_config(root: str, tag: str, dropout: bool = True, **kw):
    """Phase 6's set-up (the Config defaults, both kernel flags, the
    frozen-feature cache) at ``batch_size`` per rank, the transformer cut
    to ``DDP_LAYERS`` + ``DDP_LAYERS`` blocks."""
    from klab_multimodalmodel_tpu_torch.config import Config

    kw["transformer_model_name"] = T5_DDP if dropout else T5_NO_DROPOUT
    return Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                  seed=SEED, data_dir="synthetic", num_epochs=LOOP_EPOCHS,
                  cache_frozen_features=True,
                  result_dir=os.path.join(root, tag), **kw)


class FrozenWatch:
    """Copies the frozen parameters of the model that
    ``Trainer.init_state`` makes (on its device), and with ``trainable`` its
    trainable ones to the host; ``unchanged(model)`` holds the frozen ones
    bitwise against the model's."""

    def __init__(self, trainable: bool = False):
        self.keep_trainable = trainable
        self.frozen, self.trainable = {}, {}

    def __enter__(self):
        from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

        self._orig = Trainer.init_state
        watch = self

        def init_state(trainer, *args, **kw):
            model = watch._orig(trainer, *args, **kw)
            watch.frozen = {n: p.detach().clone()
                            for n, p in model.named_parameters()
                            if not p.requires_grad}
            if watch.keep_trainable:
                watch.trainable = trainable_on_host(model)
            return model
        Trainer.init_state = init_state
        return self

    def __exit__(self, *exc):
        from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

        Trainer.init_state = self._orig

    def unchanged(self, model) -> bool:
        import torch

        live = dict(model.named_parameters())
        return bool(self.frozen) and all(
            torch.equal(live[n], p) for n, p in self.frozen.items())


def trainable_on_host(model) -> dict:
    """A host copy, in fp32, of the model's trainable parameters."""
    import torch

    return {n: p.detach().to("cpu", torch.float32, copy=True)
            for n, p in model.named_parameters() if p.requires_grad}


def first_mask_bits(generator, device) -> str:
    """The first 2^20 keep bits of the (16, 320, 1024) dropout mask at rate
    0.1 that a generator seeded as ``generator`` was gives first, packed, as
    hex: the loop's first draw on this rank."""
    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch.models.layers import dropout

    g = torch.Generator(device=device).manual_seed(generator.initial_seed())
    ones = torch.ones(DDP_BATCH, ENC_LEN, 1024, device=device)
    keep = dropout(ones, RATE, g) != 0
    return np.packbits(keep.flatten()[:1 << 20].cpu().numpy()).tobytes().hex()


def ddp_rank_main(spec_path: str) -> int:
    """One rank of phase 10's job (started by ``torch.distributed.run``):
    the spec's ``train()`` runs in turn on ``cuda:0``, which both ranks
    share (gloo on CUDA tensors: ``KLAB_CPU_COLLECTIVES=gloo``); this
    rank's readings to ``{out}.{rank}.json``."""
    import shutil

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.utils.mesh import (
        maybe_init_distributed)

    with open(spec_path) as f:
        spec = json.load(f)
    register_no_dropout()
    device = torch.device(DDP_DEVICE)
    maybe_init_distributed(device)
    rank, card = dist.get_rank(), spec["card"]
    tol_loss, tol_param = spec["determinism_gap"]
    readings, kept = {}, {}
    for run in spec["runs"]:
        cfg = Config.from_json(json.dumps(run["config"]))
        profile = ({"full step": (2, None)}
                   if rank == 0 and run.get("profile") else None)
        with FrozenWatch() as frozen:
            r, out = loop_run(
                cfg, card, f"{run['tag']} rank {rank}", profile,
                phase=run["tag"], device=device,
                expected=(DDP_LAUNCHES if run.get("dropout", True)
                          else DDP_LAUNCHES_NO_DROPOUT),
                spans=("all_reduce",))
        model = out["trainer"].model
        check(out["trainer"].ddp is not None, "train() made no DDP wrapper")
        r["frozen_unchanged"] = frozen.unchanged(model)
        check(r["frozen_unchanged"], f"{run['tag']}: frozen towers moved")
        r["saves"] = [s["name"] for s in out["saves"]]
        r["peak_gb"] = max(k["peak_gb"] for k in r["step_kinds"].values())
        r["generator_seed"] = out["generator"].initial_seed()
        r["images_per_s"] = [m["img_per_sec"] for m in r["metrics"]]
        # A run's first step carries the warm-up: the steady span is the
        # mean of the later unprofiled ones.
        spans = r["step_kinds"].get("full step", {}).get("span_ms", [])[1:]
        r["steady_full_step_ms"] = sum(spans) / len(spans) if spans else None
        if run.get("mask"):
            r["mask_bits"] = first_mask_bits(out["generator"], device)
        if run.get("params") and rank == 0:
            torch.save(trainable_on_host(model), run["params"])
        if run.get("load_check") and rank == 0:
            # The checkpoint that rank 0 alone wrote loads strictly.
            from klab_multimodalmodel_tpu_torch.checkpoint.io import (
                read_whole)
            model.load_state_dict(read_whole(os.path.join(
                cfg.result_dir, "checkpoints", "best")), strict=True)
            r["best_loaded_strict"] = True
        if run.get("keep"):
            kept[run["keep"]] = (r, trainable_on_host(model))
        if run.get("against") in kept:
            ref, ref_params = kept.pop(run["against"])
            gap = 0.0
            for n, p in trainable_on_host(model).items():
                if not torch.equal(p, ref_params[n]):
                    gap = max(gap, max_err(p, ref_params[n]))
            r["param_gap"] = gap
            r["losses_equal"] = r["losses"] == ref["losses"]
            check(gap <= tol_param and (r["losses_equal"] or all(
                same(x, y, tol_loss) for ph in ("train", "val")
                for x, y in zip(r["losses"][ph], ref["losses"][ph]))),
                f"{run['tag']} rank {rank}: resumed run differs from the "
                f"uninterrupted one: parameters {gap:.3e}, losses "
                f"{r['losses']} vs {ref['losses']}")
        del out, model
        free()
        dist.barrier()
        if rank == 0 and run.get("clean"):
            shutil.rmtree(cfg.result_dir, ignore_errors=True)
        for step in r["step_kinds"].values():
            step.pop("span_ms")  # keep the means
        readings[run["tag"]] = {k: v for k, v in r.items()
                                if k not in ("metrics", "host_calls")}
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(readings, f, default=str)
    dist.destroy_process_group()
    return 0


def update_agreement(got: dict, want: dict, init: dict) -> dict:
    """Per trainable tensor (host copies, compared on the card): the cosine
    of the two runs' updates (final minus initial), the largest
    difference, and that over the largest value."""
    import torch

    rows = {}
    for n, w in want.items():
        g, w, i = (t.to(DDP_DEVICE, torch.float64)
                   for t in (got[n], w, init[n]))
        cos = float(torch.nn.functional.cosine_similarity(
            (g - i).flatten(), (w - i).flatten(), dim=0))
        diff = float((g - w).abs().max())
        rows[n] = dict(cosine=cos, abs=diff,
                       rel=diff / max(float(w.abs().max()), 1e-30))
    return rows


def ddp_phase(card: str, determinism: dict) -> dict:
    """Phase 10: 10c, one process over NCCL (world 1, the DDP reducer on
    the card), which is also the reference of 10a; then one
    ``torch.distributed.run`` job of two ranks on the one card (gloo on
    CUDA tensors) that runs 10a and 10b's three runs in turn."""
    import shutil
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    register_no_dropout()
    root = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    free()
    total = sum(DDP_MEMORY_GB.values())
    print(f"phase 10: memory reckoned per rank at batch {DDP_BATCH}: "
          + ", ".join(f"{k} {v:.2f}" for k, v in DDP_MEMORY_GB.items())
          + f" = {total:.2f} GB; {DDP_RANKS} ranks {DDP_RANKS * total:.2f}"
          f" GB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}; "
          f"this process holds {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB [{card}]")
    try:
        # 10c: world 1 over NCCL, 2 epochs at batch 32, dropout 0.
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
        try:
            cfg = ddp_config(root, "10c", dropout=False,
                             batch_size=TRAIN_BATCH)
            # The seed's initial weights, as every run of the phase's.
            with FrozenWatch(trainable=True) as watch:
                one, out = loop_run(cfg, card, "10c (one rank over NCCL)",
                                    phase="10c", device=DDP_DEVICE,
                                    expected=DDP_LAUNCHES_NO_DROPOUT)
            check(watch.unchanged(out["trainer"].model),
                  "10c: frozen towers moved")
            check(out["trainer"].ddp is not None
                  and dist.get_backend() == "nccl",
                  "10c: no DDP wrapper over NCCL")
            one_params = trainable_on_host(out["trainer"].model)
            init_params = watch.trainable
            del out, watch
        finally:
            dist.destroy_process_group()
        free()
        shutil.rmtree(cfg.result_dir, ignore_errors=True)
        print(f"10c: train() over NCCL, world 1: {one['steps']} updates, "
              f"losses {one['losses']} [{card}]")

        def run(tag, result_dir, dropout=True, **kw):
            c = ddp_config(root, result_dir, dropout=dropout,
                           batch_size=DDP_BATCH, **kw)
            return dict(tag=tag, dropout=dropout,
                        config=json.loads(c.to_json()))
        params_path = os.path.join(root, "10a.params.pt")
        spec = dict(card=card, out=os.path.join(root, "rank"),
                    determinism_gap=[determinism["gap"]["loss"],
                                     determinism["gap"]["params"]],
                    runs=[
            dict(run("10a", "10a", dropout=False), profile=True, clean=True,
                 params=params_path, load_check=True),
            dict(run("10b-uninterrupted", "10b-u"), mask=True, keep="U",
                 clean=True),
            dict(run("10b-halt", "10b-r", halt_after_steps=LOOP_HALT)),
            dict(run("10b-resume", "10b-r", halt_after_steps=LOOP_HALT),
                 against="U", clean=True)])
        spec_path = os.path.join(root, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, KLAB_CPU_COLLECTIVES="gloo",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        log_path = os.path.join(out_dir, "phase10_ranks.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", str(DDP_RANKS),
                 os.path.abspath(__file__), "--ddp-rank", spec_path],
                env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                timeout=900)
        job_s = time.perf_counter() - t0
        if proc.returncode != 0:
            with open(log_path) as f:
                print(f.read()[-6000:])
        check(proc.returncode == 0, f"phase 10's torchrun job exited "
              f"{proc.returncode} (chiprun_out/phase10_ranks.log)")
        ranks = []
        for r in range(DDP_RANKS):
            with open(f"{spec['out']}.{r}.json") as f:
                ranks.append(json.load(f))
        ddp_params = torch.load(params_path, weights_only=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    a = [rk["10a"] for rk in ranks]
    # 10a: the ranks agree with each other bitwise (all-reduced values)...
    check(a[0]["step_losses"] == a[1]["step_losses"]
          and a[0]["losses"] == a[1]["losses"],
          f"10a: the ranks' losses differ: {a[0]['step_losses']} vs "
          f"{a[1]['step_losses']}")
    # ... and with one process within TOL_DDP.
    check(len(a[0]["step_losses"]) == len(one["step_losses"])
          and all(abs(x - y) <= TOL_DDP["loss"] * abs(y) for x, y in zip(
              a[0]["step_losses"], one["step_losses"])),
          f"10a: step losses {a[0]['step_losses']} vs one process "
          f"{one['step_losses']}")
    check(abs(a[0]["min_val_loss"] - one["min_val_loss"])
          <= TOL_DDP["loss"] * abs(one["min_val_loss"]),
          f"10a: min_val_loss {a[0]['min_val_loss']} vs "
          f"{one['min_val_loss']}")
    agree = update_agreement(ddp_params, one_params, init_params)
    del ddp_params, one_params, init_params
    free()
    worst_cos = min(agree, key=lambda n: agree[n]["cosine"])
    worst_abs = max(agree, key=lambda n: agree[n]["abs"])
    worst_rel = max(agree, key=lambda n: agree[n]["rel"])
    bound = TOL_DDP["param_abs_per_update"] * cfg.lr * LOOP_UPDATES
    print(f"10a: 2 ranks vs one process: step losses "
          f"{a[0]['step_losses']} vs {one['step_losses']}; min_val_loss "
          f"{a[0]['min_val_loss']} vs {one['min_val_loss']}; updates of "
          f"{len(agree)} trainable tensors: lowest cosine "
          f"{agree[worst_cos]['cosine']:.6f} ({worst_cos}), largest "
          f"difference {agree[worst_abs]['abs']:.3e} ({worst_abs}; bound "
          f"{bound:.1e}), largest over the tensor's largest value "
          f"{agree[worst_rel]['rel']:.3e} ({worst_rel}) [{card}]")
    check(all(v["cosine"] >= TOL_DDP["update_cosine"] and v["abs"] <= bound
              for v in agree.values()),
          "10a: trainable tensors outside TOL_DDP")
    check(a[0]["saves"] and not a[1]["saves"]
          and a[0].get("best_loaded_strict"),
          f"10a: saves {a[0]['saves']} / {a[1]['saves']}")
    # 10b: halts after update 3 on both ranks, resumes exactly, and the
    # ranks drew different masks.
    for rk in ranks:
        h, res = rk["10b-halt"], rk["10b-resume"]
        check(h["halted"] and h["steps"] == LOOP_HALT,
              f"10b: halted {h['halted']} after {h['steps']}")
        check(not res["halted"] and res["steps"] == LOOP_UPDATES,
              f"10b: resumed run ended after {res['steps']}")
    bits = [bytes.fromhex(rk["10b-uninterrupted"]["mask_bits"])
            for rk in ranks]
    differ = sum(bin(x ^ y).count("1") for x, y in zip(*bits))
    keep = sum(bin(x).count("1") for x in bits[0]) / (8 * len(bits[0]))
    check(differ > 0, "10b: the ranks drew the same dropout masks")
    print(f"10b: resumed = uninterrupted, rank 0 / 1: parameters "
          f"{ranks[0]['10b-resume']['param_gap']:.3e} / "
          f"{ranks[1]['10b-resume']['param_gap']:.3e}, losses equal "
          f"{ranks[0]['10b-resume']['losses_equal']} / "
          f"{ranks[1]['10b-resume']['losses_equal']}; the ranks' first "
          f"masks differ in {differ} of {8 * len(bits[0])} keep bits (keep "
          f"fraction {keep:.4f}); seeds "
          f"{[rk['10b-uninterrupted']['generator_seed'] for rk in ranks]}")
    for r, rk in enumerate(ranks):
        for tag, rd in rk.items():
            kinds = ", ".join(
                f"{k} {v['calls']}x {v['mean_span_ms'] or 0:.2f} ms "
                f"launches {v['launches']}"
                for k, v in rd["step_kinds"].items())
            print(f"  {tag} rank {r}: {rd['seconds']:.2f} s, peak "
                  f"{rd['peak_gb']:.2f} GB; {kinds}")
    prof = ranks[0]["10a"]["profiles"].get("full step", {})
    steady = a[0]["steady_full_step_ms"]
    busy = prof.get("busy_ms")
    share = busy / steady if busy and steady else None
    print(f"phase 10 [{card}]: job {job_s:.2f} s; 10a images/s (global) "
          f"by epoch {a[0]['images_per_s']}; steady full step per rank "
          f"{[rk['10a']['steady_full_step_ms'] for rk in ranks]} ms; "
          f"profiled rank-0 full step: busy {busy} ms, {share} of rank "
          f"0's steady step, all-reduce device ms "
          f"{(prof.get('span_ms') or {}).get('all_reduce')}, host "
          f"{(prof.get('span_host_ms') or {}).get('all_reduce')}")
    return dict(card=card, memory_reckoned_gb=DDP_MEMORY_GB, job_s=job_s,
                busy_share_steady=share,
                one_process=one, ranks=ranks, agreement=dict(
                    worst_cosine=agree[worst_cos], worst_abs=agree[worst_abs],
                    worst_rel=agree[worst_rel]),
                mask_bits_differ=differ, param_bound=bound)


# ---------------------------------------------------------------------------
# Phase 11: mixture of experts at full width
# ---------------------------------------------------------------------------

MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25,
           moe_aux_loss_weight=0.01)
MOE_STEPS = 3
# Phase 4's peak at batch 32 as PERF.md section 5 records it, the base of
# 11a's reckoning when phase 4 did not run in this call.
PHASE4_PEAK_GB = 36.83
# The reckoned peak above which 11a trains at batch 16 instead of 32: the
# card's 80 GB less room for the allocator's fragmentation.
MOE_MEMORY_LIMIT_GB = 76.0


def moe_memory(cfg, batch: int, phase4_peak_gb: float) -> dict:
    """11a's peak memory, reckoned before anything is built: phase 4's
    measured peak (the dense step at batch 32; its activations scale with
    the batch) plus what the experts add. State: each parameter that the
    experts add over the dense MLPs in fp32 with its gradient and Adam's two
    moments (16 bytes). Activations, per MoE block over a dense one, the
    tensors that autograd keeps in bf16 (2 bytes) at capacity C of S
    tokens: the dispatched input and expert output (E G C D each), the ReLU
    output, the dropped hidden (E G C F each, and the 1-byte keep mask),
    dispatch and combine (G S E C each), the top-k passes' fp32 slot masks
    (k G S E C), and the bf16 casts of both expert banks (2 E D F), less the
    dense MLP's hidden, dropped hidden and mask (5 bytes G S F) and its
    casts (2 D F)."""
    from klab_multimodalmodel_tpu_torch.ops.moe import moe_capacity

    t5 = cfg.transformer_t5
    E, k, D, F = cfg.moe_experts, cfg.moe_top_k, t5.d_model, t5.d_ff
    layers = t5.num_layers + t5.num_decoder_layers
    added = layers * (2 * (E - 1) * D * F + E * D)
    state_gb = added * 16 / 1e9
    act = 0
    for n, S in ((t5.num_layers,
                  cfg.swin.num_patches_out + cfg.max_source_length),
                 (t5.num_decoder_layers, cfg.max_target_length)):
        C = moe_capacity(S, E, k, cfg.moe_capacity_factor)
        moe = (2 * (2 * E * batch * C * D) + (2 + 2 + 1) * E * batch * C * F
               + 2 * 2 * batch * S * E * C + 4 * k * batch * S * E * C
               + 2 * 2 * E * D * F)
        dense = 5 * batch * S * F + 2 * 2 * D * F
        act += n * (moe - dense)
    base = phase4_peak_gb * batch / TRAIN_BATCH
    total = base + state_gb + act / 1e9
    return dict(batch=batch, base_gb=base, state_gb=state_gb,
                activations_gb=act / 1e9, total_gb=total,
                added_parameters=added)


class RoutingRecorder:
    """Wraps the model's ``topk_routing`` (and ``moe_ffn``) while in use:
    each routing call's assignments (combine > 0) and router logits, in
    call order, the (token, expert) choices of its real tokens that the
    capacity dropped (``dropped``, 0-d tensors: read after the step), and
    a profiler range around each call (``moe routing``, ``moe ffn``) that
    ``profile_device`` reads apart. Under ``seq`` a call's rows are the
    rank's positions."""

    def __init__(self, keep: bool = True):
        self.keep = keep
        self.calls: list = []
        self.dropped: list = []

    def __enter__(self):
        from torch.profiler import record_function

        from klab_multimodalmodel_tpu_torch.models import t5

        self._saved = t5.topk_routing, t5.moe_ffn
        routing, ffn = self._saved
        rec = self

        def topk_routing(logits, top_k, capacity, mask=None, seq=None):
            with record_function("moe routing"):
                combine, aux = routing(logits, top_k, capacity, mask=mask,
                                       seq=seq)
            if rec.keep:
                assigned = combine.detach() > 0
                rec.calls.append((assigned, logits.detach()))
                real = logits.shape[0] * logits.shape[1]
                if mask is not None:
                    real = (mask if seq is None else mask.narrow(
                        1, seq.start, seq.rows)).float().sum()
                rec.dropped.append(top_k * real - assigned.any(-1).sum())
            return combine, aux

        def moe_ffn(*args, **kw):
            with record_function("moe ffn"):
                return ffn(*args, **kw)

        t5.topk_routing, t5.moe_ffn = topk_routing, moe_ffn
        return self

    def __exit__(self, *exc):
        from klab_multimodalmodel_tpu_torch.models import t5

        t5.topk_routing, t5.moe_ffn = self._saved


def routing_differences(a: list, b: list, top_k: int) -> dict:
    """Tokens whose assignments differ between two runs' routing calls
    (same inputs, same order). A token whose set of experts differs is a
    flip: the router's relative top-k margin there (the k-th probability
    over the next, in run ``a``) is printed. A token with the same experts
    in another slot was moved by an earlier token's flip in its group."""
    import torch

    check(len(a) == len(b), f"routing calls {len(a)} vs {len(b)}")
    tokens = flips = moved = 0
    margins = []
    for layer, ((ca, la), (cb, _)) in enumerate(zip(a, b)):
        tokens += ca.shape[0] * ca.shape[1]
        sets_a, sets_b = ca.any(-1), cb.any(-1)          # (G, S, E)
        flip = (sets_a != sets_b).any(-1)                # (G, S)
        slot = (ca != cb).any(-1).any(-1) & ~flip
        flips += int(flip.sum())
        moved += int(slot.sum())
        if flip.any():
            p = torch.softmax(la.float(), -1)[flip]
            top = p.topk(min(top_k + 1, p.shape[-1]), -1).values
            rel = (top[:, top_k - 1] - top[:, top_k]) / top[:, top_k - 1]
            margins += [(layer, float(m)) for m in rel]
    for layer, m in margins:
        print(f"  routing flip in routing call {layer}: the router's "
              f"relative top-{top_k} margin {m:.3e}")
    return dict(tokens=tokens, flipped=flips, moved_slot=moved,
                flip_margins=margins)


def fingerprint_to_host(named) -> dict:
    """Host copies of (name, tensor) pairs: the bitwise reference that a
    later check compares with."""
    return {n: p.detach().to("cpu", copy=True) for n, p in named}


def moe_train(card: str, phase4_peak_gb: float) -> tuple[dict, dict, object]:
    """11a: ``Trainer`` steps with 4 experts (top-2) in every MLP of the
    t5-large transformer, at full depth, both kernel flags, dropout on."""
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    cfg = Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                 seed=SEED, **MOE)
    reckoned = [moe_memory(cfg, b, phase4_peak_gb) for b in (TRAIN_BATCH,
                                                             TRAIN_BATCH // 2)]
    for r in reckoned:
        print(f"phase 11a: memory reckoned at batch {r['batch']}: "
              f"{r['total_gb']:.2f} GB = phase 4's peak scaled "
              f"{r['base_gb']:.2f} + the experts' state "
              f"{r['state_gb']:.2f} ({r['added_parameters']} parameters "
              f"added) + activations {r['activations_gb']:.2f}")
    batch_rows = next((r["batch"] for r in reckoned
                       if r["total_gb"] <= MOE_MEMORY_LIMIT_GB), None)
    check(batch_rows is not None, "11a fits at neither batch")
    if batch_rows != TRAIN_BATCH:
        print(f"phase 11a: batch {TRAIN_BATCH} is reckoned over "
              f"{MOE_MEMORY_LIMIT_GB} GB: training at batch {batch_rows}")
    trainer = Trainer(cfg)
    model = trainer.init_state(
        torch.Generator(device="cuda").manual_seed(cfg.seed))
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    moe_names = [n for n, _ in model.named_parameters() if ".mlp." in n]
    check(n_train == TRAINABLE_T5_PROJ + reckoned[0]["added_parameters"],
          f"trainable parameters {n_train}")
    check(len(moe_names) == 3 * 48, f"{len(moe_names)} MoE tensors")
    frozen = fingerprint_to_host((n, p) for n, p in model.named_parameters()
                                 if not p.requires_grad)
    moe0 = fingerprint_to_host((n, model.get_parameter(n))
                               for n in moe_names)
    print(f"MoE training model: {n_train} trainable parameters, "
          f"{sum(moe0[n].numel() for n in moe_names)} of them in the "
          f"routers and expert banks [{card}]")
    batch = train_batch(cfg, batch_rows, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    auxes = []
    forward = model.transformer.forward

    def recording(*args, **kw):
        out = forward(*args, **kw)
        auxes.append(out.aux_loss.detach())
        return out

    model.transformer.forward = recording
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(trainer.train_step(batch, gen))]  # warm-up step
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    step_ms, timed, per_step = timed_steps(trainer, batch, gen, MOE_STEPS,
                                           STEP_LAUNCHES, "MoE training step")
    losses += timed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    aux = [float(a) for a in auxes]
    print(f"MoE losses (warm-up, then {MOE_STEPS} steps, dropout on): "
          + ", ".join(f"{x:.4f}" for x in losses) + "; balance losses "
          + ", ".join(f"{x:.4f}" for x in aux))
    check(all(math.isfinite(x) for x in losses + aux),
          f"non-finite loss {losses} or aux {aux}")
    check(losses[-1] < losses[0], f"MoE loss did not fall: {losses}")
    for n, p in model.named_parameters():
        if n in frozen:
            check(torch.equal(p.detach().cpu(), frozen[n]),
                  f"frozen {n} changed")
    still = [f"{n}[{e}]" for n in moe_names
             for e in range(model.get_parameter(n).shape[0])
             if torch.equal(model.get_parameter(n)[e].detach().cpu(),
                            moe0[n][e])]
    check(not still, f"MoE slices that did not move: {still[:8]}")
    print(f"every router and expert slice moved ({len(moe_names)} tensors); "
          f"the frozen towers are bitwise unchanged ({len(frozen)} tensors)")
    del frozen, moe0
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"MoE train step: {mean_ms:.2f} ms mean over {MOE_STEPS} "
          f"({', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{batch_rows / (mean_ms / 1e3):.2f} images/s, first step "
          f"{first_ms:.2f} ms, peak memory {peak_gb:.2f} GB (reckoned "
          f"{reckoned[0 if batch_rows == TRAIN_BATCH else 1]['total_gb']:.2f}"
          f") [{card}]")
    with RoutingRecorder(keep=False):
        device = profile_device(lambda: trainer.train_step(batch, gen),
                                mean_ms, card, "MoE training step",
                                ("moe routing", "moe ffn", "BmmBackward0",
                                 OPT_SPAN))
    model.transformer.forward = forward
    result = dict(card=card, reckoned=reckoned, batch=batch_rows,
                  trainable=n_train, losses=losses, aux_losses=aux,
                  first_step_ms=first_ms, step_ms=step_ms,
                  mean_step_ms=mean_ms,
                  images_per_s=batch_rows / (mean_ms / 1e3),
                  peak_memory_gb=peak_gb, launches_per_step=per_step,
                  device=device)
    return result, cfg, trainer


def moe_vs_plain(cfg, state: dict) -> dict:
    """11b: batch 8, dropout off, on 11a's weights, fp32 compute: the loss
    and every trainable gradient with the kernels against the same path
    without them (phase 4's ``TOL_TRAIN_GRAD``), and the routing
    assignments of the two runs compared token by token."""
    batch = train_batch(cfg, CMP_BATCH, SEED + 2)
    runs, routing = {}, {}
    for path in ("kernels", "none"):
        with RoutingRecorder() as rec:
            runs[path] = path_grads(cfg, state, "float32", batch, path)
        routing[path] = rec.calls
    diff = routing_differences(routing["kernels"], routing["none"],
                               cfg.moe_top_k)
    print(f"phase 11b: routing, kernels vs none: {diff['flipped']} of "
          f"{diff['tokens']} token-routings flipped an expert, "
          f"{diff['moved_slot']} moved slot")
    out = agreement(runs["kernels"], runs["none"],
                    "MoE, float32, kernels vs none", TOL_TRAIN_GRAD)
    out["routing"] = diff
    return out


def stepwise_greedy(t5, enc, mask, L: int):
    """The stepwise oracle of greedy decoding (the JAX package's
    tests/test_moe.py:473): a hand-written argmax loop over ``decode_step``
    with its cache, pad after eos."""
    import torch

    s = t5.size
    B = enc.shape[0]
    tok = torch.full((B, L), s.pad_token_id, dtype=torch.int32,
                     device=enc.device)
    tok[:, 0] = s.decoder_start_token_id
    finished = torch.zeros(B, dtype=torch.bool, device=enc.device)
    cache = None
    with torch.inference_mode():
        for t in range(L - 1):
            logits, cache = t5.decode_step(tok[:, t:t + 1], t, enc, L, mask,
                                           cache=cache)
            nxt = logits[:, -1].argmax(-1).to(torch.int32)
            nxt = torch.where(finished, s.pad_token_id, nxt)
            tok[:, t + 1] = nxt
            finished |= nxt == s.eos_token_id
            if bool(finished.all()):
                break
    return tok


def moe_serve(card: str, cfg, state: dict, phase3_request_ms) -> dict:
    """11c: three batch-8 greedy requests through ``Captioner`` on 11a's
    weights (fp32, both kernel flags): 24 Swin and 48 T5 launches each, the
    tokens against the stepwise oracle, and eight rows through a
    ``DecodeEngine`` against ``greedy_decode`` (routing groups are rows)."""
    import numpy as np
    import torch

    from klab_multimodalmodel_tpu_torch.infer.captioner import Captioner
    from klab_multimodalmodel_tpu_torch.ops import swin_attention, t5_attention
    from klab_multimodalmodel_tpu_torch.text import ByteTokenizer

    c = dataclasses.replace(cfg, compute_dtype="float32")
    cap = Captioner(c, state, ByteTokenizer())
    rng = np.random.default_rng(SEED)
    size = c.swin.image_size
    requests = [rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)
                for _ in range(REQUESTS + 1)]
    cap.caption(requests[0])  # warm-up
    reset_counts()
    per_request, all_ids = [], []
    for images in requests[1:]:
        s0, t0_count = swin_attention.launches, t5_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = cap.caption_launch(images)
        cap.caption_finish(ids)
        ms = (time.perf_counter() - t0) * 1e3
        got = dict(swin=swin_attention.launches - s0,
                   t5=t5_attention.launches - t0_count)
        check(got == dict(swin=24, t5=48),
              f"MoE request launches {got}, expected 24 Swin and 48 T5")
        check(tuple(ids.shape) == (BATCH, c.generate_max_length),
              f"token shape {tuple(ids.shape)}")
        per_request.append(dict(ms=ms, passes=decoder_passes(ids.cpu())))
        all_ids.append(ids)
    launches = dict(swin=swin_attention.launches, t5=t5_attention.launches)
    equal = 0
    for images, ids in zip(requests[1:], all_ids):
        enc, mask = cap._encode_prefill(images, None)
        want = stepwise_greedy(cap.decode_model, enc, mask,
                               c.generate_max_length)
        check(torch.equal(ids, want), "MoE greedy tokens differ from the "
              "stepwise decode_step oracle")
        equal += int(torch.equal(ids, want))
    engine = engine_direct(card, cap, requests[1], label="11c")
    times = [r["ms"] for r in per_request]
    mean_ms = sum(times) / len(times)
    print(f"phase 11c [{card}]: MoE request {mean_ms:.2f} ms mean "
          f"({', '.join(f'{t:.2f}' for t in times)}; phase 3's dense "
          f"request {phase3_request_ms} ms), {equal} of {REQUESTS} requests "
          f"equal the stepwise oracle")
    del cap
    free()
    return dict(requests=per_request, request_ms=mean_ms,
                phase3_request_ms=phase3_request_ms, launches=launches,
                oracle_equal=equal, engine=engine)


def moe_phase(card: str, phase4: dict | None = None,
              phase3: dict | None = None) -> dict:
    """Phase 11: 11a training steps, 11b kernels vs none, 11c serving."""
    t_phase = time.perf_counter()
    peak4 = phase4["peak_memory_gb"] if phase4 else PHASE4_PEAK_GB
    train_out, cfg, trainer = moe_train(card, peak4)
    trainer.optimizer = trainer.scheduler = None  # Adam's moments go
    model = trainer.model
    del trainer
    model.zero_grad(set_to_none=True)
    free()
    state = model.state_dict()
    out = dict(train=train_out)
    out["vs_plain"] = moe_vs_plain(cfg, state)
    out["serve"] = moe_serve(card, cfg, state,
                             phase3["request_ms"] if phase3 else None)
    del model, state
    free()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the GPipe schedule at full width
# ---------------------------------------------------------------------------

GPIPE = dict(pipeline_stages=4, pipeline_microbatches=8)
GPIPE_BATCH, GPIPE_STEPS = 16, 2
# The T5 kernel is off (the JAX package refuses it with a pipeline): a step
# launches only the Swin kernel.
GPIPE_LAUNCHES = dict(t5_fwd=0, t5_fwd_dropout=0, t5_bwd=0, t5_bwd_dbias=0,
                      swin=24)


def gpipe_phase(card: str) -> dict:
    """Phase 12: phase 4's set-up at batch 16 with the T5 kernel off, the
    transformer's two stacks run as 4 GPipe stages of 8 microbatches: steps
    beside the same weights at one stage, then, dropout off and in fp32
    compute, the loss and every gradient against one stage."""
    import torch

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    base = dict(use_pallas_attention=True, seed=SEED)
    configs = {4: Config(**base, **GPIPE), 1: Config(**base)}
    batch = train_batch(configs[1], GPIPE_BATCH, SEED)
    runs = {}
    for stages, cfg in configs.items():
        trainer = Trainer(cfg)
        trainer.init_state(  # the same seeded weights at either count
            torch.Generator(device="cuda").manual_seed(cfg.seed))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        first = float(trainer.train_step(batch, gen))  # warm-up step
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses, per_step = timed_steps(
            trainer, batch, gen, GPIPE_STEPS, GPIPE_LAUNCHES,
            f"{stages}-stage step")
        losses = [first] + losses
        check(all(math.isfinite(x) for x in losses),
              f"{stages} stages: non-finite loss {losses}")
        check(losses[-1] < losses[0],
              f"{stages} stages: loss did not fall {losses}")
        runs[stages] = dict(step_ms=step_ms,
                            mean_step_ms=sum(step_ms) / len(step_ms),
                            peak_memory_gb=torch.cuda.max_memory_allocated()
                            / 1e9, losses=losses, launches_per_step=per_step)
        trainer.optimizer = trainer.scheduler = None
        model = trainer.model
        del trainer
        model.zero_grad(set_to_none=True)
        free()
    state = model.state_dict()  # the one-stage run's trained weights
    # Dropout off, fp32 compute: 4 stages against 1 on the same weights, at
    # phase 4's comparison batch (one row a microbatch).
    cmp_batch = train_batch(configs[1], CMP_BATCH, SEED + 2)
    cmp = {stages: path_grads(cfg, state, "float32", cmp_batch, "none")
           for stages, cfg in configs.items()}
    agree = agreement(cmp[4], cmp[1], "GPipe, float32, 4 stages vs 1",
                      TOL_TRAIN_GRAD)
    del model, state, cmp
    free()
    p, q = runs[4], runs[1]
    print(f"phase 12 [{card}]: batch {GPIPE_BATCH}, 4 stages x 8 "
          f"microbatches: step {p['mean_step_ms']:.2f} ms "
          f"({', '.join(f'{t:.2f}' for t in p['step_ms'])}), peak "
          f"{p['peak_memory_gb']:.2f} GB; 1 stage: step "
          f"{q['mean_step_ms']:.2f} ms "
          f"({', '.join(f'{t:.2f}' for t in q['step_ms'])}), peak "
          f"{q['peak_memory_gb']:.2f} GB; launches per step "
          f"{p['launches_per_step']}")
    seconds = time.perf_counter() - t_phase
    print(f"phase 12: {seconds:.1f} s")
    return dict(card=card, batch=GPIPE_BATCH, runs=runs, vs_one_stage=agree,
                seconds=seconds)


# Phases 13 to 19 run their multi-rank jobs on rank servers: the ranks of
# one ``torch.distributed.run`` started ahead of the phases that use them,
# so that their start (imports, CUDA, the process group) overlaps the
# script's own work, and kept for every job of one world size (phases 13,
# 14 and 15 on two ranks, 16 to 19 on four).
RANK_JOBS = {"shard": "shard_rank_main", "seq": "seq_rank_main",
             "split": "split_rank_main", "four": "four_rank_main"}


class RankServer:
    """``nproc`` ranks sharing the one card (gloo on CUDA tensors:
    ``KLAB_CPU_COLLECTIVES=gloo``), which re-enter this script with
    ``--rank-server DIR`` and wait there for jobs; their output goes to
    ``chiprun_out/{log_name}`` (a rank that crashes prints its Python
    stack: faulthandler)."""

    def __init__(self, nproc: int, log_name: str):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
        self.jobs = 0
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        self.log_name = log_name
        self.log = open(os.path.join(REPO, "chiprun_out", log_name), "w")
        env = dict(os.environ, KLAB_CPU_COLLECTIVES="gloo",
                   PYTHONFAULTHANDLER="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(nproc), os.path.abspath(__file__),
             "--rank-server", self.dir],
            env=env, cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT)

    def close(self) -> None:
        """End the ranks at once (torchrun passes SIGTERM on to them)."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def _fail(self, what: str) -> None:
        self.close()
        self.log.flush()
        with open(self.log.name) as f:
            print(f.read()[-6000:])
        check(False, f"{what} (chiprun_out/{self.log_name})")

    def submit(self, kind: str, spec_path: str) -> tuple:
        """Hand the ranks job ``kind`` on ``spec_path`` and return at once:
        the handle that ``join`` waits on. The ranks take their jobs in
        the order they were handed over."""
        n, self.jobs = self.jobs, self.jobs + 1
        tmp = os.path.join(self.dir, f".job.{n}")
        with open(tmp, "w") as f:
            json.dump(dict(kind=kind, spec=spec_path), f)
        os.replace(tmp, os.path.join(self.dir, f"job.{n}"))
        return n, time.perf_counter(), time.time()

    def join(self, handle: tuple, what: str, timeout: float = 900) -> float:
        """Wait until every rank has finished the job ``handle`` names;
        the seconds from its ``submit`` to its end (the time of its done
        mark: the caller may have come to wait later)."""
        n, t0, wall0 = handle
        done = os.path.join(self.dir, f"done.{n}")
        while not os.path.exists(done):
            if self.proc.poll() is not None:
                self._fail(f"{what}: the ranks exited "
                           f"{self.proc.returncode}")
            if time.perf_counter() - t0 > timeout:
                self._fail(f"{what}: not done in {timeout:.0f} s")
            time.sleep(0.05)
        return os.path.getmtime(done) - wall0

    def stop(self) -> None:
        """Let the ranks leave once their last job is done."""
        open(os.path.join(self.dir, "stop"), "w").close()

    def wait(self) -> None:
        """Wait for the ranks to leave (``stop`` first)."""
        import shutil

        try:
            rc = self.proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            self._fail("the ranks did not leave")
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        check(rc == 0, f"the ranks exited {rc} (chiprun_out/"
              f"{self.log_name})")


def finish(phase: Generator[None, None, dict]) -> dict:
    """The rest of a phase that yielded once its rank job was handed over
    (``shard_phase``, ``seq_phase``, ``split_phase``): its result."""
    try:
        next(phase)
    except StopIteration as end:
        return end.value
    raise RuntimeError("a phase yielded a second time")


def rank_server_main(job_dir: str) -> int:
    """One rank of a ``RankServer``: join the process group, then run each
    job handed to ``job_dir`` (``job.N``: a kind of ``RANK_JOBS`` and its
    spec) in turn, every rank, and mark it done (``done.N``, by rank 0
    once all ranks have finished it), until ``stop``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch.utils.mesh import (
        maybe_init_distributed)

    maybe_init_distributed(torch.device(DDP_DEVICE))
    n = 0
    while True:
        job = os.path.join(job_dir, f"job.{n}")
        while not os.path.exists(job):
            if os.path.exists(os.path.join(job_dir, "stop")):
                dist.destroy_process_group()
                return 0
            time.sleep(0.05)
        with open(job) as f:
            spec = json.load(f)
        globals()[RANK_JOBS[spec["kind"]]](spec["spec"])
        dist.barrier()
        if dist.get_rank() == 0:
            open(os.path.join(job_dir, f"done.{n}"), "w").close()
        n += 1


# ---------------------------------------------------------------------------
# Phase 13: sharded training (FSDP2 + tensor parallelism) at t5-3b's width
# ---------------------------------------------------------------------------

# t5-3b at full width, its depth cut to 1 + 1 blocks (24 + 24 would not fit
# the script's time with gloo's host staging and the one-process
# reference; 6 + 6 until phase 15 took its room, 2 + 2 until phase 16
# did), dropout 0 for the compared steps.
SHARD_LAYERS = 1
SHARD_T5 = f"t5-3b-{SHARD_LAYERS}x{SHARD_LAYERS}-dropout-0"
# One timed step: 13b's steps take 10-13 s of gloo's host staging each.
SHARD_BATCH, SHARD_STEPS = 16, 1
SHARD_RANKS = 2
SHARD_LAYOUTS = {"13b": (1, 2, 1), "13c": (1, 1, 2)}
SHARD_LAUNCHES = step_launches(T5_LAYERS, SHARD_LAYERS, SHARD_LAYERS,
                               dropout=False)
SHARD_LAUNCHES_DROPOUT = step_launches(T5_LAYERS, SHARD_LAYERS, SHARD_LAYERS)
# 13b and 13c against 13a, bf16 compute: 13b's ranks run their GEMMs at 8
# rows and meet in gloo's fp32 reduce-scatter; 13c's column-parallel
# products run at half the columns, its row-parallel ones (o, wo) sum two
# fp32 partials where one process accumulates the whole contraction, and
# the backward sums its partial input gradients in bf16. Held: the first step's gradient of every trainable
# tensor, from the same weights and rows, at phase 4's bf16 tolerance
# (TOL_TRAIN_GRAD: cosine >= 0.99, norm within 2 %, all together >= 0.999)
# and the losses of the three steps within phase 4's 1e-2. The updates
# after three Adam steps are printed, not held: Adam moves an element by
# about lr whatever its gradient's size, so where a gradient is near 0 a
# rounding flips its sign and parts the runs by up to 2 lr a step; t5-3b's
# ReLU MLP of d_ff 16384 has many such columns (on an H100: 13b's lowest
# per-tensor update cosine 0.9858, decoder block 5's wi, while every loss
# agreed within 2.6e-4).
TOL_SHARD = dict(loss=TOL_TRAIN_LOSS_REL, grad=TOL_TRAIN_GRAD)
# The T5 kernels at 13c's per-rank shapes: 16 heads of d_kv 128, rank 1's
# heads 16..31.
SHARD_HEADS, SHARD_D, SHARD_OFFSET = 16, 128, 16


def register_shard_sizes() -> None:
    """Phase 13's t5-3b of ``SHARD_LAYERS`` + ``SHARD_LAYERS`` blocks at
    dropout 0."""
    from klab_multimodalmodel_tpu_torch import config as tcfg

    tcfg.register_t5_size(SHARD_T5, dataclasses.replace(
        tcfg.T5_SIZES["t5-3b"], num_layers=SHARD_LAYERS,
        num_decoder_layers=SHARD_LAYERS, dropout_rate=0.0))


def shard_config(**kw):
    """Phase 4's set-up (the Config defaults, both kernel flags) with the
    transformer ``SHARD_T5``."""
    from klab_multimodalmodel_tpu_torch.config import Config

    return Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                  seed=SEED, transformer_model_name=SHARD_T5, **kw)


def shard_memory(card: str) -> dict:
    """Each layout's per-rank parameters, gradients and Adam moments (GB),
    reckoned on the meta device as ``parallelize`` lays them out."""
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        per_rank_bytes)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names

    cfg = shard_config()
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    shapes = [(n, tuple(p.shape), n in names)
              for n, p in model.named_parameters()]
    out = {}
    for tag, axes in (("13a", {}), ("13b", {"fsdp": 2}),
                      ("13c", {"tensor": 2})):
        out[tag] = {k: v / 1e9 for k, v in per_rank_bytes(shapes,
                                                           axes).items()}
    print("phase 13: state per rank reckoned (GB; params, grads, Adam): "
          + "; ".join(f"{t} {r['params']:.2f} + {r['grads']:.2f} + "
                      f"{r['moments']:.2f} = {r['total']:.2f}"
                      for t, r in out.items()) + f" [{card}]")
    return out


def shard_steps(trainer, batch: dict, gen, what: str,
                first_grads=None) -> dict:
    """One warm-up and ``SHARD_STEPS`` timed steps (launches checked
    against ``SHARD_LAUNCHES``): losses, step ms, peak memory.
    ``first_grads(trainer)`` runs after the warm-up, while the parameters
    hold its gradients."""
    import torch

    t0 = time.perf_counter()
    first = float(trainer.train_step(batch, gen))
    first_ms = (time.perf_counter() - t0) * 1e3
    if first_grads is not None:
        first_grads(trainer)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = timed_steps(trainer, batch, gen,
                                            SHARD_STEPS, SHARD_LAUNCHES, what)
    losses = [first] + losses
    check(all(math.isfinite(x) for x in losses),
          f"{what}: non-finite loss {losses}")
    return dict(losses=losses, first_step_ms=first_ms, step_ms=step_ms,
                mean_step_ms=sum(step_ms) / len(step_ms),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches_per_step=per_step)


def set_dropout(module, rate: float) -> None:
    """Every T5 module under ``module`` at dropout ``rate``."""
    from klab_multimodalmodel_tpu_torch.config import T5Size

    for m in module.modules():
        if isinstance(getattr(m, "size", None), T5Size):
            m.size = dataclasses.replace(m.size, dropout_rate=rate)


def replicated_mismatches(model) -> tuple[int, list]:
    """(parameters checked, names that differ from rank 0's): every
    parameter that no tensor rank splits, compared bitwise with rank 0's
    (broadcast). Each rank's shard is the whole parameter (fsdp 1)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        tensor_parallel)

    checked, bad = 0, []
    for n, p in model.named_parameters():
        if tensor_parallel(n):
            continue
        local = (p.to_local() if isinstance(p, DTensor) else p).detach()
        ref = local.clone()
        dist.broadcast(ref, src=0)
        checked += 1
        if not torch.equal(ref, local):
            bad.append(n)
    return checked, bad


def shard_rank_main(spec_path: str) -> int:
    """One rank of phase 13's job (on a ``RankServer`` rank):
    the spec's layouts in turn on ``cuda:0``, which both ranks share (gloo
    on CUDA tensors: ``KLAB_CPU_COLLECTIVES=gloo``); this rank's readings
    to ``{out}.{rank}.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        gather_full)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer
    from klab_multimodalmodel_tpu_torch.utils.mesh import (
        maybe_init_distributed)

    with open(spec_path) as f:
        spec = json.load(f)
    register_shard_sizes()
    device = torch.device(DDP_DEVICE)
    maybe_init_distributed(device)
    rank, card = dist.get_rank(), spec["card"]
    readings = {}
    for run in spec["runs"]:
        tag = run["tag"]
        cfg = Config.from_json(json.dumps(run["config"]))
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device=device)
        # Seeded with config.seed on the card: 13a's weights on every rank.
        trainer.init_state()
        mesh = trainer.mesh
        check(trainer.sharded and trainer.ddp is None,
              f"{tag}: the trainer is not sharded")
        build_s = time.perf_counter() - t0
        print(f"{tag} rank {rank}: sharded model built in {build_s:.2f} s",
              flush=True)
        full = train_batch(cfg, SHARD_BATCH, SEED)
        n = SHARD_BATCH // mesh.dp_size
        rows = {k: v[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]
                for k, v in full.items()}
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        names = trainable_names(trainer.model, cfg)

        def save_grads(t):
            # The warm-up step's gradients, gathered whole to rank 0.
            grads = {}
            for n, p in t.model.named_parameters():
                if n in names:
                    g = gather_full(p.grad.detach())
                    if rank == 0:
                        grads[n] = g.float().cpu()
            if rank == 0:
                torch.save(grads, run["grads"])
        r = shard_steps(trainer, rows, gen, f"{tag} rank {rank}",
                        save_grads)
        r.update(build_s=build_s, rows=n, dp=[mesh.dp_rank, mesh.dp_size],
                 tensor=[mesh.tensor_rank, mesh.tensor])
        if run.get("checkpoint"):
            # The checkpoint's gather gives the compared parameters too.
            r["saves"], r["checkpoint_s"] = checkpoint_once(
                trainer, run["checkpoint"], names, run["params"])
        else:
            t0 = time.perf_counter()
            whole = trainer.full_state_dict()
            if rank == 0:
                torch.save({k: v for k, v in whole.items() if k in names},
                           run["params"])
            del whole
            r["gather_s"] = time.perf_counter() - t0
        # One profiled step in 13c only: 13b's (a 10-13 s step of gloo's
        # host staging, its readings in PERF.md) would cost the script
        # ~15 s.
        r["profile"] = profile_device(
            lambda: trainer.train_step(rows, gen), r["mean_step_ms"], card,
            f"{tag} rank {rank} step", collectives=True,
            against_averages=True) if run.get("profile") else {}
        if run.get("dropout_step"):
            # One step at dropout 0.1, then the parameters that no tensor
            # rank splits, bitwise across the ranks.
            set_dropout(trainer.model.transformer, RATE)
            reset_counts()
            loss = float(trainer.train_step(rows, gen))
            got = launch_counts()
            check(got == SHARD_LAUNCHES_DROPOUT,
                  f"{tag}: launches of the dropout step {got}")
            checked, bad = replicated_mismatches(trainer.model)
            r.update(dropout_loss=loss, replicated_checked=checked,
                     replicated_differ=bad)
            check(math.isfinite(loss) and checked > 0 and not bad,
                  f"{tag} rank {rank}: dropout loss {loss}, {len(bad)} of "
                  f"{checked} replicated parameters differ across the "
                  f"tensor ranks: {bad[:5]}")
        print(f"{tag} rank {rank} [{card}]: build {build_s:.2f} s, losses "
              f"{r['losses']}, steps "
              f"{', '.join(f'{t:.2f}' for t in r['step_ms'])} ms, peak "
              f"{r['peak_gb']:.2f} GB, launches {r['launches_per_step']}",
              flush=True)
        readings[tag] = r
        del trainer, rows
        free()
        dist.barrier()
    wait_saves()
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(readings, f, default=str)
    return 0


def check_t5_offsets(gen, card: str, what: str, shapes: list, H: int,
                     D: int, offset: str, rate: float) -> dict:
    """The T5 kernels at one rank's shapes (bf16; ``shapes``: (T5Shape, the
    offset of the rank compared) pairs): forward and backward against their
    plain versions at rate 0.1 with ``offset`` ('head_offset' or
    'q_offset', or a tuple of both, each shape's offset then a tuple too)
    0 and the rank's (phase 2's tolerances), the offset's masks apart from
    offset 0's; then per training step (``per_path`` launches of each
    shape) the kernel, the plain version, SDPA and the bound at ``rate``,
    the forward and the backward timed as phase 2 times them (at the
    rank's offset). The text tower's launches have no backward."""
    import torch
    import torch.nn.functional as F

    from klab_multimodalmodel_tpu_torch.ops import (draw_seed,
                                                    t5_attention_bwd,
                                                    t5_attention_bwd_plain,
                                                    t5_attention_fwd,
                                                    t5_attention_plain)
    names = (offset,) if isinstance(offset, str) else tuple(offset)
    rows = {"fwd": [], "bwd": []}
    worst = dict(fwd=0.0, bwd=0.0)
    for sh, off in shapes:
        B = sh.B
        seed = draw_seed(gen)
        q, k, v, do, bias, kmask = t5_inputs(sh, torch.bfloat16, gen, H, D)
        rank_at = dict(zip(names, (off,) if isinstance(off, int) else off))
        outs = {}
        for o, at in ((0, dict.fromkeys(names, 0)), (off, rank_at)):
            out, stats = t5_attention_fwd(q, k, v, bias, kmask, RATE, seed,
                                          True, **at)
            want = t5_attention_plain(q, k, v, bias, kmask, RATE, seed, **at)
            err = max_err(out, want)
            check(torch.allclose(out.float(), want.float(), **TOL_BF16),
                  f"t5 fwd {what} {sh.name} {offset} {o}: max abs err {err}")
            worst["fwd"] = max(worst["fwd"], err)
            got = t5_attention_bwd(q, k, v, do, bias, kmask, RATE, seed,
                                   stats, sh.bias, **at)
            wantb = t5_attention_bwd_plain(q, k, v, do, bias, kmask, RATE,
                                           seed, sh.bias, **at)
            for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, wantb):
                if w is None:
                    continue
                r = rel_err(g, w)
                check(r <= TOL_GRAD["dbias" if name == "dbias"
                                    else "bfloat16"],
                      f"t5 bwd {what} {sh.name} {offset} {o} {name}: rel "
                      f"err {r}")
                worst["bwd"] = max(worst["bwd"], r)
            outs[o] = out
        check(not torch.equal(outs[0], outs[off]),
              f"t5 fwd {what} {sh.name}: {offset} {off} drew offset 0's "
              "masks")
        at = rank_at
        sd = seed if rate > 0 else None
        _, stats = t5_attention_fwd(q, k, v, bias, kmask, rate, sd, True,
                                    **at)
        ms = time_ms(lambda: t5_attention_fwd(
            q, k, v, bias, kmask, rate, sd, True, **at), 20)
        plain = time_ms(lambda: t5_attention_plain(
            q, k, v, bias, kmask, rate, sd, **at), 5, 1)
        mask = sdpa_mask(bias, kmask, torch.bfloat16)
        if mask is not None:
            mask = mask.expand(B, H, sh.Q, sh.K).contiguous()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def sdpa():
            return F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, dropout_p=rate, scale=1.0)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), leaves, do)
        lib = time_ms(sdpa, 20)
        nbytes = io_bytes(q, k, v, q) + io_bytes(bias, kmask, stats)
        flops = 4 * B * H * sh.Q * sh.K * D
        b, by = bound_ms(nbytes, flops, "bfloat16")
        rows["fwd"].append(dict(name=sh.name, shape=[B, H, sh.Q, sh.K, D],
                                offset=off, per_step=sh.per_path, ms=ms,
                                plain_ms=plain, library_ms=lib, bound_ms=b,
                                bound_by=by, bytes=nbytes, flops=flops))
        if sh.name != "text":
            ms = time_ms(lambda: t5_attention_bwd(
                q, k, v, do, bias, kmask, rate, sd, stats, sh.bias, **at),
                10, 2)
            plain = time_ms(lambda: t5_attention_bwd_plain(
                q, k, v, do, bias, kmask, rate, sd, sh.bias, **at), 5, 1)
            lib = time_ms(sdpa_fwd_bwd, 10, 2) - time_ms(sdpa, 10, 2)
            nbytes = (io_bytes(q, k, v, do) + io_bytes(q, k, v)
                      + io_bytes(bias, kmask, stats)
                      + (io_bytes(bias) if sh.bias else 0))
            flops = 10 * B * H * sh.Q * sh.K * D
            b, by = bound_ms(nbytes, flops, "bfloat16")
            rows["bwd"].append(dict(
                name=sh.name, shape=[B, H, sh.Q, sh.K, D], offset=off,
                per_step=sh.per_path, dbias=sh.bias, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b, bound_by=by, bytes=nbytes,
                flops=flops))
        for kind in ("fwd", "bwd"):
            if not rows[kind] or rows[kind][-1]["name"] != sh.name:
                continue
            x = rows[kind][-1]
            print(f"t5 {kind} {what} {sh.name} {x['shape']} {offset} {off} "
                  f"rate {rate}: kernel {x['ms']:.4f} ms, plain "
                  f"{x['plain_ms']:.4f} ms, sdpa {x['library_ms']:.4f} ms, "
                  f"bound {x['bound_ms']:.4f} ms ({x['bound_by']}) [{card}]")
        del q, k, v, do, bias, kmask, stats, leaves, mask
        free()
    totals = {}
    for kind, rs in rows.items():
        t = {key: sum(x[key] * x["per_step"] for x in rs)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        t_bytes = sum(x["bytes"] * x["per_step"] for x in rs)
        t_ops = sum(x["flops"] * x["per_step"] for x in rs)
        t["bound_by"] = ("bytes" if t_bytes / PEAK_BYTES_PER_S
                         >= t_ops / PEAK_FLOP_PER_S["bfloat16"]
                         else "operations")
        t["launches_per_step"] = sum(x["per_step"] for x in rs)
        totals[kind] = t
        print(f"t5 {kind} per {what} step ({t['launches_per_step']} "
              f"launches): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]")
    return dict(rows=rows, totals=totals, max_abs_err_fwd=worst["fwd"],
                max_rel_err_bwd=worst["bwd"])


def d128_shapes() -> list[tuple["T5Shape", int]]:
    """13c's per-rank shapes (batch 16, 16 heads of d_kv 128, rate 0.1),
    rank 1's heads."""
    pad = SRC_LEN - 30
    B = SHARD_BATCH
    return [(sh, SHARD_OFFSET) for sh in (
        T5Shape("encoder", "training", B, ENC_LEN, ENC_LEN, True, pad, RATE,
                SHARD_LAYERS),
        T5Shape("decoder", "training", B, TGT_LEN, TGT_LEN, True, -1, RATE,
                SHARD_LAYERS, causal=True),
        T5Shape("cross", "training", B, TGT_LEN, ENC_LEN, False, pad, RATE,
                SHARD_LAYERS))]


def shard_phase(card: str,
                server: "RankServer") -> Generator[None, None, dict]:
    """Phase 13: 13a in this process, then a job of the two ranks of
    ``server`` on the one card (gloo on CUDA tensors) that runs 13b and 13c
    in turn; 13b's checkpoint restored here; then the T5 kernels at 13c's
    per-rank shapes. A generator, as phases 14 and 15: it yields once the
    job is handed over, and ``finish`` runs the rest."""
    import shutil
    import tempfile

    import torch

    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    register_shard_sizes()
    memory = shard_memory(card)
    root = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        # 13a: one process.
        free()
        cfg = shard_config(batch_size=SHARD_BATCH)
        t0 = time.perf_counter()
        trainer = Trainer(cfg)
        model = trainer.init_state()
        n_train = sum(p.numel() for p in model.parameters()
                      if p.requires_grad)
        build_s = time.perf_counter() - t0
        init = trainable_on_host(model)
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if not p.requires_grad}
        batch = train_batch(cfg, SHARD_BATCH, SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        one_grads = {}

        def keep_grads(t):
            one_grads.update({n: p.grad.detach().float().cpu()
                              for n, p in t.model.named_parameters()
                              if p.requires_grad})
        one = shard_steps(trainer, batch, gen, "13a step", keep_grads)
        check(all(torch.equal(p, frozen[n])
                  for n, p in model.named_parameters() if n in frozen),
              "13a: frozen towers moved")
        one_params = trainable_on_host(model)
        # Its reading also held against key_averages() (a step of few
        # kernels, so the profiler's own reading costs little here).
        one["profile"] = profile_device(
            lambda: trainer.train_step(batch, gen), one["mean_step_ms"],
            card, "13a step", (OPT_SPAN,), against_averages=True)
        one.update(build_s=build_s, trainable=n_train)
        print(f"13a [{card}]: t5-3b {SHARD_LAYERS} + {SHARD_LAYERS} blocks, "
              f"{n_train} trainable parameters, built in {build_s:.2f} s; "
              f"losses {one['losses']}; steps "
              f"{', '.join(f'{t:.2f}' for t in one['step_ms'])} ms, peak "
              f"{one['peak_gb']:.2f} GB, launches {one['launches_per_step']}")
        del trainer, model, frozen
        free()

        def run(tag, **kw):
            c = shard_config(mesh_shape=SHARD_LAYOUTS[tag], batch_size=(
                SHARD_BATCH // SHARD_LAYOUTS[tag][1]))
            return dict(tag=tag, config=json.loads(c.to_json()),
                        params=os.path.join(root, f"{tag}.params.pt"),
                        grads=os.path.join(root, f"{tag}.grads.pt"), **kw)
        spec = dict(card=card, out=os.path.join(root, "rank"), runs=[
            run("13b", checkpoint=os.path.join(root, "13b")),
            run("13c", dropout_step=True, profile=True)])
        spec_path = os.path.join(root, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        # The caller runs other phases while the ranks work (``finish``).
        handle = server.submit("shard", spec_path)
        yield
        job_s = server.join(handle, "phase 13's runs")
        ranks = []
        for r in range(SHARD_RANKS):
            with open(f"{spec['out']}.{r}.json") as f:
                ranks.append(json.load(f))

        # 13b's checkpoint in one process: 13b's gathered parameters,
        # bitwise.
        t0 = time.perf_counter()
        trainer = Trainer(shard_config(batch_size=SHARD_BATCH))
        trainer.init_state()
        manager = CheckpointManager(os.path.join(root, "13b"))
        manager.restore(manager.latest(), trainer)
        gathered = torch.load(os.path.join(root, "13b.params.pt"),
                              weights_only=True)
        restored = trainable_on_host(trainer.model)
        restore_equal = (trainer.step == 1 + SHARD_STEPS
                         and restored.keys() == gathered.keys()
                         and all(torch.equal(restored[n], gathered[n])
                                 for n in gathered))
        restore_s = time.perf_counter() - t0
        check(restore_equal, "13b's checkpoint restored in one process "
              "differs from 13b's gathered parameters")
        del trainer, restored
        free()
        agree, results = {}, {}
        for tag in SHARD_LAYOUTS:
            got = ([rk[tag] for rk in ranks])
            params = (gathered if tag == "13b" else torch.load(
                os.path.join(root, f"{tag}.params.pt"), weights_only=True))
            check(got[0]["losses"] == got[1]["losses"],
                  f"{tag}: the ranks' losses differ: {got[0]['losses']} vs "
                  f"{got[1]['losses']}")
            check(all(abs(x - y) <= TOL_SHARD["loss"] * abs(y)
                      for x, y in zip(got[0]["losses"], one["losses"])),
                  f"{tag}: losses {got[0]['losses']} vs 13a "
                  f"{one['losses']}")
            for r, g in enumerate(got):
                check(g["launches_per_step"] == SHARD_LAUNCHES,
                      f"{tag} rank {r}: launches {g['launches_per_step']}")
            grads = torch.load(os.path.join(root, f"{tag}.grads.pt"),
                               weights_only=True)
            first = agreement((got[0]["losses"][0], grads),
                              (one["losses"][0], one_grads),
                              f"{tag} vs 13a, the first step's gradients",
                              TOL_SHARD["grad"])
            del grads
            a = update_agreement(params, one_params, init)
            del params
            free()
            worst_cos = min(a, key=lambda n: a[n]["cosine"])
            worst_abs = max(a, key=lambda n: a[n]["abs"])
            check(all(math.isfinite(v["cosine"]) for v in a.values()),
                  f"{tag}: non-finite updates")
            agree[tag] = dict(first_step_gradients=first,
                              worst_update_cosine=[worst_cos, a[worst_cos]],
                              worst_update_abs=[worst_abs, a[worst_abs]])
            print(f"{tag} vs 13a [{card}]: losses {got[0]['losses']} vs "
                  f"{one['losses']}; updates after {1 + SHARD_STEPS} steps "
                  f"of {len(a)} trainable tensors (printed, not held): "
                  f"lowest cosine {a[worst_cos]['cosine']:.6f} "
                  f"({worst_cos}), largest difference "
                  f"{a[worst_abs]['abs']:.3e} ({worst_abs})")
            for r, g in enumerate(got):
                coll = (g["profile"].get("collectives") or {})
                print(f"  {tag} rank {r}: build {g['build_s']:.2f} s, steps "
                      f"{', '.join(f'{t:.2f}' for t in g['step_ms'])} ms "
                      f"(13a {one['mean_step_ms']:.2f}), peak "
                      f"{g['peak_gb']:.2f} GB (13a {one['peak_gb']:.2f}); "
                      + (f"profiled step: busy {g['profile']['busy_ms']} "
                         f"ms, share {g['profile']['busy_share']}, "
                         f"collectives host {coll.get('host_ms')} ms, device "
                         f"{coll.get('device_ms')} ms; " if g["profile"]
                         else "")
                      + (f"checkpoint (its one gather included) "
                         f"{g['checkpoint_s']:.2f} s" if "checkpoint_s" in g
                         else f"gather {g['gather_s']:.2f} s"))
            results[tag] = got
        c = [rk["13c"] for rk in ranks]
        print(f"13c [{card}]: dropout-0.1 step losses "
              f"{[g['dropout_loss'] for g in c]}; "
              f"{c[0]['replicated_checked']} replicated parameters bitwise "
              f"equal across the tensor ranks; 13b's checkpoint restored "
              f"bitwise in one process in {restore_s:.2f} s")
        del one_params, init, gathered, one_grads
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    kernels = check_t5_offsets(gen, card, "d128 13c rank",
                               d128_shapes(), SHARD_HEADS, SHARD_D,
                               "head_offset", RATE)
    seconds = time.perf_counter() - t_phase
    print(f"phase 13: {seconds:.1f} s (job {job_s:.2f} s)")
    return dict(card=card, memory_reckoned_gb=memory, one_process=one,
                ranks=results, agreement=agree, job_s=job_s,
                restore_s=restore_s, d128=kernels, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 14: sequence parallelism over the seq axis (all-gather and ring)
# ---------------------------------------------------------------------------

# t5-large cut to 2 + 2 blocks (T5_SEQ; dropout 0 for the compared steps)
# behind the default towers at full depth, batch 16, two seq ranks sharing
# the card over gloo. Every run starts from the same
# seeded weights and rows.
SEQ_RANKS = 2
SEQ_MESH = (1, 1, 1, SEQ_RANKS)
SEQ_BATCH, SEQ_STEPS = 16, 2
SEQ_LAYERS = 2
T5_SEQ = "t5-large-2x2-dropout-0"
SEQ_LAUNCHES = step_launches(T5_LAYERS, SEQ_LAYERS, SEQ_LAYERS,
                             dropout=False)
SEQ_LAUNCHES_DROPOUT = step_launches(T5_LAYERS, SEQ_LAYERS, SEQ_LAYERS)
# The T5 kernel off (a', c): the Swin kernel's launches only.
SEQ_LAUNCHES_PLAIN = dict(t5_fwd=0, t5_fwd_dropout=0, t5_bwd=0,
                          t5_bwd_dbias=0, swin=24)
# The ring's exchanges in one step of c: the text tower's 24 self-
# attentions forward (frozen), the transformer's 12 forward and backward
# (one exchange forward, two backward).
SEQ_RING_EXCHANGES = T5_LAYERS + 2 * SEQ_LAYERS * 3
# 14d: one step at batch 2 with the prompt padded to 2048 ids (encoder
# 2112 positions), dropout 0.
SEQ_LONG_BATCH, SEQ_LONG_SRC = 2, 2048


def seq_config(**kw):
    """Phase 14's set-up: the Config defaults, both kernel flags (``kw``
    may turn the T5 kernel off), the transformer cut to ``SEQ_LAYERS`` +
    ``SEQ_LAYERS`` blocks at dropout 0 (``kw`` may name another), batch
    ``SEQ_BATCH``."""
    from klab_multimodalmodel_tpu_torch import config as tcfg

    register_no_dropout()
    kw = dict(dict(use_pallas_attention=True, use_pallas_t5_attention=True,
                   batch_size=SEQ_BATCH, transformer_model_name=T5_SEQ),
              **kw)
    return tcfg.Config(seed=SEED, **kw)


def seq_run(trainer, tag: str, card: str, expected: dict, dropout: dict,
            keep_grads, ring: bool, long: tuple = ()) -> dict:
    """One warm-up and ``SEQ_STEPS`` timed steps of ``trainer`` at dropout
    0 (launches checked against ``expected``), a profiled step, then one
    step at dropout 0.1 (launches against ``dropout``), then for each of
    ``long`` ('path': the trainer's own; 'allgather' or 'ring': its stacks
    set so) one 14d step at batch 2 and 2048 source ids (dropout 0):
    losses, spans, peak memory, the profile and the long steps' peaks;
    with ``ring`` the ring's exchanges per step are counted too."""
    import torch

    from klab_multimodalmodel_tpu_torch.ops import ring_attention

    cfg = trainer.config
    mesh = trainer.mesh
    batch = train_batch(cfg, SEQ_BATCH, SEED)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 1)
    probes = [dropout_probe(trainer, batch)]
    before = ring_attention.exchanges
    t0 = time.perf_counter()
    first = float(trainer.train_step(batch, gen))
    first_ms = (time.perf_counter() - t0) * 1e3
    exchanges = ring_attention.exchanges - before
    keep_grads(trainer)
    probes.append(dropout_probe(trainer, batch))
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = timed_steps(trainer, batch, gen, SEQ_STEPS,
                                            expected, tag)
    losses = [first] + losses
    check(all(math.isfinite(x) for x in losses),
          f"{tag}: non-finite loss {losses}")
    if ring:
        check(exchanges == SEQ_RING_EXCHANGES,
              f"{tag}: the ring turned {exchanges} times in a step, "
              f"expected {SEQ_RING_EXCHANGES}")
    r = dict(losses=losses, first_step_ms=first_ms, step_ms=step_ms,
             mean_step_ms=sum(step_ms) / len(step_ms),
             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches_per_step=per_step, ring_exchanges_per_step=exchanges,
             seq=[mesh.seq_rank, mesh.seq], dropout_probes=probes)
    r["profile"] = profile_device(
        lambda: trainer.train_step(batch, gen), r["mean_step_ms"], card,
        f"{tag} step", collectives=mesh.distributed)
    # One step at dropout 0.1 on the generator the rate-0 steps left
    # untouched (they draw nothing).
    set_dropout(trainer.model.transformer, RATE)
    reset_counts()
    r["dropout_loss"] = float(trainer.train_step(batch, gen))
    got = launch_counts()
    check(got == dropout and math.isfinite(r["dropout_loss"]),
          f"{tag}: the dropout step's loss {r['dropout_loss']}, launches "
          f"{got}, expected {dropout}")
    set_dropout(trainer.model.transformer, 0.0)
    rows = train_batch(dataclasses.replace(cfg, max_source_length=(
        SEQ_LONG_SRC)), SEQ_LONG_BATCH, SEED)
    r["long"] = {}
    for kind in long:
        if kind != "path":
            for stack in seq_stacks(trainer.model):
                stack.ring_attention = kind == "ring"
        free()
        torch.cuda.reset_peak_memory_stats()
        loss = float(trainer.train_step(rows, gen))
        check(math.isfinite(loss), f"{tag} long step ({kind}): loss {loss}")
        r["long"][kind] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag} [{card}]: losses {r['losses']}, steps "
          f"{', '.join(f'{t:.2f}' for t in step_ms)} ms, peak "
          f"{r['peak_gb']:.2f} GB, launches {per_step}"
          + (f", {exchanges} ring exchanges a step" if ring else "")
          + f"; dropout-0.1 step loss {r['dropout_loss']:.6f}"
          + (f"; batch {SEQ_LONG_BATCH} x {SEQ_LONG_SRC} ids, peak GB: "
             + ", ".join(f"{k} {v:.2f}" for k, v in r["long"].items())
             if long else ""), flush=True)
    return r


def dropout_probe(trainer, batch: dict) -> float:
    """The loss of ``batch`` at dropout 0.1, with no update, on the weights
    as they stand, from a generator in the state that phase 18's dropout
    step draws from (seeded ``SEED + 1``, which steps at rate 0 leave
    untouched): across ranks the token-weighted mean over every rank's
    positions, as a step's loss is. Phases 14, 18 and 19 take it before
    their first step, and phases 14 and 15a's MoE run after it too (the
    weights of 18's and 19's dropout steps)."""
    import torch

    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 1)
    set_dropout(trainer.model.transformer, RATE)
    try:
        with torch.no_grad():
            b = trainer.to_device(batch)
            loss, aux, _ = trainer.net(b, gen, False)
            if trainer.mesh.distributed:
                # Under MoE each rank's balance loss is its share of the
                # whole: summed, not weighted by its tokens.
                n = trainer._token_counts(b, 1)[0]
                sums = trainer._all_reduce(torch.stack(
                    [(loss - aux).float() * n, n, aux.float()]))
                loss = sums[0] / sums[1] + sums[2]
            if trainer.sharded:
                # FSDP2 keeps the root's parameters gathered after a
                # forward that no backward follows.
                trainer.net.reshard()
    finally:
        set_dropout(trainer.model.transformer, 0.0)
    return float(loss)


def seq_stacks(model) -> list:
    return [model.language_model.encoder, model.transformer.encoder,
            model.transformer.decoder]


def all_mismatches(model) -> tuple[int, list]:
    """(parameters checked, names that differ from rank 0's, bitwise, by
    broadcast): every parameter, which each seq rank holds whole."""
    import torch
    import torch.distributed as dist

    checked, bad = 0, []
    for n, p in model.named_parameters():
        ref = p.detach().clone()
        dist.broadcast(ref, src=0)
        checked += 1
        if not torch.equal(ref, p.detach()):
            bad.append(n)
    return checked, bad


def seq_rank_main(spec_path: str) -> int:
    """One rank of phase 14's job (on a ``RankServer`` rank):
    14b and 14c in turn on ``cuda:0``, which both ranks share (gloo on
    CUDA tensors: ``KLAB_CPU_COLLECTIVES=gloo``); this rank's readings to
    ``{out}.{rank}.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer
    from klab_multimodalmodel_tpu_torch.utils.mesh import (
        maybe_init_distributed)

    with open(spec_path) as f:
        spec = json.load(f)
    register_no_dropout()
    device = torch.device(DDP_DEVICE)
    maybe_init_distributed(device)
    rank, card = dist.get_rank(), spec["card"]
    readings = {}
    for run in spec["runs"]:
        tag = f"{run['tag']} rank {rank}"
        cfg = Config.from_json(json.dumps(run["config"]))
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device=device)
        # Seeded with config.seed on the card: 14a's weights on every rank.
        trainer.init_state()
        check(trainer.ddp is not None and trainer.mesh.seq == SEQ_RANKS,
              f"{tag}: not a DDP trainer over {SEQ_RANKS} seq ranks")
        build_s = time.perf_counter() - t0

        def save_grads(t):
            # The warm-up step's gradients, all-reduced over the ranks.
            if rank == 0:
                torch.save({n: p.grad.detach().float().cpu()
                            for n, p in t.model.named_parameters()
                            if p.requires_grad}, run["grads"])
        r = seq_run(trainer, tag, card, run["launches"],
                    run["launches_dropout"], save_grads, run["ring"],
                    ("allgather", "ring") if run["ring"] else ())
        checked, bad = all_mismatches(trainer.model)
        check(checked > 0 and not bad,
              f"{tag}: {len(bad)} of {checked} parameters differ across "
              f"the seq ranks: {bad[:5]}")
        r.update(build_s=build_s, params_checked=checked, params_differ=bad)
        readings[run["tag"]] = r
        del trainer
        free()
        dist.barrier()
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(readings, f, default=str)
    return 0


def seq_kernel_shapes() -> list[tuple["T5Shape", int]]:
    """(shape, q_offset of seq rank 1) of every T5 kernel launch of a
    phase-14b rank's step: its half of the text tower's 256 queries, the
    encoder's 320 and the decoder's 128, against every key."""
    pad = SRC_LEN - 30
    B, layers = SEQ_BATCH, SEQ_LAYERS
    return [
        (T5Shape("text", "training", B, SRC_LEN // 2, SRC_LEN, True, pad,
                 0.0, T5_LAYERS), SRC_LEN // 2),
        (T5Shape("encoder", "training", B, ENC_LEN // 2, ENC_LEN, True, pad,
                 0.0, layers), ENC_LEN // 2),
        (T5Shape("decoder", "training", B, TGT_LEN // 2, TGT_LEN, True, -1,
                 0.0, layers, causal=True), TGT_LEN // 2),
        (T5Shape("cross", "training", B, TGT_LEN // 2, ENC_LEN, False, pad,
                 0.0, layers), TGT_LEN // 2)]


def seq_phase(card: str, server: "RankServer",
              refs: dict | None = None) -> Generator[None, None, dict]:
    """Phase 14: 14a and 14a' in this process, then a job of the two
    ranks of ``server`` on the one card (gloo on CUDA tensors) that runs 14b
    and 14c in turn (each with its 14d step),
    then the T5 kernels at a 14b rank's shapes (14e). ``refs`` gets phase
    18's references: 14a's and 14a''s readings (``one``) and first-step
    gradients (``grads``), and the dropout probes of 14a, 14a', 14b and
    14c (``dropout_probes``: before and after the first step). A
    generator, as ``shard_phase``."""
    import shutil
    import tempfile

    import torch

    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    plain_t5 = dict(use_pallas_t5_attention=False)
    ones, one_grads = {}, {}
    try:
        for tag, kw, expected, dropout, long in (
                ("14a", {}, SEQ_LAUNCHES, SEQ_LAUNCHES_DROPOUT, ()),
                ("14a'", plain_t5, SEQ_LAUNCHES_PLAIN, SEQ_LAUNCHES_PLAIN,
                 ("path",))):
            free()
            t0 = time.perf_counter()
            trainer = Trainer(seq_config(**kw))
            trainer.init_state()
            build_s = time.perf_counter() - t0
            grads = one_grads.setdefault(tag, {})

            def keep(t, grads=grads):
                grads.update({n: p.grad.detach().float().cpu()
                              for n, p in t.model.named_parameters()
                              if p.requires_grad})
            ones[tag] = seq_run(trainer, f"{tag} step", card, expected,
                                dropout, keep, False, long)
            ones[tag]["build_s"] = build_s
            del trainer
            free()

        def run(tag, ring, **kw):
            c = seq_config(mesh_shape=SEQ_MESH, **kw)
            return dict(tag=tag, ring=ring, config=json.loads(c.to_json()),
                        grads=os.path.join(root, f"{tag}.grads.pt"),
                        launches=(SEQ_LAUNCHES_PLAIN if ring
                                  else SEQ_LAUNCHES),
                        launches_dropout=(SEQ_LAUNCHES_PLAIN if ring
                                          else SEQ_LAUNCHES_DROPOUT))
        spec = dict(card=card, out=os.path.join(root, "rank"), runs=[
            run("14b", False),
            run("14c", True, seq_attention="ring", **plain_t5)])
        spec_path = os.path.join(root, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        # The caller runs other phases while the ranks work (``finish``).
        handle = server.submit("seq", spec_path)
        yield
        job_s = server.join(handle, "phase 14's runs")
        ranks = []
        for r in range(SEQ_RANKS):
            with open(f"{spec['out']}.{r}.json") as f:
                ranks.append(json.load(f))
        agree, results = {}, {}
        for tag, ref in (("14b", "14a"), ("14c", "14a'")):
            got = [rk[tag] for rk in ranks]
            one = ones[ref]
            check(got[0]["losses"] == got[1]["losses"]
                  and got[0]["dropout_loss"] == got[1]["dropout_loss"],
                  f"{tag}: the ranks' losses differ: {got[0]['losses']} vs "
                  f"{got[1]['losses']}")
            losses = got[0]["losses"] + [got[0]["dropout_loss"]]
            want = one["losses"] + [one["dropout_loss"]]
            check(all(abs(x - y) <= TOL_SHARD["loss"] * abs(y)
                      for x, y in zip(losses, want)),
                  f"{tag}: losses (the last at dropout 0.1) {losses} vs "
                  f"{ref} {want}")
            for r, g in enumerate(got):
                check(g["launches_per_step"] == one["launches_per_step"],
                      f"{tag} rank {r}: launches {g['launches_per_step']}, "
                      f"{ref}'s {one['launches_per_step']}")
            grads = torch.load(os.path.join(root, f"{tag}.grads.pt"),
                               weights_only=True)
            agree[tag] = agreement((got[0]["losses"][0], grads),
                                   (one["losses"][0], one_grads[ref]),
                                   f"{tag} vs {ref}, the first step's "
                                   "gradients", TOL_SHARD["grad"])
            del grads
            print(f"{tag} vs {ref} [{card}]: losses {got[0]['losses']} vs "
                  f"{one['losses']}; at dropout 0.1 "
                  f"{got[0]['dropout_loss']:.6f} vs "
                  f"{one['dropout_loss']:.6f}"
                  + (" (the ring's Philox masks, the plain path's "
                     "generator masks: two draws)" if tag == "14c" else
                     " (the same masks)")
                  + f"; {got[0]['params_checked']} parameters bitwise "
                  "equal across the seq ranks")
            for r, g in enumerate(got):
                coll = (g["profile"].get("collectives") or {})
                print(f"  {tag} rank {r}: build {g['build_s']:.2f} s, steps "
                      f"{', '.join(f'{t:.2f}' for t in g['step_ms'])} ms "
                      f"({ref} {one['mean_step_ms']:.2f}), peak "
                      f"{g['peak_gb']:.2f} GB ({ref} {one['peak_gb']:.2f}); "
                      f"profiled step: busy {g['profile'].get('busy_ms')} "
                      f"ms, share {g['profile'].get('busy_share')}, "
                      f"collectives host {coll.get('host_ms')} ms, device "
                      f"{coll.get('device_ms')} ms")
            results[tag] = got
        c = results["14c"]
        memory = {"14a' (one process)": ones["14a'"]["long"]["path"],
                  **{f"14b' all-gather, rank {r}": g["long"]["allgather"]
                     for r, g in enumerate(c)},
                  **{f"14c ring, rank {r}": g["long"]["ring"]
                     for r, g in enumerate(c)}}
        print(f"14d [{card}]: peak GB of one step at batch {SEQ_LONG_BATCH}"
              f" x {SEQ_LONG_SRC} source ids, the T5 kernel off: "
              + "; ".join(f"{k} {v:.2f}" for k, v in memory.items()))
        check(all(g["long"]["ring"] < g["long"]["allgather"] for g in c),
              "14d: the ring's peak is not below the all-gather path's")
        if refs is not None:
            refs.update(one=ones, grads=one_grads, dropout_probes={
                **{t: r["dropout_probes"] for t, r in ones.items()},
                **{t: got[0]["dropout_probes"]
                   for t, got in results.items()}})
        del one_grads
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    kernels = check_t5_offsets(gen, card, "14b rank", seq_kernel_shapes(),
                               T5_H, T5_D, "q_offset", 0.0)
    seconds = time.perf_counter() - t_phase
    print(f"phase 14: {seconds:.1f} s (job {job_s:.2f} s)")
    return dict(card=card, one_process=ones, ranks=results, agreement=agree,
                memory_long_gb=memory, job_s=job_s, kernels=kernels,
                seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 15: experts and pipeline stages on ranks (the expert and pipe axes)
# ---------------------------------------------------------------------------

# t5-large of 2 + 2 blocks at full width (6 + 6 until phase 16 took its
# room; dropout 0 for the compared steps) behind the default towers, batch
# 16, two ranks sharing the card over gloo: 15b splits 4 experts (top-2,
# capacity factor 1.25, both kernel flags) over expert 2, 15c 2 GPipe
# stages (4 microbatches, the T5 kernel off as the JAX package requires,
# the Swin kernel on) over pipe 2. 15a runs both models in one process.
# Every run starts from the same seeded weights and rows, and takes a
# warm-up, one timed step, a profiled step and a step at dropout 0.1.
SPLIT_RANKS = 2
SPLIT_BATCH, SPLIT_STEPS = 16, 1
SPLIT_LAYERS = 2
T5_SPLIT = f"t5-large-{SPLIT_LAYERS}x{SPLIT_LAYERS}-dropout-0"
SPLIT_MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
SPLIT_PIPE = dict(pipeline_stages=2, pipeline_microbatches=4,
                  use_pallas_t5_attention=False)
SPLIT_RUNS = {  # tag: (its 15a twin, mesh, config flags, launches a step)
    "15b": ("15a-moe", (1, 1, 1, 1, 1, SPLIT_RANKS), SPLIT_MOE, (
        step_launches(T5_LAYERS, SPLIT_LAYERS, SPLIT_LAYERS, dropout=False),
        step_launches(T5_LAYERS, SPLIT_LAYERS, SPLIT_LAYERS))),
    "15c": ("15a-pipe", (1, 1, 1, 1, SPLIT_RANKS, 1), SPLIT_PIPE, (
        SEQ_LAUNCHES_PLAIN, SEQ_LAUNCHES_PLAIN)),
}
# 15b and 15c against 15a (bf16 compute): 15b's combine is two bf16
# partial sums added in gloo where one process sums all four experts in
# one product; 15c runs each microbatch's forward as one process does and
# sums the microbatches' parameter gradients in another order. Held: the
# losses of every step (the dropout step's too) within 5e-4 relative, the
# first step's gradient of every trainable tensor at cosine >= 0.999 (norm
# within phase 4's 2 %, all together >= 0.999), and under 0.1 % of 15b's
# token-routings flipped against 15a's.
TOL_SPLIT = dict(loss=5e-4, grad=dict(cosine=0.999, norm=0.02,
                                      total=0.999), flipped=1e-3)


def split_config(tag: str, **kw):
    """Phase 15's set-up of run ``tag`` (its 15a twin's flags)."""
    twin = {"15a-moe": "15b", "15a-pipe": "15c"}.get(tag, tag)
    return seq_config(**dict(SPLIT_RUNS[twin][2],
                             transformer_model_name=T5_SPLIT, **kw))


def split_memory(card: str) -> dict:
    """Each run's per-rank parameters, gradients and Adam moments (GB),
    reckoned on the meta device before any run, as the split lays them out
    (pipe rank 0's stage; its other stage holds as much)."""
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        per_rank_bytes)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names

    out = {}
    for tag, axes in (("15a-moe", {}), ("15b", {"expert": SPLIT_RANKS}),
                      ("15a-pipe", {}), ("15c", {"pipe": SPLIT_RANKS})):
        cfg = split_config(tag)
        model = MultiModalModel(cfg, device="meta")
        names = trainable_names(model, cfg)
        out[tag] = {k: v / 1e9 for k, v in per_rank_bytes(
            [(n, tuple(p.shape), n in names)
             for n, p in model.named_parameters()], axes).items()}
    print("phase 15: state per rank reckoned (GB; params, grads, Adam): "
          + "; ".join(f"{t} {r['params']:.2f} + {r['grads']:.2f} + "
                      f"{r['moments']:.2f} = {r['total']:.2f}"
                      for t, r in out.items()) + f" [{card}]")
    return out


def held_bytes(trainer) -> dict:
    """What the rank holds (GB): its parameters, the trainable ones'
    gradients and optimizer state (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    def nbytes(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.numel() * t.element_size()
    params = sum(nbytes(p) for p in trainer.model.parameters())
    grads = sum(nbytes(p.grad) for p in trainer.model.parameters()
                if p.grad is not None)
    moments = sum(nbytes(v) for st in trainer.optimizer.state.values()
                  for v in st.values()
                  if hasattr(v, "numel") and v.dim() > 0)
    return dict(params=params / 1e9, grads=grads / 1e9,
                moments=moments / 1e9,
                total=(params + grads + moments) / 1e9)


def split_run(trainer, tag: str, card: str, launches: tuple, first,
              collectives: bool, extras: bool = True,
              own_rows: bool = False, probes: bool = False) -> dict:
    """One warm-up (``first(trainer, recorder)`` after it, with the
    routings it recorded) and ``SPLIT_STEPS`` timed steps of ``trainer``
    at dropout 0 (launches checked), then, with ``extras``, a profiled
    step and one step at dropout 0.1 (launches checked): losses, spans,
    peak memory, the profile, the tokens each routing call of the warm-up
    dropped at capacity; with ``probes`` the loss at dropout 0.1 before
    the warm-up and after it (``dropout_probe``). Every step takes the
    whole batch, or with ``own_rows`` the rank's data x fsdp chunk of
    it."""
    import torch

    cfg = trainer.config
    batch = train_batch(cfg, SPLIT_BATCH, SEED)
    if own_rows:
        n = SPLIT_BATCH // trainer.mesh.dp_size
        lo = trainer.mesh.dp_rank * n
        batch = {k: v[lo:lo + n] for k, v in batch.items()}
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 1)
    before = dropout_probe(trainer, batch) if probes else None
    t0 = time.perf_counter()
    with RoutingRecorder() as recorder:
        first_loss = float(trainer.train_step(batch, gen))
    first_ms = (time.perf_counter() - t0) * 1e3
    first(trainer, recorder.calls)
    dropped = [int(d) for d in recorder.dropped]
    del recorder
    after = dropout_probe(trainer, batch) if probes else None
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = timed_steps(trainer, batch, gen, SPLIT_STEPS,
                                            launches[0], tag)
    r = dict(losses=[first_loss] + losses, first_step_ms=first_ms,
             step_ms=step_ms, mean_step_ms=sum(step_ms) / len(step_ms),
             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches_per_step=per_step, profile={}, dropout_loss=None,
             dropped=dropped, dropout_probes=[before, after])
    if extras:
        r["profile"] = profile_device(
            lambda: trainer.train_step(batch, gen), r["mean_step_ms"], card,
            f"{tag} step", collectives=collectives)
        set_dropout(trainer.model.transformer, RATE)
        reset_counts()
        r["dropout_loss"] = float(trainer.train_step(batch, gen))
        got = launch_counts()
        set_dropout(trainer.model.transformer, 0.0)
        check(got == launches[1], f"{tag}: the dropout step's launches "
              f"{got}, expected {launches[1]}")
    losses = r["losses"] + ([r["dropout_loss"]] if extras else [])
    check(all(math.isfinite(x) for x in losses),
          f"{tag}: non-finite loss {losses}")
    r["held_gb"] = held_bytes(trainer)
    dropout = (f"; dropout-0.1 step loss {r['dropout_loss']:.6f}"
               if extras else "")
    print(f"{tag} [{card}]: losses {r['losses']}, steps "
          f"{', '.join(f'{t:.2f}' for t in step_ms)} ms, peak "
          f"{r['peak_gb']:.2f} GB, launches {per_step}{dropout}; holds "
          f"{r['held_gb']['total']:.2f} GB of state", flush=True)
    return r


def routing_masks(calls: list) -> list:
    """The routing calls' assignments and logits on the host."""
    return [(a.cpu(), lg.float().cpu()) for a, lg in calls]


def split_rank_main(spec_path: str) -> int:
    """One rank of phase 15's job (on a ``RankServer`` rank):
    15b and 15c in turn on ``cuda:0``, which both ranks share (gloo on CUDA
    tensors: ``KLAB_CPU_COLLECTIVES=gloo``); this rank's readings to
    ``{out}.{rank}.json``, its first step's gradients, its parameters after
    the steps and (rank 0) 15b's routings to files, and a checkpoint of
    each run."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)
    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer
    from klab_multimodalmodel_tpu_torch.utils.mesh import (
        maybe_init_distributed)

    with open(spec_path) as f:
        spec = json.load(f)
    register_no_dropout()
    device = torch.device(DDP_DEVICE)
    maybe_init_distributed(device)
    rank, card = dist.get_rank(), spec["card"]
    readings = {}
    for run in spec["runs"]:
        tag = run["tag"]
        cfg = Config.from_json(json.dumps(run["config"]))
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device=device)
        # Seeded with config.seed on the card: 15a's weights on every
        # rank, then split.
        trainer.init_state()
        mesh = trainer.mesh
        check(trainer.ddp is None and mesh.split,
              f"{tag}: not a split trainer without DDP")
        build_s = time.perf_counter() - t0
        base = f"{run['files']}.{rank}"

        def first(t, calls):
            torch.save({n: p.grad.detach().float().cpu()
                        for n, p in t.model.named_parameters()
                        if p.grad is not None}, f"{base}.grads.pt")
            if rank == 0 and calls:
                torch.save(routing_masks(calls), f"{base}.routing.pt")
        r = split_run(trainer, f"{tag} rank {rank}", card,
                      tuple(run["launches"]), first, True)
        # The parameters every rank holds, bitwise against rank 0's.
        checked, bad = 0, []
        for n in sorted(n for n, _ in trainer.model.named_parameters()
                        if not trainer.spans_ranks(n)):
            local = trainer.model.get_parameter(n).detach()
            ref = local.clone()
            dist.broadcast(ref, src=0)
            checked += 1
            if not torch.equal(ref, local):
                bad.append(n)
        check(checked > 0 and not bad,
              f"{tag} rank {rank}: {len(bad)} of {checked} replicated "
              f"parameters differ across the ranks: {bad[:5]}")
        torch.save({n: p.detach().cpu() for n, p in
                    trainer.model.named_parameters() if p.requires_grad},
                   f"{base}.params.pt")
        t0 = time.perf_counter()
        manager = CheckpointManager(run["checkpoint"], mesh)
        manager.save(f"step_{trainer.step}", trainer)
        _PENDING_SAVES.append(manager)  # written while the next run goes
        r.update(build_s=build_s, checkpoint_s=time.perf_counter() - t0,
                 saves=manager.saves, replicated_checked=checked,
                 pipe=[mesh.pipe_rank, mesh.pipe],
                 expert=[mesh.expert_rank, mesh.expert])
        readings[tag] = r
        del trainer
        free()
        dist.barrier()
    wait_saves()
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(readings, f, default=str)
    return 0


def split_whole(tag: str, parts: list, placement) -> dict:
    """Rank-held tensors (``parts``: each rank's {name: tensor}) as one
    process holds them: an expert bank's slices joined on dim 0, a stage's
    blocks from the rank that holds them, the rest rank 0's."""
    import torch

    out = {}
    for n in sorted(set().union(*parts)):
        if tag == "15b" and placement(n):
            out[n] = torch.cat([p[n] for p in parts])
        else:
            out[n] = next(p[n] for p in parts if n in p)
    return out


def split_phase(card: str, server: "RankServer",
                keep: dict | None = None) -> Generator[None, None, dict]:
    """Phase 15: 15a (the MoE and the pipelined model in this process),
    then a job of the two ranks of ``server`` on the one card (gloo on CUDA
    tensors) that runs 15b (expert 2) and 15c (pipe 2) in turn; each run's
    checkpoint restored here in one process. ``keep``
    receives 15a's MoE run (``one``), its first step's gradients and its
    routings: phase 16's one-process reference; and 15a's pipelined run
    (``pipe_one``) and its first step's gradients (``pipe_grads``): phase
    17's. A generator, as ``shard_phase``."""
    import shutil
    import tempfile

    import torch

    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    register_no_dropout()
    memory = split_memory(card)
    root = tempfile.mkdtemp(prefix="chip_smoke_split_")
    ones, one_grads, one_routes = {}, {}, {}
    try:
        for tag in ("15a-moe", "15a-pipe"):
            free()
            t0 = time.perf_counter()
            trainer = Trainer(split_config(tag))
            trainer.init_state()
            build_s = time.perf_counter() - t0

            def first(t, calls, tag=tag):
                one_grads[tag] = {n: p.grad.detach().float().cpu()
                                  for n, p in t.model.named_parameters()
                                  if p.grad is not None}
                one_routes[tag] = routing_masks(calls)
            twin = {"15a-moe": "15b", "15a-pipe": "15c"}[tag]
            ones[tag] = split_run(trainer, f"{tag} step", card,
                                  SPLIT_RUNS[twin][3], first, False,
                                  probes=tag == "15a-moe")
            ones[tag]["build_s"] = build_s
            del trainer
            free()

        def run(tag):
            _, mesh, _, launches = SPLIT_RUNS[tag]
            c = split_config(tag, mesh_shape=mesh)
            return dict(tag=tag, config=json.loads(c.to_json()),
                        launches=launches,
                        files=os.path.join(root, tag),
                        checkpoint=os.path.join(root, f"{tag}.ckpt"))
        spec = dict(card=card, out=os.path.join(root, "rank"),
                    runs=[run("15b"), run("15c")])
        spec_path = os.path.join(root, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        # The caller runs other phases while the ranks work (``finish``).
        handle = server.submit("split", spec_path)
        yield
        job_s = server.join(handle, "phase 15's runs")
        ranks = []
        for r in range(SPLIT_RANKS):
            with open(f"{spec['out']}.{r}.json") as f:
                ranks.append(json.load(f))
        agree, results, restore_s = {}, {}, {}
        for tag, (ref, _, _, _) in SPLIT_RUNS.items():
            got = [rk[tag] for rk in ranks]
            one = ones[ref]
            check(got[0]["losses"] == got[1]["losses"]
                  and got[0]["dropout_loss"] == got[1]["dropout_loss"],
                  f"{tag}: the ranks' losses differ: {got[0]['losses']} vs "
                  f"{got[1]['losses']}")
            losses = got[0]["losses"] + [got[0]["dropout_loss"]]
            want = one["losses"] + [one["dropout_loss"]]
            worst_loss = max(abs(x - y) / abs(y)
                             for x, y in zip(losses, want))
            check(worst_loss <= TOL_SPLIT["loss"],
                  f"{tag}: losses (the last at dropout 0.1) {losses} vs "
                  f"{ref} {want}")
            for r, g in enumerate(got):
                check(g["launches_per_step"] == one["launches_per_step"],
                      f"{tag} rank {r}: launches {g['launches_per_step']}, "
                      f"{ref}'s {one['launches_per_step']}")

            def bank(n):
                return n.endswith((".experts_wi", ".experts_wo"))
            grads = split_whole(tag, [torch.load(
                f"{os.path.join(root, tag)}.{r}.grads.pt", weights_only=True)
                for r in range(SPLIT_RANKS)], bank)
            agree[tag] = dict(loss_worst_rel=worst_loss, gradients=agreement(
                (got[0]["losses"][0], grads), (one["losses"][0],
                                               one_grads[ref]),
                f"{tag} vs {ref}, the first step's gradients",
                TOL_SPLIT["grad"]))
            del grads
            if tag == "15b":
                diff = routing_differences(torch.load(
                    f"{os.path.join(root, tag)}.0.routing.pt",
                    weights_only=True), one_routes[ref],
                    SPLIT_MOE["moe_top_k"])
                share = diff["flipped"] / diff["tokens"]
                agree[tag]["routing"] = dict(diff, share=share)
                print(f"15b vs 15a [{card}]: {diff['flipped']} of "
                      f"{diff['tokens']} token-routings of the first step "
                      f"flipped an expert ({share:.2e}; limit "
                      f"{TOL_SPLIT['flipped']})")
                check(share <= TOL_SPLIT["flipped"],
                      f"15b: {share:.2e} of the routings flipped")
            # The run's checkpoint in one process: every rank's trainable
            # parameters after the steps, bitwise.
            t0 = time.perf_counter()
            trainer = Trainer(split_config(ref))
            trainer.init_state()
            manager = CheckpointManager(os.path.join(root, f"{tag}.ckpt"))
            manager.restore(manager.latest(), trainer)
            params = split_whole(tag, [torch.load(
                f"{os.path.join(root, tag)}.{r}.params.pt",
                weights_only=True) for r in range(SPLIT_RANKS)], bank)
            restored = trainable_on_host(trainer.model)
            equal = (trainer.step == SPLIT_STEPS + 3
                     and restored.keys() == params.keys()
                     and all(torch.equal(restored[n], params[n])
                             for n in params))
            restore_s[tag] = time.perf_counter() - t0
            check(equal, f"{tag}'s checkpoint restored in one process "
                  "differs from the ranks' parameters")
            del trainer, params, restored
            free()
            print(f"{tag} vs {ref} [{card}]: losses {got[0]['losses']} vs "
                  f"{one['losses']}; at dropout 0.1 "
                  f"{got[0]['dropout_loss']:.6f} vs "
                  f"{one['dropout_loss']:.6f} (worst rel {worst_loss:.2e});"
                  f" {got[0]['replicated_checked']} replicated parameters "
                  "bitwise equal across the ranks; the checkpoint restored "
                  f"bitwise in one process in {restore_s[tag]:.2f} s")
            for r, g in enumerate(got):
                coll = (g["profile"].get("collectives") or {})
                reckoned = memory[tag]["total"]
                print(f"  {tag} rank {r}: build {g['build_s']:.2f} s, steps "
                      f"{', '.join(f'{t:.2f}' for t in g['step_ms'])} ms "
                      f"({ref} {one['mean_step_ms']:.2f}), peak "
                      f"{g['peak_gb']:.2f} GB ({ref} {one['peak_gb']:.2f}); "
                      f"state held {g['held_gb']['total']:.2f} GB (reckoned "
                      f"{reckoned:.2f}; {ref} held "
                      f"{one['held_gb']['total']:.2f}); profiled step: busy "
                      f"{g['profile'].get('busy_ms')} ms, share "
                      f"{g['profile'].get('busy_share')}, gloo host "
                      f"{coll.get('host_ms')} ms, device "
                      f"{coll.get('device_ms')} ms; checkpoint "
                      f"{g['checkpoint_s']:.2f} s")
            results[tag] = got
        if keep is not None:
            keep.update(one=ones["15a-moe"], grads=one_grads["15a-moe"],
                        routes=one_routes["15a-moe"],
                        pipe_one=ones["15a-pipe"],
                        pipe_grads=one_grads["15a-pipe"])
        del one_grads, one_routes
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free()
    seconds = time.perf_counter() - t_phase
    print(f"phase 15: {seconds:.1f} s (job {job_s:.2f} s)")
    return dict(card=card, memory_reckoned_gb=memory, one_process=ones,
                ranks=results, agreement=agree, job_s=job_s,
                restore_s=restore_s, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 16: MoE on a sharded mesh (the expert axis beside fsdp and tensor)
# ---------------------------------------------------------------------------

# Phase 15a's MoE model (t5-large of 2 + 2 blocks at full width, 4 experts,
# top-2, capacity factor 1.25, both kernel flags, bf16, Adam, batch 16,
# dropout 0 for the compared steps) on four ranks sharing the card over
# gloo: 16b fsdp 2 x expert 2 (both fsdp ranks on all 16 rows, as each
# MoE layer draws its dropout at the rank's rows; FSDP2 shards the
# bank slices and the rest over the fsdp ranks), 16c tensor 2 x expert 2
# (the four ranks share the rows; rank (t, e) runs columns t of experts e,
# the heads of tensor rank t). 16a is 15a's MoE run: the same seeded
# weights and rows. Each takes a warm-up, one timed step, a profiled step
# and a step at dropout 0.1, then writes a checkpoint that this process
# restores. Held at phase 15's tolerances (``TOL_SPLIT``).
# Phases 16 and 17 run in one job of four ranks (``four_rank_job``): one
# start of four processes and their first-run warm-up, not two.
FOUR_RANKS = 4
MOE_SHARD_RUNS = {"16b": (1, 2, 1, 1, 1, 2), "16c": (1, 1, 2, 1, 1, 2)}


def moe_shard_memory(card: str, runs: dict = MOE_SHARD_RUNS,
                     phase: str = "16") -> dict:
    """Each of a phase's MoE runs' per-rank parameters, gradients and Adam
    moments (GB), reckoned on the meta device before the job."""
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        per_rank_bytes)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
    from klab_multimodalmodel_tpu_torch.utils.mesh import DEFAULT_AXIS_NAMES

    cfg = split_config("15a-moe")
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    shapes = [(n, tuple(p.shape), n in names)
              for n, p in model.named_parameters()]
    out = {tag: {k: v / 1e9 for k, v in per_rank_bytes(
        shapes, dict(zip(DEFAULT_AXIS_NAMES, mesh))).items()}
        for tag, mesh in runs.items()}
    print(f"phase {phase}: state per rank reckoned (GB; params, grads, "
          "Adam): "
          + "; ".join(f"{t} {r['params']:.3f} + {r['grads']:.3f} + "
                      f"{r['moments']:.3f} = {r['total']:.3f}"
                      for t, r in out.items()) + f" [{card}]")
    return out


# Checkpoint saves whose writes go on in the background while a rank job
# runs its next run (``checkpoint_once``, phase 15's saves):
# ``wait_saves`` drains them, in one order on every rank, before the job
# writes its readings (whose saves then hold each write's seconds).
_PENDING_SAVES: list = []


def wait_saves() -> None:
    while _PENDING_SAVES:
        _PENDING_SAVES.pop(0).wait()


def checkpoint_once(trainer, path: str, names, out: str) -> tuple:
    """Save ``trainer``'s per-shard checkpoint under ``path`` (every rank
    writes its own pieces) and write rank 0's whole trainable parameters
    (``names``), gathered once, in fp32, to ``out``, for the comparison
    with the checkpoint restored in one process: (the manager's saves,
    the seconds the save held the rank: the copy of its pieces to the
    host; the write goes on in the background until ``wait_saves``)."""
    import torch

    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)

    gathered = trainer.full_state_dict(names=set(names))
    if trainer.mesh.rank == 0:
        torch.save({n: v.float() for n, v in gathered.items()}, out)
    del gathered
    t0 = time.perf_counter()
    manager = CheckpointManager(path, trainer.mesh)
    manager.save(f"step_{trainer.step}", trainer)
    _PENDING_SAVES.append(manager)
    return manager.saves, time.perf_counter() - t0


def moe_shard_rank_run(run: dict, card: str, device) -> dict:
    """One of phase 16's runs on this rank of the four-rank job
    (``four_rank_main``): its readings; its first step's gradients
    (gathered over its data x fsdp and tensor shards: the banks' slices on
    every rank, the rest on rank 0), rank 0's routings and whole trainable
    parameters after the steps to files, and a checkpoint."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        BANKS, gather_full, tensor_parallel)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    rank = dist.get_rank()
    tag = run["tag"]
    cfg = Config.from_json(json.dumps(run["config"]))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device)
    # Seeded with config.seed on the card: 16a's weights on every
    # rank, then cut and sharded.
    trainer.init_state()
    mesh = trainer.mesh
    check(trainer.ddp is None and trainer.sharded
          and trainer.expert is not None,
          f"{tag}: not a sharded trainer with split banks")
    build_s = time.perf_counter() - t0
    base = f"{run['files']}.{rank}"

    def first(t, calls):
        grads = {}
        for n, p in t.model.named_parameters():
            if p.grad is None:
                continue
            g = gather_full(p.grad.detach())  # every rank, in order
            if rank == 0 or n.endswith(BANKS):
                grads[n] = g.float().cpu()
        torch.save(grads, f"{base}.grads.pt")
        if rank == 0 and calls:
            torch.save(routing_masks(calls), f"{base}.routing.pt")
    r = split_run(trainer, f"{tag} rank {rank}", card,
                  tuple(run["launches"]), first, True)
    # What every rank of a tensor x expert group holds alike (the
    # router among it), bitwise against the group's first rank.
    rows = mesh.rows_group(device.type)
    src = rank - rank % mesh.rows_share
    checked, bad = 0, []
    for n, p in sorted(trainer.model.named_parameters()):
        if trainer.spans_ranks(n) or (
                mesh.tensor > 1 and tensor_parallel(n)):
            continue
        local = (p.to_local() if isinstance(p, DTensor) else p).detach()
        ref = local.clone()
        dist.broadcast(ref, src=src, group=rows)
        checked += 1
        if not torch.equal(ref, local):
            bad.append(n)
    check(checked > 0 and not bad,
          f"{tag} rank {rank}: {len(bad)} of {checked} parameters "
          f"differ across the tensor x expert group: {bad[:5]}")
    saves, checkpoint_s = checkpoint_once(
        trainer, run["checkpoint"], trainable_names(trainer.model, cfg),
        f"{run['files']}.params.pt")
    r.update(build_s=build_s, checkpoint_s=checkpoint_s,
             saves=saves, replicated_checked=checked,
             coordinate=[mesh.dp_rank, mesh.tensor_rank,
                         mesh.expert_rank])
    del trainer
    free()
    return r


def join_banks(parts: list, mesh: tuple) -> dict:
    """Rank 0's gathered tensors (``parts[0]``) whole: a bank's slices,
    held by rank (t, e) of rank 0's tensor x expert group (ranks ``t E +
    e``), joined on its experts' dim 0 and its d_ff (``wi``'s dim 2,
    ``wo``'s dim 1)."""
    import torch

    T, E = mesh[2], mesh[5]
    out = dict(parts[0])
    for n in parts[0]:
        if not n.endswith((".experts_wi", ".experts_wo")):
            continue
        rows = [torch.cat([parts[t * E + e][n] for e in range(E)])
                for t in range(T)]
        out[n] = torch.cat(rows, dim=2 if n.endswith("wi") else 1)
    return out


def moe_shard_phase(card: str, ref: dict, job: dict) -> dict:
    """Phase 16's checks of the four-rank job's 16b (fsdp 2 x expert 2) and
    16c (tensor 2 x expert 2) runs (``four_rank_job``), held against
    ``ref`` (phase 15a's MoE run, ``split_phase``'s ``keep``); each run's
    checkpoint restored here in one process, whose ``Trainer`` is left in
    ``ref["restorer"]`` for phase 19's."""
    import torch

    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    memory, ranks, root = job["memory"]["16"], job["ranks"], job["root"]
    job_s = job["seconds"]["16"]
    one = ref["one"]
    # One process restores each run's checkpoint in turn (phase 19's too).
    trainer = Trainer(split_config("15a-moe"))
    trainer.init_state()
    ref["restorer"] = trainer
    agree, results, restore_s = {}, {}, {}
    for tag, mesh in MOE_SHARD_RUNS.items():
        got = [rk[tag] for rk in ranks]
        for r, g in enumerate(got):
            check(g["losses"] == got[0]["losses"]
                  and g["dropout_loss"] == got[0]["dropout_loss"],
                  f"{tag}: rank {r}'s losses differ from rank 0's: "
                  f"{g['losses']} vs {got[0]['losses']}")
            check(g["launches_per_step"] == one["launches_per_step"],
                  f"{tag} rank {r}: launches {g['launches_per_step']}, "
                  f"16a's {one['launches_per_step']}")
            held, want = g["held_gb"]["total"], memory[tag]["total"]
            check(abs(held - want) <= 1e-3 * want,
                  f"{tag} rank {r}: holds {held:.4f} GB of state, "
                  f"reckoned {want:.4f}")
        losses = got[0]["losses"] + [got[0]["dropout_loss"]]
        want = one["losses"] + [one["dropout_loss"]]
        worst_loss = max(abs(x - y) / abs(y)
                         for x, y in zip(losses, want))
        check(worst_loss <= TOL_SPLIT["loss"],
              f"{tag}: losses (the last at dropout 0.1) {losses} vs "
              f"16a {want}")
        base = os.path.join(root, tag)
        grads = join_banks([torch.load(f"{base}.{r}.grads.pt",
                                       weights_only=True)
                            for r in range(mesh[2] * mesh[5])], mesh)
        agree[tag] = dict(loss_worst_rel=worst_loss, gradients=agreement(
            (got[0]["losses"][0], grads), (one["losses"][0],
                                           ref["grads"]),
            f"{tag} vs 16a, the first step's gradients",
            TOL_SPLIT["grad"]))
        del grads
        diff = routing_differences(torch.load(
            f"{base}.0.routing.pt", weights_only=True), ref["routes"],
            SPLIT_MOE["moe_top_k"])
        share = diff["flipped"] / diff["tokens"]
        agree[tag]["routing"] = dict(diff, share=share)
        print(f"{tag} vs 16a [{card}]: {diff['flipped']} of "
              f"{diff['tokens']} token-routings of the first step "
              f"flipped an expert ({share:.2e}; limit "
              f"{TOL_SPLIT['flipped']})")
        check(share <= TOL_SPLIT["flipped"],
              f"{tag}: {share:.2e} of the routings flipped")
        # The run's checkpoint in one process: the whole trainable
        # parameters rank 0 gathered after the steps, bitwise.
        t0 = time.perf_counter()
        manager = CheckpointManager(os.path.join(root, f"{tag}.ckpt"))
        manager.restore(manager.latest(), trainer)
        params = torch.load(f"{base}.params.pt", weights_only=True)
        restored = trainable_on_host(trainer.model)
        equal = (trainer.step == SPLIT_STEPS + 3
                 and restored.keys() == params.keys()
                 and all(torch.equal(restored[n], params[n])
                         for n in params))
        restore_s[tag] = time.perf_counter() - t0
        check(equal, f"{tag}'s checkpoint restored in one process "
              "differs from the ranks' parameters")
        del params, restored
        free()
        print(f"{tag} vs 16a [{card}]: losses {got[0]['losses']} vs "
              f"{one['losses']}; at dropout 0.1 "
              f"{got[0]['dropout_loss']:.6f} vs "
              f"{one['dropout_loss']:.6f} (worst rel {worst_loss:.2e});"
              f" {got[0]['replicated_checked']} parameters bitwise "
              "equal across each tensor x expert group; the checkpoint "
              f"restored bitwise in one process in {restore_s[tag]:.2f}"
              " s")
        for r, g in enumerate(got):
            coll = (g["profile"].get("collectives") or {})
            print(f"  {tag} rank {r}: build {g['build_s']:.2f} s, steps "
                  f"{', '.join(f'{t:.2f}' for t in g['step_ms'])} ms "
                  f"(16a {one['mean_step_ms']:.2f}), peak "
                  f"{g['peak_gb']:.2f} GB (16a {one['peak_gb']:.2f}); "
                  f"state held {g['held_gb']['total']:.3f} GB (reckoned "
                  f"{memory[tag]['total']:.3f}; 16a held "
                  f"{one['held_gb']['total']:.3f}); profiled step: busy "
                  f"{g['profile'].get('busy_ms')} ms, share "
                  f"{g['profile'].get('busy_share')}, gloo host "
                  f"{coll.get('host_ms')} ms, device "
                  f"{coll.get('device_ms')} ms; checkpoint (its one "
                  f"gather included) {g['checkpoint_s']:.2f} s")
        results[tag] = got
    del trainer
    free()
    seconds = time.perf_counter() - t_phase
    print(f"phase 16: {seconds:.1f} s (its runs in the four-rank "
          f"job {job_s:.2f} s)")
    return dict(card=card, memory_reckoned_gb=memory, ranks=results,
                agreement=agree, job_s=job_s, restore_s=restore_s,
                seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 17: GPipe stages on a sharded mesh (the pipe axis beside fsdp and
# tensor)
# ---------------------------------------------------------------------------

# Phase 15a's pipelined model (t5-large of 2 + 2 blocks at full width, 2
# GPipe stages, 4 microbatches, the T5 kernel off as the JAX package
# requires, the Swin kernel on, bf16, Adam, batch 16, dropout 0 for the
# compared steps) on four ranks sharing the card over gloo: 17a fsdp 2 x
# tensor 2 with the stages unsharded (each rank runs both stages' ticks,
# every block an FSDP2 unit gathered at each tick), 17b fsdp 2 x pipe 2
# (each fsdp rank its 8 rows, stage s's block an FSDP2 unit of pipe rank
# s's two fsdp ranks), 17c tensor 2 x pipe 2 (the four ranks share the
# rows; rank (t, s) runs heads and d_ff columns t of stage s). 15a's
# pipelined run is the reference: the same seeded weights, rows and
# dropout generator. 17b and 17c take a warm-up, one timed step, a
# profiled step and a step at dropout 0.1; 17a a warm-up and one timed
# step. Each run's checkpoint is restored in this process. Held at phase
# 15's tolerances (``TOL_SPLIT``).
PIPE_SHARD_RUNS = {"17a": (1, 2, 2, 1, 1, 1), "17b": (1, 2, 1, 1, 2, 1),
                   "17c": (1, 1, 2, 1, 2, 1)}


def pipe_shard_memory(card: str) -> dict:
    """Each run's per-rank parameters, gradients and Adam moments (GB) for
    each of its pipe ranks, reckoned on the meta device before the job."""
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        per_rank_bytes)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
    from klab_multimodalmodel_tpu_torch.utils.mesh import DEFAULT_AXIS_NAMES

    cfg = split_config("15a-pipe")
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    shapes = [(n, tuple(p.shape), n in names)
              for n, p in model.named_parameters()]
    out = {tag: [{k: v / 1e9 for k, v in per_rank_bytes(
        shapes, dict(zip(DEFAULT_AXIS_NAMES, mesh)), pipe_rank=s).items()}
        for s in range(mesh[4])]
        for tag, mesh in PIPE_SHARD_RUNS.items()}
    print("phase 17: state per rank reckoned (GB; params, grads, Adam; by "
          "pipe rank): " + "; ".join(
              f"{t} " + " / ".join(f"{r['params']:.3f} + {r['grads']:.3f} + "
                                   f"{r['moments']:.3f} = {r['total']:.3f}"
                                   for r in rs)
              for t, rs in out.items()) + f" [{card}]")
    return out


def pipe_shard_rank_run(run: dict, card: str, device) -> dict:
    """One of phase 17's runs on this rank of the four-rank job
    (``four_rank_main``): its readings; its first step's gradients,
    gathered over its data x fsdp and tensor shards (rank 0's whole, and
    the other stage's blocks from the rank that holds rank 0's rows of
    it); and a checkpoint, whose whole state rank 0 also writes (its
    trainable parameters) for the comparison: one gather."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        gather_full, tensor_parallel)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    rank = dist.get_rank()
    tag = run["tag"]
    cfg = Config.from_json(json.dumps(run["config"]))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device)
    # Seeded with config.seed on the card: 15a's weights on every
    # rank, then split into stages and sharded.
    trainer.init_state()
    mesh = trainer.mesh
    check(trainer.ddp is None and trainer.sharded
          and (trainer.pipe is not None) == (mesh.pipe > 1),
          f"{tag}: not a sharded trainer with its stages as the mesh "
          "says")
    build_s = time.perf_counter() - t0
    base = f"{run['files']}.{rank}"
    # The rank that holds rank 0's rows of the other stage (pipe rank
    # 1 at data, fsdp and tensor 0).
    stage_source = rank == mesh.expert * (mesh.pipe - 1)

    def first(t, calls):
        grads = {}
        for n, p in t.model.named_parameters():
            if p.grad is None:
                continue
            g = gather_full(p.grad.detach())  # every rank, in order
            if rank == 0 or (stage_source and t.spans_ranks(n)):
                grads[n] = g.float().cpu()
        torch.save(grads, f"{base}.grads.pt")
    r = split_run(trainer, f"{tag} rank {rank}", card,
                  tuple(run["launches"]), first, True,
                  extras=run["extras"], own_rows=True)
    # What every rank of a tensor x pipe group holds alike (outside
    # the stages, and not split over tensor), bitwise against the
    # group's first rank.
    rows = mesh.rows_group(device.type)
    src = rank - rank % mesh.rows_share
    checked, bad = 0, []
    for n, p in sorted(trainer.model.named_parameters()):
        if trainer.spans_ranks(n) or (
                mesh.tensor > 1 and tensor_parallel(n)):
            continue
        local = (p.to_local() if isinstance(p, DTensor) else p).detach()
        ref = local.clone()
        dist.broadcast(ref, src=src, group=rows)
        checked += 1
        if not torch.equal(ref, local):
            bad.append(n)
    check(checked > 0 and not bad,
          f"{tag} rank {rank}: {len(bad)} of {checked} parameters "
          f"differ across the tensor x pipe group: {bad[:5]}")
    # The whole model's trainable names (the rank holds one stage).
    names = ({n for g in trainer._whole_groups for n in g}
             if trainer.split_model
             else trainable_names(trainer.model, cfg))
    saves, checkpoint_s = checkpoint_once(
        trainer, run["checkpoint"], names, f"{run['files']}.params.pt")
    r.update(build_s=build_s, checkpoint_s=checkpoint_s,
             saves=saves, replicated_checked=checked,
             coordinate=[mesh.dp_rank, mesh.tensor_rank,
                         mesh.pipe_rank])
    del trainer
    free()
    return r


def pipe_shard_phase(card: str, ref: dict, job: dict) -> dict:
    """Phase 17's checks of the four-rank job's 17a (the stages unsharded
    on fsdp 2 x tensor 2), 17b (fsdp 2 x pipe 2) and 17c (tensor 2 x pipe
    2) runs (``four_rank_job``), held against ``ref`` (phase 15a's
    pipelined run, ``split_phase``'s ``keep``); each run's checkpoint
    restored here in one process."""
    import torch

    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    memory, ranks, root = job["memory"]["17"], job["ranks"], job["root"]
    job_s = job["seconds"]["17"]
    one = ref["pipe_one"]
    # One process restores each run's checkpoint in turn.
    trainer = Trainer(split_config("15a-pipe"))
    trainer.init_state()
    agree, results, restore_s = {}, {}, {}
    for tag, mesh in PIPE_SHARD_RUNS.items():
        got = [rk[tag] for rk in ranks]
        extras = tag != "17a"
        for r, g in enumerate(got):
            check(g["losses"] == got[0]["losses"]
                  and g["dropout_loss"] == got[0]["dropout_loss"],
                  f"{tag}: rank {r}'s losses differ from rank 0's: "
                  f"{g['losses']} vs {got[0]['losses']}")
            check(g["launches_per_step"] == one["launches_per_step"],
                  f"{tag} rank {r}: launches {g['launches_per_step']}, "
                  f"15a's {one['launches_per_step']}")
            held = g["held_gb"]["total"]
            want = memory[tag][g["coordinate"][2]]["total"]
            check(abs(held - want) <= 1e-3 * want,
                  f"{tag} rank {r}: holds {held:.4f} GB of state, "
                  f"reckoned {want:.4f}")
        losses = got[0]["losses"] + (
            [got[0]["dropout_loss"]] if extras else [])
        want = one["losses"] + ([one["dropout_loss"]] if extras else [])
        worst_loss = max(abs(x - y) / abs(y)
                         for x, y in zip(losses, want))
        check(worst_loss <= TOL_SPLIT["loss"],
              f"{tag}: losses {losses} vs 15a {want}")
        base = os.path.join(root, tag)
        grads = {}
        for r in range(FOUR_RANKS):
            if os.path.exists(f"{base}.{r}.grads.pt"):
                grads.update(torch.load(f"{base}.{r}.grads.pt",
                                        weights_only=True))
        agree[tag] = dict(loss_worst_rel=worst_loss, gradients=agreement(
            (got[0]["losses"][0], grads), (one["losses"][0],
                                           ref["pipe_grads"]),
            f"{tag} vs 15a, the first step's gradients",
            TOL_SPLIT["grad"]))
        del grads
        # The run's checkpoint in one process: the whole trainable
        # parameters that rank 0 gathered for it, bitwise.
        t0 = time.perf_counter()
        manager = CheckpointManager(os.path.join(root, f"{tag}.ckpt"))
        manager.restore(manager.latest(), trainer)
        params = torch.load(f"{base}.params.pt", weights_only=True)
        restored = trainable_on_host(trainer.model)
        steps = SPLIT_STEPS + (3 if extras else 1)
        equal = (trainer.step == steps
                 and restored.keys() == params.keys()
                 and all(torch.equal(restored[n], params[n])
                         for n in params))
        restore_s[tag] = time.perf_counter() - t0
        check(equal, f"{tag}'s checkpoint restored in one process "
              "differs from the ranks' parameters")
        del params, restored
        free()
        dropout = (f"; at dropout 0.1 {got[0]['dropout_loss']:.6f} vs "
                   f"{one['dropout_loss']:.6f}" if extras else "")
        print(f"{tag} vs 15a [{card}]: losses {got[0]['losses']} vs "
              f"{one['losses'][:len(got[0]['losses'])]}{dropout} (worst "
              f"rel {worst_loss:.2e}); {got[0]['replicated_checked']} "
              "parameters bitwise equal across each tensor x pipe "
              "group; the checkpoint restored bitwise in one process "
              f"in {restore_s[tag]:.2f} s")
        for r, g in enumerate(got):
            coll = (g["profile"].get("collectives") or {})
            print(f"  {tag} rank {r} (data x fsdp, tensor, pipe "
                  f"{g['coordinate']}): build {g['build_s']:.2f} s, "
                  f"steps {', '.join(f'{t:.2f}' for t in g['step_ms'])} "
                  f"ms (15a {one['mean_step_ms']:.2f}), peak "
                  f"{g['peak_gb']:.2f} GB (15a {one['peak_gb']:.2f}); "
                  f"state held {g['held_gb']['total']:.3f} GB (reckoned "
                  f"{memory[tag][g['coordinate'][2]]['total']:.3f}; 15a "
                  f"held {one['held_gb']['total']:.3f}); profiled step: "
                  f"busy {g['profile'].get('busy_ms')} ms, share "
                  f"{g['profile'].get('busy_share')}, gloo host "
                  f"{coll.get('host_ms')} ms, device "
                  f"{coll.get('device_ms')} ms; checkpoint "
                  f"{g['checkpoint_s']:.2f} s")
        results[tag] = got
    del trainer
    free()
    seconds = time.perf_counter() - t_phase
    print(f"phase 17: {seconds:.1f} s (its runs in the four-rank "
          f"job {job_s:.2f} s)")
    return dict(card=card, memory_reckoned_gb=memory, ranks=results,
                agreement=agree, job_s=job_s, restore_s=restore_s,
                seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 18: sequence parallelism beside FSDP2 and tensor parallelism (the
# seq axis with fsdp and tensor)
# ---------------------------------------------------------------------------

# Phase 14's model and rows (t5-large of 2 + 2 blocks at full width behind
# the default towers at full depth, bf16, Adam, batch 16, dropout 0 for the
# compared steps) on four ranks sharing the card over gloo: 18a fsdp 2 x
# seq 2 on the all-gather path with both kernel flags (FSDP2 under seq, the
# T5 kernels at q_offset; both fsdp ranks on all 16 rows, as 16b, so that
# every dropout mask is one process's), 18b tensor 2 x seq 2 with both
# kernel flags (the transformer's T5 kernels at heads 8..15 of 16 and seq
# rank 1's rows at once; the frozen text tower whole over tensor, at
# q_offset only), 18c tensor 2 x seq 2 on the ring, the T5 kernel off.
# Each takes a warm-up, a step at dropout 0.1 and one timed step: its
# first loss and first-step gradients against 14a's (14a' for the ring) at
# phase 15's tolerances (``TOL_SPLIT``), its dropout step's loss against
# the loss at dropout 0.1 of 14a (14c for the ring) after its warm-up,
# from the same generator state (``dropout_probe``): the masks are one
# process's because the T5 kernels' and the ring's Philox bits key on the
# global head and query and every other mask is drawn whole and sliced.
# With the T5 kernel off one process's self-attention draws the
# generator's own masks, so the ring's reference is 14c, the ring at seq 2
# on all heads. 18a writes a checkpoint that this process restores. 18d:
# the T5 kernels at an 18b rank's transformer shapes.
SEQ_SHARD_RUNS = {"18a": (1, 2, 1, 2), "18b": (1, 1, 2, 2),
                  "18c": (1, 1, 2, 2)}
SEQ_SHARD_REFS = {"18a": ("14a", "14a"), "18b": ("14a", "14a"),
                  "18c": ("14a'", "14c")}  # (first step, dropout step)


def seq_shard_config(tag: str):
    """Run ``tag``'s config: phase 14's, on its mesh (18c on the ring with
    the T5 kernel off)."""
    ring = (dict(seq_attention="ring", use_pallas_t5_attention=False)
            if tag == "18c" else {})
    return seq_config(mesh_shape=SEQ_SHARD_RUNS[tag], **ring)


def seq_shard_memory(card: str) -> dict:
    """Each run's per-rank parameters, gradients and Adam moments (GB),
    reckoned on the meta device before the job (``seq`` replicates: the
    same as without it)."""
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        per_rank_bytes)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
    from klab_multimodalmodel_tpu_torch.utils.mesh import DEFAULT_AXIS_NAMES

    cfg = seq_config()
    model = MultiModalModel(cfg, device="meta")
    names = trainable_names(model, cfg)
    shapes = [(n, tuple(p.shape), n in names)
              for n, p in model.named_parameters()]
    out = {tag: {k: v / 1e9 for k, v in per_rank_bytes(
        shapes, dict(zip(DEFAULT_AXIS_NAMES, mesh))).items()}
        for tag, mesh in SEQ_SHARD_RUNS.items()}
    print("phase 18: state per rank reckoned (GB; params, grads, Adam): "
          + "; ".join(f"{t} {r['params']:.3f} + {r['grads']:.3f} + "
                      f"{r['moments']:.3f} = {r['total']:.3f}"
                      for t, r in out.items()) + f" [{card}]")
    return out


def seq_shard_rank_run(run: dict, card: str, device) -> dict:
    """One of phase 18's runs on this rank of the four-rank job
    (``four_rank_main``): a warm-up, whose gradients rank 0 writes whole
    (gathered over the data x fsdp and tensor shards: every rank takes
    part), a step at dropout 0.1 and one timed step, launches checked;
    what the seq group holds compared across it, bitwise; 18a's
    checkpoint, whose whole state rank 0 also writes (its trainable
    parameters) for the comparison."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.ops import ring_attention
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        gather_full)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    rank = dist.get_rank()
    tag = run["tag"]
    what = f"{tag} rank {rank}"
    cfg = Config.from_json(json.dumps(run["config"]))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device)
    # Seeded with config.seed on the card: 14a's weights on every rank,
    # then sharded.
    trainer.init_state()
    mesh = trainer.mesh
    check(trainer.ddp is None and trainer.sharded and mesh.seq == 2,
          f"{what}: not a sharded trainer over 2 seq ranks")
    build_s = time.perf_counter() - t0
    batch = train_batch(cfg, SEQ_BATCH, SEED)  # every rank all 16 rows
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    probe = dropout_probe(trainer, batch)
    before = ring_attention.exchanges
    t0 = time.perf_counter()
    first = float(trainer.train_step(batch, gen))
    first_ms = (time.perf_counter() - t0) * 1e3
    exchanges = ring_attention.exchanges - before
    if run["ring"]:
        check(exchanges == SEQ_RING_EXCHANGES,
              f"{what}: the ring turned {exchanges} times in a step, "
              f"expected {SEQ_RING_EXCHANGES}")
    grads = {}
    for n, p in trainer.model.named_parameters():
        if p.grad is not None:
            g = gather_full(p.grad.detach())  # every rank, in order
            if rank == 0:
                grads[n] = g.float().cpu()
    if rank == 0:
        torch.save(grads, f"{run['files']}.grads.pt")
    del grads
    # A step at dropout 0.1 on the generator the warm-up left untouched.
    set_dropout(trainer.model.transformer, RATE)
    reset_counts()
    dropout_loss = float(trainer.train_step(batch, gen))
    got = launch_counts()
    set_dropout(trainer.model.transformer, 0.0)
    check(got == run["launches_dropout"] and math.isfinite(dropout_loss),
          f"{what}: the dropout step's loss {dropout_loss}, launches "
          f"{got}, expected {run['launches_dropout']}")
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = timed_steps(trainer, batch, gen, 1,
                                            run["launches"], what)
    r = dict(losses=[first] + losses, dropout_loss=dropout_loss,
             dropout_probe=probe, first_step_ms=first_ms, step_ms=step_ms,
             mean_step_ms=sum(step_ms) / len(step_ms),
             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches_per_step=per_step, ring_exchanges_per_step=exchanges,
             held_gb=held_bytes(trainer),
             coordinate=[mesh.dp_rank, mesh.tensor_rank, mesh.seq_rank])
    check(all(math.isfinite(x) for x in r["losses"]),
          f"{what}: non-finite loss {r['losses']}")
    # Every trainable shard a rank holds, bitwise against its seq group's
    # first rank's (the seq ranks of a data x fsdp x tensor coordinate
    # hold the same shards; the frozen ones take no update).
    group = mesh.seq_group(device.type)
    src = rank - mesh.seq_rank * mesh.pipe * mesh.expert
    checked, bad = 0, []
    for n, p in sorted(trainer.model.named_parameters()):
        if not p.requires_grad:
            continue
        local = (p.to_local() if isinstance(p, DTensor) else p).detach()
        ref = local.clone()
        dist.broadcast(ref, src=src, group=group)
        checked += 1
        if not torch.equal(ref, local):
            bad.append(n)
    check(checked > 0 and not bad,
          f"{what}: {len(bad)} of {checked} parameters differ across the "
          f"seq group: {bad[:5]}")
    r.update(build_s=build_s, replicated_checked=checked)
    if run["checkpoint"]:
        r["saves"], r["checkpoint_s"] = checkpoint_once(
            trainer, run["checkpoint"], trainable_names(trainer.model, cfg),
            f"{run['files']}.params.pt")
    print(f"{what} [{card}]: losses {r['losses']}, dropout-0.1 step "
          f"{dropout_loss:.6f}, steps {', '.join(f'{t:.2f}' for t in step_ms)}"
          f" ms, peak {r['peak_gb']:.2f} GB, launches {per_step}; holds "
          f"{r['held_gb']['total']:.3f} GB of state", flush=True)
    del trainer
    free()
    return r


def seq_18d_shapes() -> list[tuple["T5Shape", tuple[int, int]]]:
    """(shape, (head_offset, q_offset) of an 18b rank at tensor rank 1 and
    seq rank 1) of the transformer's T5 kernel launches in an 18b rank's
    step: heads 8..15 of 16 at its half of the encoder's 320 queries and
    the decoder's 128, against every key. (Its text tower's launches run
    all 16 heads at ``q_offset`` only: 14e's text shape.)"""
    return [(sh, (T5_H // 2, off)) for sh, off in seq_kernel_shapes()
            if sh.name != "text"]


def seq_shard_phase(card: str, ref: dict, job: dict) -> dict:
    """Phase 18's checks of the four-rank job's 18a (fsdp 2 x seq 2), 18b
    (tensor 2 x seq 2) and 18c (the same on the ring) runs
    (``four_rank_job``), held against ``ref`` (phase 14's one-process
    runs and 14c, ``seq_phase``'s ``keep``); 18a's checkpoint restored here
    in one process; then 18d, the T5 kernels at an 18b rank's shapes."""
    import torch

    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    memory, ranks, root = job["memory"]["18"], job["ranks"], job["root"]
    job_s = job["seconds"]["18"]
    agree, results, restore_s = {}, {}, None
    for tag in SEQ_SHARD_RUNS:
        got = [rk[tag] for rk in ranks]
        first_ref, drop_ref = SEQ_SHARD_REFS[tag]
        one = ref["one"][first_ref]
        for r, g in enumerate(got):
            check(g["losses"] == got[0]["losses"]
                  and g["dropout_loss"] == got[0]["dropout_loss"],
                  f"{tag}: rank {r}'s losses differ from rank 0's: "
                  f"{g['losses']} vs {got[0]['losses']}")
            check(g["launches_per_step"] == one["launches_per_step"],
                  f"{tag} rank {r}: launches {g['launches_per_step']}, "
                  f"{first_ref}'s {one['launches_per_step']}")
            held, want = g["held_gb"]["total"], memory[tag]["total"]
            check(abs(held - want) <= 1e-3 * want,
                  f"{tag} rank {r}: holds {held:.4f} GB of state, "
                  f"reckoned {want:.4f}")
        def rel(x, y):
            return abs(x - y) / abs(y)
        before, after = ref["dropout_probes"][drop_ref]
        first_rel = rel(got[0]["losses"][0], one["losses"][0])
        probe_rel = rel(got[0]["dropout_probe"], before)
        drop_rel = rel(got[0]["dropout_loss"], after)
        check(max(first_rel, probe_rel, drop_rel) <= TOL_SPLIT["loss"],
              f"{tag}: first loss {got[0]['losses'][0]} vs {first_ref} "
              f"{one['losses'][0]}; at dropout 0.1 before it "
              f"{got[0]['dropout_probe']} vs {drop_ref} {before}, the "
              f"dropout step {got[0]['dropout_loss']} vs {after}")
        grads = torch.load(os.path.join(root, f"{tag}.grads.pt"),
                           weights_only=True)
        agree[tag] = dict(first_loss_rel=first_rel,
                          dropout_probe_rel=probe_rel,
                          dropout_loss_rel=drop_rel, gradients=agreement(
                              (got[0]["losses"][0], grads),
                              (one["losses"][0], ref["grads"][first_ref]),
                              f"{tag} vs {first_ref}, the first step's "
                              "gradients", TOL_SPLIT["grad"]))
        del grads
        print(f"{tag} vs {first_ref} [{card}]: first loss "
              f"{got[0]['losses'][0]:.6f} vs {one['losses'][0]:.6f} (rel "
              f"{first_rel:.2e}); at dropout 0.1 on the first weights "
              f"{got[0]['dropout_probe']:.6f} vs {drop_ref}'s "
              f"{before:.6f} (rel {probe_rel:.2e}), the dropout step "
              f"{got[0]['dropout_loss']:.6f} vs {after:.6f} (rel "
              f"{drop_rel:.2e}); "
              f"{got[0]['replicated_checked']} parameters bitwise equal "
              "across each seq group")
        for r, g in enumerate(got):
            print(f"  {tag} rank {r} (data x fsdp, tensor, seq "
                  f"{g['coordinate']}): build {g['build_s']:.2f} s, first "
                  f"step {g['first_step_ms']:.2f} ms, timed step "
                  f"{', '.join(f'{t:.2f}' for t in g['step_ms'])} ms "
                  f"({first_ref} {one['mean_step_ms']:.2f}), peak "
                  f"{g['peak_gb']:.2f} GB ({first_ref} "
                  f"{one['peak_gb']:.2f}); state held "
                  f"{g['held_gb']['total']:.3f} GB (reckoned "
                  f"{memory[tag]['total']:.3f})"
                  + (f"; checkpoint {g['checkpoint_s']:.2f} s"
                     if "checkpoint_s" in g else ""))
        results[tag] = got
    # 18a's checkpoint in one process: the whole trainable parameters that
    # rank 0 gathered for it, bitwise.
    t0 = time.perf_counter()
    trainer = Trainer(seq_config())
    trainer.init_state()
    manager = CheckpointManager(os.path.join(root, "18a.ckpt"))
    manager.restore(manager.latest(), trainer)
    params = torch.load(os.path.join(root, "18a.params.pt"),
                        weights_only=True)
    restored = trainable_on_host(trainer.model)
    equal = (trainer.step == 3 and restored.keys() == params.keys()
             and all(torch.equal(restored[n], params[n]) for n in params))
    restore_s = time.perf_counter() - t0
    check(equal, "18a's checkpoint restored in one process differs from "
          "the ranks' parameters")
    print(f"18a [{card}]: the checkpoint restored bitwise in one process "
          f"in {restore_s:.2f} s")
    del trainer, params, restored
    free()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    kernels = check_t5_offsets(gen, card, "18b rank", seq_18d_shapes(),
                               T5_H // 2, T5_D, ("head_offset", "q_offset"),
                               0.0)
    seconds = time.perf_counter() - t_phase
    print(f"phase 18: {seconds:.1f} s (its runs in the four-rank job "
          f"{job_s:.2f} s)")
    return dict(card=card, memory_reckoned_gb=memory, ranks=results,
                agreement=agree, job_s=job_s, restore_s=restore_s,
                kernels=kernels, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 19: MoE under sequence parallelism (routing groups that span the
# seq ranks; the expert axis beside seq)
# ---------------------------------------------------------------------------

# Phase 15a's MoE model (t5-large of 2 + 2 blocks at full width, 4 experts,
# top-2, capacity factor 1.25, both kernel flags, bf16, Adam, batch 16,
# dropout 0 for the compared steps) on the four ranks of phases 16-18's
# job, all 16 rows on every rank: 19a seq 2 x expert 2 (rank (s, e) runs
# seq rank s's positions of every stack and experts [2e, 2e + 2); DDP over
# the two seq ranks of each expert slice), 19b tensor 2 x seq 2 (rank (t,
# s) runs columns t of every expert, and heads t, at positions s; FSDP2
# and tensor parallelism). Each routing group spans the seq ranks: a
# rank's slots are offset by the earlier seq rank's choices, at the
# capacity of the full length. 16a (15a's MoE run) is the reference: the
# same seeded weights, rows and generator. Each run takes a loss at
# dropout 0.1 with no update (``dropout_probe``), a warm-up, a step at
# dropout 0.1 and one timed step: its first loss, first-step gradients,
# routings and the tokens each routing call dropped at capacity against
# 16a's warm-up, its dropout losses against 16a's probes before and after
# its warm-up. 19a writes a checkpoint that this process restores.
MOE_SEQ_RUNS = {"19a": (1, 1, 1, 2, 1, 2), "19b": (1, 1, 2, 2, 1, 1)}
# First loss (relative) and first-step gradients against 16a: 19a splits
# only positions and experts (its partial combines summed in fp32, as
# 15b's); 19b also splits heads and d_ff columns in bf16, as 16c and 18b.
TOL_MOE_SEQ = {
    "19a": dict(loss=1e-5, grad=dict(cosine=0.9999, norm=0.02,
                                     total=0.9999)),
    "19b": dict(loss=5e-5, grad=dict(cosine=0.999, norm=0.02,
                                     total=0.999)),
}


def moe_seq_rank_run(run: dict, card: str, device) -> dict:
    """One of phase 19's runs on this rank of the four-rank job
    (``four_rank_main``): a loss at dropout 0.1 with no update, a warm-up
    (its gradients gathered whole over the shards: the bank slices from
    every rank of seq rank 0, the rest from rank 0; and seq rank 0's and
    1's routings of their positions, from their tensor and expert rank 0),
    a step at dropout 0.1 and one timed step, launches checked; what the
    seq group holds compared across it, bitwise; 19a's checkpoint, whose
    whole trainable parameters rank 0 also writes for the comparison."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        BANKS, gather_full)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    rank = dist.get_rank()
    tag = run["tag"]
    what = f"{tag} rank {rank}"
    cfg = Config.from_json(json.dumps(run["config"]))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device)
    # Seeded with config.seed on the card: 16a's weights on every rank,
    # then cut (and sharded).
    trainer.init_state()
    mesh = trainer.mesh
    check(mesh.seq == 2 and trainer.expert is not None,
          f"{what}: not an MoE trainer over 2 seq ranks with split banks")
    build_s = time.perf_counter() - t0
    batch = train_batch(cfg, SPLIT_BATCH, SEED)  # every rank all 16 rows
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    probe = dropout_probe(trainer, batch)
    t0 = time.perf_counter()
    with RoutingRecorder() as recorder:
        first = float(trainer.train_step(batch, gen))
    first_ms = (time.perf_counter() - t0) * 1e3
    dropped = [int(d) for d in recorder.dropped]
    lead = mesh.tensor_rank == 0 and mesh.expert_rank == 0
    if lead:
        torch.save(routing_masks(recorder.calls),
                   f"{run['files']}.s{mesh.seq_rank}.routing.pt")
    del recorder
    grads = {}
    for n, p in trainer.model.named_parameters():
        if p.grad is None:
            continue
        g = gather_full(p.grad.detach())  # every rank, in order
        if rank == 0 or (mesh.seq_rank == 0 and n.endswith(BANKS)):
            grads[n] = g.float().cpu()
    if mesh.seq_rank == 0:
        torch.save(grads, f"{run['files']}.{rank}.grads.pt")
    del grads
    # A step at dropout 0.1 on the generator the warm-up left untouched.
    set_dropout(trainer.model.transformer, RATE)
    reset_counts()
    dropout_loss = float(trainer.train_step(batch, gen))
    got = launch_counts()
    set_dropout(trainer.model.transformer, 0.0)
    check(got == run["launches_dropout"] and math.isfinite(dropout_loss),
          f"{what}: the dropout step's loss {dropout_loss}, launches "
          f"{got}, expected {run['launches_dropout']}")
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = timed_steps(trainer, batch, gen, 1,
                                            run["launches"], what)
    r = dict(losses=[first] + losses, dropout_loss=dropout_loss,
             dropout_probe=probe, dropped=dropped, first_step_ms=first_ms,
             step_ms=step_ms, mean_step_ms=sum(step_ms) / len(step_ms),
             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches_per_step=per_step, held_gb=held_bytes(trainer),
             coordinate=[mesh.tensor_rank, mesh.seq_rank, mesh.expert_rank])
    check(all(math.isfinite(x) for x in r["losses"]),
          f"{what}: non-finite loss {r['losses']}")
    # Every trainable parameter or shard a rank holds (its bank slices
    # among them), bitwise against its seq group's first rank's.
    group = mesh.seq_group(device.type)
    src = rank - mesh.seq_rank * mesh.pipe * mesh.expert
    checked, bad = 0, []
    for n, p in sorted(trainer.model.named_parameters()):
        if not p.requires_grad:
            continue
        local = (p.to_local() if isinstance(p, DTensor) else p).detach()
        ref = local.clone()
        dist.broadcast(ref, src=src, group=group)
        checked += 1
        if not torch.equal(ref, local):
            bad.append(n)
    check(checked > 0 and not bad,
          f"{what}: {len(bad)} of {checked} parameters differ across the "
          f"seq group: {bad[:5]}")
    r.update(build_s=build_s, replicated_checked=checked)
    if run["checkpoint"]:
        r["saves"], r["checkpoint_s"] = checkpoint_once(
            trainer, run["checkpoint"], trainable_names(trainer.model, cfg),
            f"{run['files']}.params.pt")
    print(f"{what} [{card}]: losses {r['losses']}, dropout-0.1 step "
          f"{dropout_loss:.6f}, steps {', '.join(f'{t:.2f}' for t in step_ms)}"
          f" ms, peak {r['peak_gb']:.2f} GB, launches {per_step}; holds "
          f"{r['held_gb']['total']:.3f} GB of state", flush=True)
    del trainer
    free()
    return r


def moe_seq_phase(card: str, ref: dict, job: dict) -> dict:
    """Phase 19's checks of the four-rank job's 19a (seq 2 x expert 2) and
    19b (tensor 2 x seq 2) runs (``four_rank_job``), held against ``ref``
    (16a: phase 15a's MoE run, ``split_phase``'s ``keep``); 19a's
    checkpoint restored here in one process (phase 16's ``Trainer``, which
    ``ref["restorer"]`` holds, or a new one)."""
    import torch

    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    memory, ranks, root = job["memory"]["19"], job["ranks"], job["root"]
    job_s = job["seconds"]["19"]
    one = ref["one"]
    before, after = one["dropout_probes"]
    top_k = SPLIT_MOE["moe_top_k"]
    agree, results = {}, {}
    for tag, mesh in MOE_SEQ_RUNS.items():
        got = [rk[tag] for rk in ranks]
        T, S, E = mesh[2], mesh[3], mesh[5]
        for r, g in enumerate(got):
            check(g["losses"] == got[0]["losses"]
                  and g["dropout_loss"] == got[0]["dropout_loss"]
                  and g["dropout_probe"] == got[0]["dropout_probe"],
                  f"{tag}: rank {r}'s losses differ from rank 0's: "
                  f"{g['losses']} vs {got[0]['losses']}")
            check(g["launches_per_step"] == one["launches_per_step"],
                  f"{tag} rank {r}: launches {g['launches_per_step']}, "
                  f"16a's {one['launches_per_step']}")
            held, want = g["held_gb"]["total"], memory[tag]["total"]
            check(abs(held - want) <= 1e-3 * want,
                  f"{tag} rank {r}: holds {held:.4f} GB of state, "
                  f"reckoned {want:.4f}")

        def rel(x, y):
            return abs(x - y) / abs(y)
        first_rel = rel(got[0]["losses"][0], one["losses"][0])
        probe_rel = rel(got[0]["dropout_probe"], before)
        drop_rel = rel(got[0]["dropout_loss"], after)
        tol = TOL_MOE_SEQ[tag]
        check(first_rel <= tol["loss"],
              f"{tag}: first loss {got[0]['losses'][0]} vs 16a "
              f"{one['losses'][0]} (rel {first_rel:.2e})")
        check(max(probe_rel, drop_rel) <= TOL_SPLIT["loss"],
              f"{tag}: at dropout 0.1 before the first step "
              f"{got[0]['dropout_probe']} vs 16a {before}, the dropout step "
              f"{got[0]['dropout_loss']} vs {after}")
        base = os.path.join(root, tag)
        # Seq rank 0's ranks of each tensor x expert place hold the banks.
        grads = join_banks([torch.load(
            f"{base}.{t * S * E + e}.grads.pt", weights_only=True)
            for t in range(T) for e in range(E)], mesh)
        agree[tag] = dict(first_loss_rel=first_rel,
                          dropout_probe_rel=probe_rel,
                          dropout_loss_rel=drop_rel, gradients=agreement(
                              (got[0]["losses"][0], grads),
                              (one["losses"][0], ref["grads"]),
                              f"{tag} vs 16a, the first step's gradients",
                              tol["grad"]))
        del grads
        # The seq ranks' routings of their positions, joined on S.
        parts = [torch.load(f"{base}.s{s}.routing.pt", weights_only=True)
                 for s in range(S)]
        routes = [(torch.cat([p[i][0] for p in parts], dim=1),
                   torch.cat([p[i][1] for p in parts], dim=1))
                  for i in range(len(parts[0]))]
        diff = routing_differences(routes, ref["routes"], top_k)
        share = diff["flipped"] / diff["tokens"]
        # Each seq rank's positions' drops, from its tensor and expert
        # rank 0 (rank s E).
        dropped = [sum(got[s * E]["dropped"][i] for s in range(S))
                   for i in range(len(one["dropped"]))]
        agree[tag].update(routing=dict(diff, share=share), dropped=dropped)
        print(f"{tag} vs 16a [{card}]: {diff['flipped']} of "
              f"{diff['tokens']} token-routings of the first step flipped "
              f"an expert ({share:.2e}; limit {TOL_SPLIT['flipped']}); "
              f"(token, expert) choices dropped at capacity by routing "
              f"call {dropped} (16a {one['dropped']})")
        check(share <= TOL_SPLIT["flipped"],
              f"{tag}: {share:.2e} of the routings flipped")
        print(f"{tag} vs 16a [{card}]: first loss "
              f"{got[0]['losses'][0]:.6f} vs {one['losses'][0]:.6f} (rel "
              f"{first_rel:.2e}, limit {tol['loss']}); at dropout 0.1 on "
              f"the first weights {got[0]['dropout_probe']:.6f} vs "
              f"{before:.6f} (rel {probe_rel:.2e}), the dropout step "
              f"{got[0]['dropout_loss']:.6f} vs {after:.6f} (rel "
              f"{drop_rel:.2e}); {got[0]['replicated_checked']} parameters "
              "bitwise equal across each seq group")
        for r, g in enumerate(got):
            print(f"  {tag} rank {r} (tensor, seq, expert "
                  f"{g['coordinate']}): build {g['build_s']:.2f} s, first "
                  f"step {g['first_step_ms']:.2f} ms, timed step "
                  f"{', '.join(f'{t:.2f}' for t in g['step_ms'])} ms (16a "
                  f"{one['mean_step_ms']:.2f}), peak {g['peak_gb']:.2f} GB "
                  f"(16a {one['peak_gb']:.2f}); state held "
                  f"{g['held_gb']['total']:.3f} GB (reckoned "
                  f"{memory[tag]['total']:.3f})"
                  + (f"; checkpoint {g['checkpoint_s']:.2f} s"
                     if "checkpoint_s" in g else ""))
        results[tag] = got
    # 19a's checkpoint in one process: the whole trainable parameters that
    # rank 0 gathered for it (one copy of each expert slice), bitwise.
    t0 = time.perf_counter()
    trainer = ref.pop("restorer", None)
    if trainer is None:
        trainer = Trainer(split_config("15a-moe"))
        trainer.init_state()
    manager = CheckpointManager(os.path.join(root, "19a.ckpt"))
    manager.restore(manager.latest(), trainer)
    params = torch.load(os.path.join(root, "19a.params.pt"),
                        weights_only=True)
    restored = trainable_on_host(trainer.model)
    equal = (trainer.step == 3 and restored.keys() == params.keys()
             and all(torch.equal(restored[n], params[n]) for n in params))
    restore_s = time.perf_counter() - t0
    check(equal, "19a's checkpoint restored in one process differs from "
          "the ranks' parameters")
    print(f"19a [{card}]: the checkpoint restored bitwise in one process "
          f"in {restore_s:.2f} s")
    del trainer, params, restored
    free()
    seconds = time.perf_counter() - t_phase
    print(f"phase 19: {seconds:.1f} s (its runs in the four-rank job "
          f"{job_s:.2f} s)")
    return dict(card=card, memory_reckoned_gb=memory, ranks=results,
                agreement=agree, job_s=job_s, restore_s=restore_s,
                seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 20: sharded init and per-shard checkpoints (t5-11b)
# ---------------------------------------------------------------------------

# 20a: t5-11b at full width and depth (24 + 24 blocks) behind the default
# towers, at fsdp 2 x tensor 2 on the four ranks of phases 16-19's job,
# which run it first, on an empty card: ``init_state()`` alone (Adam's
# moments of its 46.92 GB of parameters would not fit four ranks on one
# card), the model built on the meta device and each rank's pieces drawn
# whole one parameter at a time. Held: each rank's parameters are its
# reckoning (``per_rank_bytes``); its peak over the init is at most its
# pieces plus ``INIT_SLACK_GB`` (the largest whole parameter is 0.268
# GB); ``INIT_SAMPLES``, gathered to rank 0 one at a time, equal bitwise
# the same names of one process's plan at 24 + 24 blocks, drawn in this
# process a parameter at a time into temporaries (``plan_fingerprints``),
# and those drawn before the transformer's second block also equal the
# one-process ``init_state()`` of 20b's 1 + 1 blocks (after block 0 the
# draw order of 24 + 24 blocks and of 1 + 1 parts: the decoder's block 0
# comes after 23 more encoder blocks). 20b: t5-11b at full width, 1 + 1
# blocks, dropout 0, both kernel flags, bf16, Adam, batch 16, fsdp 2 x
# tensor 2: the init's pieces bitwise one process's ``init_state()``
# (fingerprints of every rank's pieces, ``fingerprint``); one step
# (launches checked); a per-shard checkpoint, each rank's file its owned
# pieces only, their bytes the reckoning, all of them one process's
# parameters and Adam state; a second step; then the four ranks at fsdp 4
# restore it (every piece bitwise the saved state's; the restore's peak at
# most the state it holds plus ``INIT_SLACK_GB``) and take the same second
# step (losses within ``TOL_SHARD``); this process restores it in one
# process, bitwise. 20c: the T5 kernels at 20b's per-rank shapes (64 of
# 128 heads of d_kv 128 at head offset 64, 8 rows).
INIT_MESH, INIT_RESTORE_MESH = (1, 2, 2), (1, 4, 1)
INIT_LAYERS = 1
INIT_T5 = f"t5-11b-{INIT_LAYERS}x{INIT_LAYERS}-dropout-0"
INIT_BATCH = 16
INIT_SLACK_GB = 0.6
INIT_LAUNCHES = step_launches(T5_LAYERS, INIT_LAYERS, INIT_LAYERS,
                              dropout=False)
INIT_HEADS, INIT_D, INIT_OFFSET = 64, 128, 64
INIT_SAMPLES = (
    "transformer.encoder.block.0.layer.1.DenseReluDense.wi.weight",
    "transformer.decoder.block.0.layer.2.DenseReluDense.wo.weight",
    "transformer.encoder.block.0.layer.0.SelfAttention.q.weight",
    "transformer.encoder.block.0.layer.0.SelfAttention."
    "relative_attention_bias.weight",
    "transformer.shared.weight",
    "transformer.decoder.final_layer_norm.weight",
    "image_model.encoder.layers.2.blocks.0.attention.self.query.weight",
    "vision_projection.weight")


def init_config(layers: int | None = None, **kw):
    """20a's (t5-11b whole, ``layers`` None) or 20b's (``INIT_T5``)
    config: the Config defaults (the default towers), both kernel flags."""
    from klab_multimodalmodel_tpu_torch.config import Config

    return Config(use_pallas_attention=True, use_pallas_t5_attention=True,
                  seed=SEED, transformer_model_name=(
                      "t5-11b" if layers is None else INIT_T5), **kw)


def fingerprint(t) -> int:
    """An exact fingerprint of a tensor's bytes b_i: the sum of (b_i + 1)
    w_i mod 2^64 with odd weights w_i of the byte's place, on the tensor's
    device in chunks (integer sums: the same on any device, in any order).
    Any one differing byte changes it."""
    import torch

    x = t.detach().contiguous().reshape(-1).view(torch.uint8)
    total, chunk = 0, 1 << 24
    for lo in range(0, x.numel(), chunk):
        b = x[lo:lo + chunk].to(torch.int64) + 1
        w = torch.arange(lo, lo + b.numel(), device=x.device,
                         dtype=torch.int64)
        w = (w * 6364136223846793005 + 1442695040888963407) | 1
        total = (total + int((b * w).sum())) % 2 ** 64
    return total


def own_fingerprints(trainer) -> dict:
    """{entry: ``fingerprint``} of every piece this rank holds: the model's
    ("model/{name}") and the optimizer's ("optimizer/{name}/{key}")."""
    import torch
    from torch.distributed.tensor import DTensor

    out = {f"model/{n}": fingerprint(t)
           for n, t in trainer._local_tensors().items() if t.numel()}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for p, st in trainer.optimizer.state.items():
        for key, v in st.items():
            if isinstance(v, torch.Tensor):
                v = v.to_local() if isinstance(v, DTensor) else v
                if v.numel():
                    out[f"optimizer/{names[id(p)]}/{key}"] = fingerprint(v)
    return out


def layout_fingerprints(one, shape: tuple) -> list[dict]:
    """What ``own_fingerprints`` gives on each rank of a layout of
    ``shape`` (dense, Adam) holding the state of ``one``, a one-process
    ``Trainer``: its whole tensors cut into each rank's pieces."""
    import torch

    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        piece_view, rank_piece)
    from klab_multimodalmodel_tpu_torch.train.optim import state_piece
    from klab_multimodalmodel_tpu_torch.utils.mesh import (
        DEFAULT_AXIS_NAMES, Mesh)

    shape = tuple(shape) + (1,) * (6 - len(shape))
    state = one.model.state_dict()
    names = {id(p): n for n, p in one.model.named_parameters()}
    out = []
    for r in range(math.prod(shape)):
        mesh = Mesh(shape=shape, axis_names=DEFAULT_AXIS_NAMES, group=None,
                    cpu_group=None, rank=r)
        fps = {}

        def add(entry, whole, piece):
            if piece is not None and all(n for _, n in piece):
                fps[entry] = fingerprint(piece_view(whole, piece))
        for n, v in state.items():
            add(f"model/{n}", v, rank_piece(n, tuple(v.shape), mesh,
                                            one._layers, False))
        for p, st in one.optimizer.state.items():
            n = names[id(p)]
            piece = rank_piece(n, tuple(p.shape), mesh, one._layers, False)
            for key, v in st.items():
                if isinstance(v, torch.Tensor):
                    add(f"optimizer/{n}/{key}", v, state_piece(
                        key, tuple(p.shape), piece, v.dim()))
        out.append(fps)
    return out


def plan_fingerprints(cfg, names) -> dict:
    """One process's init of ``cfg``'s whole model as its plan draws it,
    one parameter at a time into a temporary on the card (the model never
    held): {name: ``fingerprint``} of ``names``."""
    import torch

    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)

    model = MultiModalModel(cfg, device="meta")
    shapes = {n: tuple(v.shape) for n, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    out = {}
    for name, init in model.init_plan():
        whole = torch.empty(shapes[name], device="cuda")
        init(whole, gen)
        if name in names:
            out[name] = fingerprint(whole)
        del whole
    return out


def init_memory(card: str) -> dict:
    """20a's and 20b's per-rank parameters, gradients and Adam moments
    (GB), and one process's of 20b, reckoned on the meta device."""
    from klab_multimodalmodel_tpu_torch.models.multimodal import (
        MultiModalModel)
    from klab_multimodalmodel_tpu_torch.parallel.partitioning import (
        per_rank_bytes)
    from klab_multimodalmodel_tpu_torch.train.optim import trainable_names

    out = {}
    for tag, layers, axes in (("20a", None, {"fsdp": 2, "tensor": 2}),
                              ("20b", INIT_LAYERS, {"fsdp": 2,
                                                    "tensor": 2}),
                              ("20b-fsdp4", INIT_LAYERS, {"fsdp": 4}),
                              ("20b-one", INIT_LAYERS, {})):
        cfg = init_config(layers)
        model = MultiModalModel(cfg, device="meta")
        names = trainable_names(model, cfg)
        shapes = [(n, tuple(p.shape), n in names)
                  for n, p in model.named_parameters()]
        out[tag] = {k: v / 1e9 for k, v in per_rank_bytes(
            shapes, axes).items()}
        out[tag]["trainable_tensors"] = len(names)
    print("phase 20: state per rank reckoned (GB; params, grads, Adam): "
          + "; ".join(f"{t} {r['params']:.3f} + {r['grads']:.3f} + "
                      f"{r['moments']:.3f} = {r['total']:.3f}"
                      for t, r in out.items()) + f" [{card}]")
    return out


def init_rank_run(run: dict, card: str, device) -> dict:
    """20a or 20b on this rank of the four-rank job (``four_rank_main``):
    its readings (see the phase's comment)."""
    import torch
    import torch.distributed as dist

    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        SHARDS, CheckpointManager)
    from klab_multimodalmodel_tpu_torch.config import Config
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    rank = dist.get_rank()
    cfg = Config.from_json(json.dumps(run["config"]))
    free()
    if rank == 0:
        free_b, total_b = torch.cuda.mem_get_info()
        print(f"{run['tag']}: the card has {free_b / 1e9:.2f} of "
              f"{total_b / 1e9:.2f} GB free before the init [{card}]",
              flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device)
    on_meta = all(p.is_meta for p in trainer.model.parameters())
    trainer.init_state()
    torch.cuda.synchronize()
    r = dict(on_meta=on_meta, init_s=time.perf_counter() - t0,
             init_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
             held_gb=held_bytes(trainer))
    if run["tag"] == "20a":
        t0 = time.perf_counter()
        fps = {}
        for name in INIT_SAMPLES:  # one at a time: each whole on rank 0
            whole = trainer.full_state_dict(names={name})
            if rank == 0:
                fps[name] = fingerprint(whole[name].to(device))
            del whole
        r.update(fingerprints=fps, gather_s=time.perf_counter() - t0)
        del trainer
        free()
        return r
    r["init_fingerprints"] = own_fingerprints(trainer)
    batch = train_batch(cfg, INIT_BATCH, SEED)

    def rows(t):
        n = INIT_BATCH // t.mesh.dp_size
        return {k: v[t.mesh.dp_rank * n:(t.mesh.dp_rank + 1) * n]
                for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    reset_counts()
    losses = [float(trainer.train_step(rows(trainer), gen))]
    r["launches_per_step"] = launch_counts()
    check(r["launches_per_step"] == INIT_LAUNCHES,
          f"20b rank {rank}: launches {r['launches_per_step']}, expected "
          f"{INIT_LAUNCHES}")
    manager = CheckpointManager(run["checkpoint"], trainer.mesh)
    t0 = time.perf_counter()
    manager.save("step_1", trainer)
    manager.wait()
    r["save_s"] = time.perf_counter() - t0
    r["save"] = manager.saves[-1] if manager.saves else None
    path = os.path.join(manager.path("step_1"), SHARDS, f"{rank}.pt")
    r["file_bytes"] = os.path.getsize(path) if os.path.exists(path) else 0
    r["saved_fingerprints"] = own_fingerprints(trainer)
    r["held_saved_gb"] = held_bytes(trainer)
    step_gen = gen.get_state()
    losses.append(float(trainer.train_step(rows(trainer), gen)))
    r["losses"] = losses
    del trainer
    free()
    base = torch.cuda.memory_allocated()
    trainer = Trainer(dataclasses.replace(cfg, mesh_shape=INIT_RESTORE_MESH),
                      device=device)
    trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    manager.restore("step_1", trainer)
    torch.cuda.synchronize()
    r["restore_s"] = time.perf_counter() - t0
    r["restore_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    r["held_restored_gb"] = held_bytes(trainer)
    r["files_read"] = manager.files_read
    r["restored_fingerprints"] = own_fingerprints(trainer)
    gen.set_state(step_gen)
    r["restored_loss"] = float(trainer.train_step(rows(trainer), gen))
    del trainer
    free()
    return r


def init_kernel_shapes() -> list[tuple["T5Shape", int]]:
    """20b's per-rank shapes (8 rows, 64 of 128 heads of d_kv 128, rate
    0.1), tensor rank 1's heads."""
    pad = SRC_LEN - 30
    B = INIT_BATCH // 2
    return [(sh, INIT_OFFSET) for sh in (
        T5Shape("encoder", "training", B, ENC_LEN, ENC_LEN, True, pad, RATE,
                INIT_LAYERS),
        T5Shape("decoder", "training", B, TGT_LEN, TGT_LEN, True, -1, RATE,
                INIT_LAYERS, causal=True),
        T5Shape("cross", "training", B, TGT_LEN, ENC_LEN, False, pad, RATE,
                INIT_LAYERS))]


def init_reference(card: str) -> dict:
    """What phase 20 holds the job's ranks against, made before the job
    on the empty card: 20a's samples as one process's plan draws them,
    and one process's ``init_state()`` of 20b (the fingerprints of each
    20b rank's pieces of it, and of 20a's samples it shares)."""
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    samples = plan_fingerprints(init_config(), INIT_SAMPLES)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = Trainer(init_config(INIT_LAYERS, mesh_shape=(1, 1, 1)))
    one.init_state()
    state = one.model.state_dict()
    # Drawn before the transformer's block 1: the same draws at 1 + 1
    # blocks as at 24 + 24.
    plan = list(one.model.init_plan())
    last = max(i for i, (n, _) in enumerate(plan)
               if n.startswith("transformer.encoder.block.0."))
    shared = {n: fingerprint(state[n]) for i, (n, init) in enumerate(plan)
              if n in INIT_SAMPLES and (i <= last or not init.draws)}
    ranks = layout_fingerprints(one, INIT_MESH)
    seconds = time.perf_counter() - t0
    del one, state
    free()
    print(f"phase 20: one process's plan of t5-11b at 24 + 24 blocks "
          f"drawn in {plan_s:.2f} s, 20b's one-process init and its "
          f"pieces' fingerprints in {seconds:.2f} s [{card}]", flush=True)
    return dict(plan=samples, shared=shared, init_ranks=ranks,
                plan_s=plan_s, one_s=seconds)


def init_phase(card: str, job: dict) -> dict:
    """Phase 20's checks of the four-rank job's 20a and 20b runs; 20b's
    checkpoint restored here in one process; then 20c."""
    import torch

    from klab_multimodalmodel_tpu_torch.checkpoint.io import (
        CheckpointManager)
    from klab_multimodalmodel_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    memory, ranks, ref = job["memory"]["20"], job["ranks"], job["init_ref"]
    a = [rk["20a"] for rk in ranks]
    for r, g in enumerate(a):
        held, want = g["held_gb"]["params"], memory["20a"]["params"]
        check(g["on_meta"], f"20a rank {r}: parameters not on meta")
        check(abs(held - want) <= 1e-3 * want,
              f"20a rank {r}: holds {held:.6f} GB of parameters, reckoned "
              f"{want:.6f}")
        check(g["init_peak_gb"] <= held + INIT_SLACK_GB,
              f"20a rank {r}: peak {g['init_peak_gb']:.3f} GB over the "
              f"init, holds {held:.3f}")
    peaks = ", ".join(f"{g['init_peak_gb']:.3f}" for g in a)
    fps = a[0]["fingerprints"]
    for name in INIT_SAMPLES:
        check(fps[name] == ref["plan"][name],
              f"20a: {name} differs from one process's plan")
        if name in ref["shared"]:
            check(fps[name] == ref["shared"][name],
                  f"20a: {name} differs from 20b's one-process init")
    print(f"20a [{card}]: t5-11b 24 + 24 blocks initialized on the four "
          f"ranks in {max(g['init_s'] for g in a):.1f} s (slowest rank), "
          f"each holding {a[0]['held_gb']['params']:.3f} GB of parameters "
          f"(reckoned {memory['20a']['params']:.3f}), peaks {peaks} "
          f"GB; {len(INIT_SAMPLES)} samples bitwise one process's plan "
          f"({len(ref['shared'])} also its 1 + 1 init), gathered in "
          f"{a[0]['gather_s']:.1f} s", flush=True)
    b = [rk["20b"] for rk in ranks]
    for r, g in enumerate(b):
        check(g["init_fingerprints"] == ref["init_ranks"][r],
              f"20b rank {r}: the init's pieces differ from one process's")
        check(g["launches_per_step"] == INIT_LAUNCHES,
              f"20b rank {r}: launches {g['launches_per_step']}")
        rel = abs(g["restored_loss"] - g["losses"][1]) / abs(g["losses"][1])
        check(rel <= TOL_SHARD["loss"],
              f"20b rank {r}: the second step's loss at fsdp 4 "
              f"{g['restored_loss']} vs {g['losses'][1]} (rel {rel:.2e})")
        held = g["held_restored_gb"]
        check(g["restore_peak_gb"] <= held["params"] + held["moments"]
              + INIT_SLACK_GB, f"20b rank {r}: the restore's peak "
              f"{g['restore_peak_gb']:.3f} GB, holds {held}")
    t0 = time.perf_counter()
    one = Trainer(init_config(INIT_LAYERS, mesh_shape=(1, 1, 1)))
    one.init_state()
    manager = CheckpointManager(os.path.join(job["root"], "20b.ckpt"))
    manager.restore("step_1", one)
    restore_s = time.perf_counter() - t0
    saved = layout_fingerprints(one, INIT_MESH)
    restored = layout_fingerprints(one, INIT_RESTORE_MESH)
    for r, g in enumerate(b):
        check(g["saved_fingerprints"] == saved[r],
              f"20b rank {r}: the one-process restore differs from the "
              "saved pieces")
        check(g["restored_fingerprints"] == restored[r],
              f"20b rank {r}: the fsdp-4 restore differs from the saved "
              "state")
    state_bytes = sum(v.numel() * v.element_size()
                      for v in one.model.state_dict().values())
    state_bytes += sum(v.numel() * v.element_size()
                       for st in one.optimizer.state.values()
                       for v in st.values() if isinstance(v, torch.Tensor))
    del one
    free()
    written = sum(g["save"]["bytes"] for g in b if g["save"])
    peaks = ", ".join(f"{g['restore_peak_gb']:.3f}" for g in b)
    one_gb = memory["20b-one"]
    reckoned = (one_gb["params"] + one_gb["moments"]) * 1e9 + 4 * one_gb[
        "trainable_tensors"]
    check(written == state_bytes and abs(written - reckoned) <= 1,
          f"20b: the files hold {written} B of tensors, one process's "
          f"state {state_bytes} B, reckoned {reckoned:.0f} B")
    for r, g in enumerate(b):
        owned = g["save"]["bytes"] if g["save"] else 0
        check(owned <= g["file_bytes"] <= owned * 1.01 + 65536,
              f"20b rank {r}: file of {g['file_bytes']} B for {owned} B of "
              "pieces")
    print(f"20b [{card}]: init pieces bitwise one process's on every rank; "
          f"losses {b[0]['losses']} at fsdp 2 x tensor 2, the second step "
          f"after the restore at fsdp 4 {b[0]['restored_loss']}; files "
          f"{', '.join(str(g['file_bytes']) for g in b)} B ({written / 1e9:.3f}"
          f" GB of pieces, one process's state {state_bytes / 1e9:.3f} GB); "
          f"save {max(g['save_s'] for g in b):.2f} s, restore at fsdp 4 "
          f"{max(g['restore_s'] for g in b):.2f} s (peaks {peaks} "
          f"GB), in one process {restore_s:.2f} s, bitwise; files read at "
          f"fsdp 4: {[g['files_read'] for g in b]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    kernels = check_t5_offsets(gen, card, "20b rank", init_kernel_shapes(),
                               INIT_HEADS, INIT_D, "head_offset", RATE)
    seconds = time.perf_counter() - t_phase
    print(f"phase 20: {seconds:.1f} s here (its runs in the four-rank job "
          f"{job['seconds']['20']:.2f} s, the reference before it "
          f"{ref['plan_s'] + ref['one_s']:.2f} s)")
    return dict(card=card, memory_reckoned_gb=memory, ranks=dict(
        a=a, b=[{k: v for k, v in g.items() if "fingerprints" not in k}
                for g in b]), restore_s=restore_s, kernels=kernels,
        seconds=seconds)



def four_rank_main(spec_path: str) -> int:
    """One rank of the four-rank job of phases 16 to 20 (on a
    ``RankServer`` rank): their runs in turn on ``cuda:0``, which the
    four ranks share (gloo on CUDA tensors: ``KLAB_CPU_COLLECTIVES=gloo``),
    each run's readings (and its seconds on this rank) to
    ``{out}.{rank}.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch.utils.mesh import (
        maybe_init_distributed)

    with open(spec_path) as f:
        spec = json.load(f)
    register_no_dropout()
    device = torch.device(DDP_DEVICE)
    maybe_init_distributed(device)
    runners = {"16": moe_shard_rank_run, "17": pipe_shard_rank_run,
               "18": seq_shard_rank_run, "19": moe_seq_rank_run,
               "20": init_rank_run}
    readings = {}
    for run in spec["runs"]:
        t0 = time.perf_counter()
        r = runners[run["phase"]](run, spec["card"], device)
        dist.barrier()
        readings[run["tag"]] = dict(r, run_s=time.perf_counter() - t0)
    wait_saves()
    with open(f"{spec['out']}.{dist.get_rank()}.json", "w") as f:
        json.dump(readings, f, default=str)
    return 0


def four_rank_job(card: str, server: "RankServer") -> dict:
    """Hand the runs of phases 16 to 20 to the four ranks of ``server`` on
    the one card (their log in ``chiprun_out/phase16_19_ranks.log``), each
    run's per-rank state reckoned and phase 20's reference made first, and
    return while they run: what ``join_20a`` and ``four_rank_results``
    wait on, and the directory of the runs' files (``root``; the caller
    removes it). Two jobs: 20a alone first, which needs ~50 GB of the card
    (the caller runs nothing large until ``join_20a``), then the rest."""
    import tempfile

    register_no_dropout()
    memory = {"16": moe_shard_memory(card), "17": pipe_shard_memory(card),
              "18": seq_shard_memory(card),
              "19": moe_shard_memory(card, MOE_SEQ_RUNS, "19"),
              "20": init_memory(card)}
    # Phase 20's reference, on the card while it is empty.
    init_ref = init_reference(card)
    root = tempfile.mkdtemp(prefix="chip_smoke_four_ranks_")

    def run(phase, tag, twin, mesh, **kw):
        return dict(kw, phase=phase, tag=tag, config=json.loads(
            split_config(twin, mesh_shape=mesh).to_json()),
            files=os.path.join(root, tag),
            checkpoint=os.path.join(root, f"{tag}.ckpt"))
    runs = [run("16", tag, "15a-moe", mesh, launches=SPLIT_RUNS["15b"][3])
            for tag, mesh in MOE_SHARD_RUNS.items()]
    runs += [run("17", tag, "15a-pipe", mesh, extras=tag != "17a",
                 launches=SPLIT_RUNS["15c"][3])
             for tag, mesh in PIPE_SHARD_RUNS.items()]
    for tag in SEQ_SHARD_RUNS:
        ring = tag == "18c"
        runs.append(dict(
            phase="18", tag=tag, ring=ring, config=json.loads(
                seq_shard_config(tag).to_json()),
            files=os.path.join(root, tag),
            checkpoint=os.path.join(root, f"{tag}.ckpt") if tag == "18a"
            else None,
            launches=SEQ_LAUNCHES_PLAIN if ring else SEQ_LAUNCHES,
            launches_dropout=(SEQ_LAUNCHES_PLAIN if ring
                              else SEQ_LAUNCHES_DROPOUT)))
    launches, launches_dropout = SPLIT_RUNS["15b"][3]
    for tag, mesh in MOE_SEQ_RUNS.items():
        runs.append(run("19", tag, "15a-moe", mesh, launches=launches,
                        launches_dropout=launches_dropout))
        if tag != "19a":  # 19a's checkpoint is the one restored
            runs[-1]["checkpoint"] = None
    # 20a first, on the nearly empty card, in a job of its own; 20b last.
    first = [dict(phase="20", tag="20a", config=json.loads(
        init_config(mesh_shape=INIT_MESH).to_json()))]
    runs.append(dict(phase="20", tag="20b", config=json.loads(init_config(
        INIT_LAYERS, mesh_shape=INIT_MESH).to_json()),
        checkpoint=os.path.join(root, "20b.ckpt")))
    specs, handles = [], []
    for name, part in (("20a", first), ("rest", runs)):
        spec = dict(card=card, out=os.path.join(root, f"rank.{name}"),
                    runs=part)
        spec_path = os.path.join(root, f"spec.{name}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        specs.append(spec)
        handles.append(server.submit("four", spec_path))
    return dict(root=root, specs=specs, handles=handles, memory=memory,
                init_ref=init_ref)


def join_20a(server: "RankServer", job: dict) -> None:
    """Wait for ``four_rank_job``'s first job, 20a, to end."""
    server.join(job["handles"][0], "20a")


def four_rank_results(card: str, server: "RankServer", job: dict) -> dict:
    """Wait for ``four_rank_job``'s jobs on ``server`` to end: ``job`` with
    the rank readings, each phase's seconds in the jobs (its runs' on the
    slowest rank) and the seconds from the hand-over to the last run's
    end."""
    job_s = max(server.join(h, "the runs of phases 16 to 20")
                for h in job["handles"])
    ranks = [{} for _ in range(FOUR_RANKS)]
    for spec in job["specs"]:
        for r in range(FOUR_RANKS):
            with open(f"{spec['out']}.{r}.json") as f:
                ranks[r].update(json.load(f))
    runs = [x for spec in job["specs"] for x in spec["runs"]]
    seconds = {p: max(sum(rk[x["tag"]]["run_s"] for x in runs
                          if x["phase"] == p) for rk in ranks)
               for p in ("16", "17", "18", "19", "20")}
    print(f"phases 16 to 20: the four-rank jobs took {job_s:.1f} s (16's "
          f"runs {seconds['16']:.1f} s, 17's {seconds['17']:.1f} s, 18's "
          f"{seconds['18']:.1f} s, 19's {seconds['19']:.1f} s, 20's "
          f"{seconds['20']:.1f} s, the rest the last checkpoint writes; "
          f"beside phases 7, 10, 5 and 9 of this process) [{card}]")
    return dict(job, ranks=ranks, seconds=seconds, job_s=job_s)


class StopAfter(Exception):
    """Raised after the phase that ``--stop-after`` names."""


def main(stop_after: str | None = None) -> int:
    """Every phase in turn; with ``stop_after``, only the phases up to
    that one (a shorter run for working on the script: it prints the
    phases' seconds and no result, and exits 3)."""
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from klab_multimodalmodel_tpu_torch.ops import cuda_build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    cuda_build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s")
    build = build_report()
    from klab_multimodalmodel_tpu_torch import native
    t0 = time.perf_counter()
    native.load_library()
    print(f"host runtime build ({native.compiler()} "
          f"{' '.join(native.CXXFLAGS)}): {time.perf_counter() - t0:.2f} s")

    # Seconds of each phase since the script started (the build's first).
    started = time.perf_counter() - build_s
    seconds = {}

    def done(phase: str) -> None:
        seconds[phase] = time.perf_counter() - started - sum(
            seconds.values())
        if phase == stop_after:
            print("seconds by phase: " + ", ".join(
                f"{k} {v:.1f}" for k, v in seconds.items())
                + f"; stopped after phase {phase} [{card}]")
            raise StopAfter

    done("1")
    jpeg = jpeg_phase(card)
    done("1b")
    # The rank jobs of phases 13 to 20 run beside phases of this process
    # that need nothing of theirs: the two ranks start as phase 1 ends
    # (their start beside phase 2, whose times are device times), phases
    # 6, 8 and 12 run while the jobs of 13, 14 and 15 go on (``finish``),
    # and 7, 10, 5 and 9 while the four ranks' jobs of 16 to 20 go on;
    # those ranks start as phase 15 begins, their job of 20a (~50 GB of
    # the card) runs beside phase 7 alone, and their runs' checkpoints
    # (~33 GB of disk) meet no phase that writes more than phase 10's.
    # Phases 16 to 20 then hold the four-rank runs against this process's
    # references (phases 14 and 15), and phase 11, whose MoE step needs
    # most of the card, comes last.
    servers = [RankServer(2, "phase13_15_ranks.log")]
    job: dict = {}
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        kernels = [check_t5_fwd(gen, card), check_t5_bwd(gen, card),
                   check_swin(gen, card)]
        for entry in kernels:
            entry["source"], entry["replaces"] = KERNELS[entry["name"]]
            entry["route"] = "cuda"
            path_totals(entry)
            print_path_totals(entry, card)
        done("2")

        # Each main path runs with the counts set to 0 just before it and
        # read just after (inside caption() and train(): the three timed
        # requests, the five timed steps).
        reset_counts()
        captioning = caption(card)
        done("3")
        reset_counts()
        training = train(card)
        free()
        done("4")
        phase = shard_phase(card, servers[0])
        next(phase)
        done("13 (to its rank job)")
        looping = loop_phase(card)
        free()
        done("6")
        sharded = finish(phase)
        done("13")
        seq_ref: dict = {}
        phase = seq_phase(card, servers[0], seq_ref)
        next(phase)
        done("14 (to its rank job)")
        artifacts = artifacts_phase(card)
        free()
        done("8")
        seq = finish(phase)
        done("14")
        moe_ref: dict = {}
        servers.append(RankServer(FOUR_RANKS, "phase16_19_ranks.log"))
        phase = split_phase(card, servers[0], moe_ref)
        next(phase)
        done("15 (to its rank job)")
        gpipe = gpipe_phase(card)
        free()
        done("12")
        split = finish(phase)
        servers[0].stop()
        servers[0].wait()
        done("15")
        job = four_rank_job(card, servers[1])
        evaluating = evaluation_phase(card, captioning["greedy_ids"])
        free()
        done("7")
        join_20a(servers[1], job)
        distributed = ddp_phase(card, looping["determinism"])
        free()
        done("10")
        reset_counts()
        swin_training, state = train_swin(card)
        swin_training["swin_kernel_vs_none"] = swin_kernel_vs_none(state)
        del state
        free()
        options = train_options(card, training)
        free()
        done("5")
        serving = serving_phase(card)
        free()
        done("9")
        job = four_rank_results(card, servers[1], job)
        servers[1].stop()
        servers[1].wait()
        # The wait for the four ranks' last run.
        done("16-20 runs")
        moe_shard = moe_shard_phase(card, moe_ref, job)
        free()
        done("16")
        pipe_shard = pipe_shard_phase(card, moe_ref, job)
        free()
        done("17")
        seq_shard = seq_shard_phase(card, seq_ref, job)
        del seq_ref
        free()
        done("18")
        moe_seq = moe_seq_phase(card, moe_ref, job)
        del moe_ref
        free()
        done("19")
        init = init_phase(card, job)
    finally:
        for server in servers:
            server.close()
        if job:
            shutil.rmtree(job["root"], ignore_errors=True)
    free()
    done("20")
    moe = moe_phase(card, training, captioning)
    free()
    done("11")
    print("seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; total {time.perf_counter() - started:.1f} [{card}]")
    keys = {"t5_attention_fwd": ("t5_fwd", "t5"),
            "t5_attention_bwd": ("t5_bwd", None),
            "swin_attention_fwd": ("swin", "swin")}
    for entry in kernels:
        train_key, caption_key = keys[entry["name"]]
        entry["launches"] = training["launches"][train_key]
        entry["launches_captioning"] = (
            captioning["launches"][caption_key] if caption_key else 0)
        check(entry["launches"] > 0, f"{entry['name']} never launched")
        entry["launches_train_with_swin_step"] = (
            swin_training["launches_per_step"][train_key])
        check(entry["launches_train_with_swin_step"] > 0,
              f"{entry['name']} never launched in train_with_swin")
        c_run = looping["runs"]["C"]
        entry["launches_loop_run"] = c_run["launches"][train_key]
        check(entry["launches_loop_run"] > 0,
              f"{entry['name']} never launched by train()")
        for kind in ("full step", "cached step"):
            entry[f"launches_loop_{kind.replace(' ', '_')}"] = (
                c_run["step_kinds"][kind]["launches"][train_key])
        entry["launches_beam_request"] = (
            evaluating["beams"]["launches"][train_key] // REQUESTS)
        entry["launches_artifacts_request"] = (
            artifacts["caption"]["launches"][train_key] // REQUESTS)
        entry["launches_artifacts_step"] = (
            artifacts["train"]["step_kinds"]["full step"]["launches"][
                train_key])
        check(entry["launches_artifacts_step"] > 0,
              f"{entry['name']} never launched by phase 8's train()")
        for r, rank in enumerate(distributed["ranks"]):
            for kind, step in rank["10a"]["step_kinds"].items():
                if kind.endswith("step"):
                    check(step["launches"][train_key] > 0,
                          f"{entry['name']} never launched in a {kind} of "
                          f"phase 10a's rank {r}")
        entry["launches_ddp_rank_step"] = (
            distributed["ranks"][0]["10a"]["step_kinds"]["full step"][
                "launches"][train_key])
        dyn = serving["dynamic"]
        entry["launches_serving_prefill"] = (
            dyn["launches"][train_key] // dyn["batches"])
        if caption_key:
            check(entry["launches_serving_prefill"] > 0,
                  f"{entry['name']} never launched by phase 9's serving")
        entry["launches_moe_step"] = moe["train"]["launches_per_step"][
            train_key]
        check(entry["launches_moe_step"] > 0,
              f"{entry['name']} never launched in a phase-11a MoE step")
        entry["launches_moe_request"] = (
            moe["serve"]["launches"][caption_key] // REQUESTS
            if caption_key else 0)
        entry["launches_gpipe_step"] = gpipe["runs"][4][
            "launches_per_step"][train_key]
        if train_key == "swin":
            check(entry["launches_gpipe_step"] > 0,
                  "the Swin kernel never launched in a phase-12 step")
        for tag, got in sharded["ranks"].items():
            for r, rank in enumerate(got):
                check(rank["launches_per_step"][train_key] > 0,
                      f"{entry['name']} never launched in a phase-{tag} "
                      f"step of rank {r}")
        entry["launches_shard_step"] = sharded["ranks"]["13c"][0][
            "launches_per_step"][train_key]
        for tag, got in seq["ranks"].items():
            for r, rank in enumerate(got):
                if tag == "14b" or train_key == "swin":
                    check(rank["launches_per_step"][train_key] > 0,
                          f"{entry['name']} never launched in a phase-{tag} "
                          f"step of rank {r}")
        entry["launches_seq_step"] = seq["ranks"]["14b"][0][
            "launches_per_step"][train_key]
        for tag, got in split["ranks"].items():
            for r, rank in enumerate(got):
                if tag == "15b" or train_key == "swin":
                    check(rank["launches_per_step"][train_key] > 0,
                          f"{entry['name']} never launched in a phase-{tag} "
                          f"step of rank {r}")
        entry["launches_expert_step"] = split["ranks"]["15b"][0][
            "launches_per_step"][train_key]
        entry["launches_pipe_step"] = split["ranks"]["15c"][0][
            "launches_per_step"][train_key]
        for tag, got in moe_shard["ranks"].items():
            for r, rank in enumerate(got):
                check(rank["launches_per_step"][train_key] > 0,
                      f"{entry['name']} never launched in a phase-{tag} "
                      f"step of rank {r}")
        entry["launches_moe_fsdp_step"] = moe_shard["ranks"]["16b"][0][
            "launches_per_step"][train_key]
        entry["launches_moe_tensor_step"] = moe_shard["ranks"]["16c"][0][
            "launches_per_step"][train_key]
        for tag, got in pipe_shard["ranks"].items():
            for r, rank in enumerate(got):
                if train_key == "swin":
                    check(rank["launches_per_step"][train_key] > 0,
                          f"{entry['name']} never launched in a phase-{tag} "
                          f"step of rank {r}")
        entry["launches_pipe_fsdp_step"] = pipe_shard["ranks"]["17b"][0][
            "launches_per_step"][train_key]
        entry["launches_pipe_tensor_step"] = pipe_shard["ranks"]["17c"][0][
            "launches_per_step"][train_key]
        for tag, got in seq_shard["ranks"].items():
            for r, rank in enumerate(got):
                if tag != "18c" or train_key == "swin":
                    check(rank["launches_per_step"][train_key] > 0,
                          f"{entry['name']} never launched in a phase-{tag} "
                          f"step of rank {r}")
        entry["launches_seq_fsdp_step"] = seq_shard["ranks"]["18a"][0][
            "launches_per_step"][train_key]
        entry["launches_seq_tensor_step"] = seq_shard["ranks"]["18b"][0][
            "launches_per_step"][train_key]
        for tag, got in moe_seq["ranks"].items():
            for r, rank in enumerate(got):
                check(rank["launches_per_step"][train_key] > 0,
                      f"{entry['name']} never launched in a phase-{tag} "
                      f"step of rank {r}")
        entry["launches_moe_seq_expert_step"] = moe_seq["ranks"]["19a"][0][
            "launches_per_step"][train_key]
        entry["launches_moe_seq_tensor_step"] = moe_seq["ranks"]["19b"][0][
            "launches_per_step"][train_key]
        for r, rank in enumerate(init["ranks"]["b"]):
            check(rank["launches_per_step"][train_key] > 0,
                  f"{entry['name']} never launched in a phase-20b step of "
                  f"rank {r}")
        entry["launches_init_ckpt_step"] = init["ranks"]["b"][0][
            "launches_per_step"][train_key]
        # The line reports one training step's launches of each kernel.
        entry.update({k: entry["paths"]["training"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    summary = [{k: e.get(k) for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "launches_captioning", "launches_train_with_swin_step",
        "launches_loop_run", "launches_loop_full_step",
        "launches_loop_cached_step", "launches_beam_request",
        "launches_artifacts_request", "launches_artifacts_step",
        "launches_serving_prefill", "launches_ddp_rank_step",
        "launches_moe_step", "launches_moe_request", "launches_gpipe_step",
        "launches_shard_step", "launches_seq_step", "launches_expert_step",
        "launches_pipe_step", "launches_moe_fsdp_step",
        "launches_moe_tensor_step", "launches_pipe_fsdp_step",
        "launches_pipe_tensor_step", "launches_seq_fsdp_step",
        "launches_seq_tensor_step", "launches_moe_seq_expert_step",
        "launches_moe_seq_tensor_step", "launches_init_ckpt_step")}
        for e in kernels]
    print(json.dumps({
        "kernels": summary, "card": card,
        "times": f"per training step (all of the kernel's launches in one "
                 f"batch-{TRAIN_BATCH} step, bf16 inputs, warm L2); "
                 f"launches: the {STEPS} timed steps; launches_captioning: "
                 f"the {REQUESTS} timed requests; "
                 f"launches_train_with_swin_step: one step of phase 5a; "
                 f"launches_loop_run: phase 6's run C of train(); "
                 f"launches_loop_full_step / _cached_step: one full and "
                 f"one cached step of that run; launches_beam_request: one "
                 f"num_beams-{BEAMS} request of phase 7a; "
                 f"launches_artifacts_request / _step: one request of phase "
                 f"8b and one full step of phase 8c (the converted HF "
                 f"artifacts); launches_serving_prefill: one batch of "
                 f"phase 9a's HTTP load; launches_ddp_rank_step: one full "
                 f"step of one of phase 10a's two DDP ranks (batch "
                 f"{DDP_BATCH}, dropout 0); launches_moe_step / "
                 f"_moe_request: one step of phase 11a (4 experts, top-2) "
                 f"and one request of phase 11c; launches_gpipe_step: one "
                 f"step of phase 12 (4 GPipe stages, the T5 kernel off as "
                 f"the JAX package requires); launches_shard_step: one step "
                 f"of a phase-13c rank (t5-3b, {SHARD_LAYERS} + "
                 f"{SHARD_LAYERS} blocks, tensor 2); launches_seq_step: one "
                 f"step of a phase-14b rank (t5-large, {SEQ_LAYERS} + "
                 f"{SEQ_LAYERS} blocks, seq 2, the all-gather path); "
                 f"launches_expert_step / _pipe_step: one step of a "
                 f"phase-15b rank (4 experts over expert 2) and of a "
                 f"phase-15c rank (2 stages over pipe 2, the T5 kernel "
                 f"off); launches_moe_fsdp_step / _moe_tensor_step: one "
                 f"step of a phase-16b rank (4 experts over fsdp 2 x "
                 f"expert 2) and of a phase-16c rank (tensor 2 x expert "
                 f"2); launches_pipe_fsdp_step / _pipe_tensor_step: one "
                 f"step of a phase-17b rank (2 stages over fsdp 2 x pipe "
                 f"2) and of a phase-17c rank (tensor 2 x pipe 2), the T5 "
                 f"kernel off; launches_seq_fsdp_step / _seq_tensor_step: "
                 f"one step of a phase-18a rank (fsdp 2 x seq 2) and of a "
                 f"phase-18b rank (tensor 2 x seq 2), the all-gather "
                 f"path; launches_moe_seq_expert_step / "
                 f"_moe_seq_tensor_step: one step of a phase-19a rank (4 "
                 f"experts over seq 2 x expert 2) and of a phase-19b rank "
                 f"(tensor 2 x seq 2); launches_init_ckpt_step: one step "
                 f"of a phase-20b rank (t5-11b, {INIT_LAYERS} + "
                 f"{INIT_LAYERS} blocks, fsdp 2 x tensor 2)"}))

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "build": build,
                   "jpeg": jpeg, "kernels": kernels,
                   "captioning": captioning, "training": training,
                   "train_with_swin": swin_training, "options": options,
                   "loop": looping, "evaluation": evaluating,
                   "artifacts": artifacts, "serving": serving,
                   "ddp": distributed, "moe": moe, "gpipe": gpipe,
                   "sharded": sharded, "seq": seq, "split": split,
                   "moe_shard": moe_shard, "pipe_shard": pipe_shard,
                   "seq_shard": seq_shard, "moe_seq": moe_seq,
                   "init": init, "seconds": seconds},
                  f, indent=1,
                  default=str)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ddp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--rank-server"]:
        sys.exit(rank_server_main(sys.argv[2]))
    if sys.argv[1:2] == ["--stop-after"]:
        try:
            sys.exit(main(sys.argv[2]))
        except StopAfter:
            sys.exit(3)
    sys.exit(main())
