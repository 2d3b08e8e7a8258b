#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``audiocaption_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which must pass (none is caught and skipped):

  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from ``csrc/`` with nvcc (one
     process per source, all started together), printing ``-Xptxas -v``
     (registers, shared memory, spills) for every kernel, and the native
     CIDEr-D scorer (``native/cider.cc``) with g++;
  3. hold each decode kernel against its plain PyTorch version on the
     card, at the flagship decoder width (E=256, 4 heads, 2 layers,
     V=4981), L=20, S=31, B=64, on random jittered decoder weights and
     random well-spread memory K/V: greedy and beams 3, 5 and 8.  Limits:
     at most 1% of tokens differ; n-best scores of matching sequences
     within 1e-4 (beam 3), and for beams 5 and 8 within 1e-4 or, where the
     float32 plain version itself lies further than that from the same
     search in float64, no further from the float64 result than the
     float32 plain version is (``float64_floor_check``);
  4. drive the EffB2 serving path end to end through
     ``Effb2TrmCaptioningModel`` at flagship width (random weights from a
     seed, decoder jittered, BN statistics jittered so the encoder output
     does not collapse): 8 clips of 10 s with mixed lengths, greedy, beam 3
     and beam 5, and compare with the torch-engine path on the same card
     (at most 1% of tokens differ);
  5. serve 16 clips through ``MicroBatchServer``; the answers must equal a
     direct decode of the same batch;
  6. time each decode kernel warm and with the L2 cold (a 64 MB buffer
     written before each call), its device time (``torch.profiler``), its
     plain version, both cluster sizes and one sample (B=1), at B=64,
     S=31; print a step's phase trace and the cost of one cluster
     exchange and sync; compute each kernel's bound from its inputs; time
     beams 5 and 8, and end-to-end clips/s for greedy and beam 3 at B=64
     on 10 s clips and the latency of one clip;
  7. hold the log-mel kernel against its plain version at B=64 x 10 s, for
     the 32 kHz Cnn14 preset and the 16 kHz EffB2 preset (the kernel is
     config-general: any power-of-two n_fft from 256 to 2048).  Limit
     1e-3 dB: the JAX package holds its own kernel to 2e-4 dB of its conv
     path, and here the kernel's float64 FFT is held against the plain
     version's dense float32 DFT, on 10 s of audio instead of 1 s;
  8. drive the temporal path end to end through
     ``Cnn14RnnTempAttnGruModel`` at full width (vocab 4981; random weights
     from a seed, decoder jittered, BN statistics jittered): 8 clips of
     10 s at 32 kHz with mixed lengths (each >= 1 s), greedy and beam 3,
     with and without a user temporal tag, and compare with the same
     modules fed by the plain log-mel on the same card.  Limits: at most 1%
     of tokens differ; SED framewise probabilities within 1e-4;
  9. time the log-mel kernel (its wrapper's call, as the path runs it;
     its device time alone from a ``torch.profiler`` trace), its plain
     version, the same log-mel through cuFFT (``torch.stft``,
     its library yardstick, held to the plain version within 1e-3 dB
     first) and its bound at B=64 x 10 s (a real FFT's operations against
     the bytes in and out), the split of one
     temporal-model batch (frontend, SED network, host tag step, captioner
     encoder, decode), and end-to-end clips/s, greedy and beam 3 (one
     batch each, no warm-up: the host tag step takes 2.4-3.1 s of it);
 10. walk the flagship EffB2 encoder of phase 4 (BN jittered, so the
     folded expand biases are not zero) block by block on folded weights
     at B=64 x 10 s: the 19 stride-1 blocks through the MBConv kernel, the
     4 stride-2 blocks through ``mbconv_plain``.  Each kernel block is
     held against ``mbconv_plain`` on the same input (1e-4 * max(1,
     max |plain|)), the walk's ``attn_emb`` against the unfolded cuDNN
     encoder (1e-3 * max |ref|), and greedy and beam-3 captions of 8
     mixed-length clips from both encoder outputs (at most 1% of tokens
     differ).  The same block checks on the pruned encoder
     (``build_pruned_effb2``, ratio 0.3, 1408-wide head);
 11. time, per stride-1 block and summed over the 19 at B=64 x 10 s, the
     kernel (its wrapper's call; the device time of each of its three
     launches from a ``torch.profiler`` trace), ``mbconv_plain``, the
     port's cuDNN ``MBConvBlock`` (its library yardstick) and the bound
     (``mbconv_work``: the 1x1 products at the 3xTF32 tensor-core rate,
     the rest at the float32 rate, against the bytes; the float32-only
     bound printed beside it), and the walked encoder against the cuDNN
     encoder;
 12. hold the decode kernels' bf16 modes against their plain versions in
     the same mode at the width of phase 3: greedy and beams 3, 5, 8 with
     ``cache_bf16`` (at most 1% of tokens differ; scores within 1e-4 or
     ``float64_floor_check`` in the same mode), and beam 3 with
     ``weights_bf16``.  In that mode every product rounds its inputs to
     bf16, so a float32-level difference between two versions (the bf16
     mma's own float32 sums) flips a rounding now and then and two
     searches part ways (the float32 plain version and its own float64
     run differ in a few percent of tokens too); it is held by the
     kernel's n-best scores against the float64 plain version's scores
     of the kernel's own sequences (``sequence_scores_plain``, limit
     WEIGHTS_SCORE_ATOL, below the JAX package's own 5e-2), and the
     share of differing tokens is printed;
 13. drive ``Effb2TrmCaptioningModel(compute_dtype=torch.bfloat16)`` (the
     weights of phase 4) end to end: 8 clips, greedy, beam 3 and beam 5,
     against the bf16 torch engine (at most 1% of tokens differ, or no
     more than the float32 engine differs from the bf16 one: the fused
     decoders run the decoder's products in float32, as the JAX
     package's do); greedy against the plain version on the same bf16
     memory K/V (at most 1%); the opt-in ``FusedBeamDecoder(weights_bf16=
     True)`` on the float32 model; 16 clips through ``MicroBatchServer``
     (equal to a direct decode); no float32 kernel may launch there;
 14. drive ``Cnn14RnnTempAttnGruModel(compute_dtype=torch.bfloat16)`` as
     phase 8 (kernel log-mel vs plain log-mel; SED within 1e-4 or the
     float32-vs-bf16 gap; tokens at most 1% or the float32-vs-bf16
     count); the log-mel kernel must launch there;
 15. time each bf16 mode's kernel (warm, cold L2, B=1) beside the float32
     kernel, its plain version and its bound (``decode_bound_ms`` at the
     mode's product rate, bytes with 2-byte K/V and weights); bf16
     clips/s of both models at B=64 x 10 s beside float32, greedy and
     beam 3 (the temporal model's over one batch, no warm-up); the
     bf16 EffB2 encode beside the float32 one;
 16. train the flagship at full width (``zoo.effb2_trm(vocab_size=4981)``,
     random weights from a seed) with the recipe of
     ``configs/audiocaps/effb2_trm.yaml`` through the port's trainer API
     (``training/trainer.py``): label smoothing 0.1, Adam 5e-4 with L2
     1e-6, clip 1.0, the exponential schedule with a fifth of warm-up,
     dropout and drop-connect 0.2, scheduled sampling 1.0 -> 0.7, on one
     device-made batch of 32 x 10 s (captions of 8-20 tokens from 64
     words).  (a) 40 steps, none skipped, the mean loss of the last 5 at
     least 10% below the first 5; (b) a batch with a NaN is skipped and
     leaves parameters, Adam state, the lr count and BN buffers
     bit-identical; (c) the checkpoint (``training/checkpoint.py``)
     reloads into a fresh ``Effb2TrmCaptioningModel``, whose greedy
     kernel decodes 8 mixed-length clips as the torch engine does (at
     most 1% of tokens differ); (d) the per-epoch val score
     (``cli/run.py::ValScorer``, greedy CIDEr-D) over 64 clips in batches
     of 32 runs the greedy kernel (its launch count must be above 0), and
     the tokens of that call differ from the torch engine's on the same
     weights in at most 1%; the kernel is held against its plain version
     at the same shapes (B=32, the val batches' valid memory) on phase
     3's jittered weights and random memory K/V, where the trajectories
     are not degenerate; (e) SWA of two
     snapshots equals their mean within 1e-6;
 17. time the train step (median of 10 after 3 warm-up steps, float32,
     TF32 off) split by CUDA events into frontend + encoder forward,
     decoder forward with the SS loop and the loss, backward with the
     clip, and optimizer, for the cached SS path, teacher forcing and the
     recompute oracle; the cached step's device time by kernel
     (``torch.profiler``) and idle share; the clip alone beside torch's
     ``clip_grad_norm_`` (``clip_times``); clips/s, peak memory, model
     FLOPs per clip (3x the forward) and TFLOP/s; the val score's time per
     64 clips;
 18. self-critical sequence training of ``zoo.cnn14rnn_trm(vocab_size=
     4368)`` at full width (Cnn14 at 32 kHz, 3-layer BiGRU 256, 2-layer
     transformer decoder, untied classifier; random weights from a seed,
     the decoder's matrices jittered by 0.15, the encoder's BN statistics
     calibrated on the batch) with the recipe of
     ``configs/synthetic_v2/scst.yaml`` (Adam 5e-5, L2 1e-6, clip 1.0, the
     exponential schedule, max length 20, sample temperature 1) through
     ``training/scst.py`` on one device-made batch of 32 x 10 s, its
     references 5 of the model's own samples per clip ("w{id}" words), the
     greedy baseline through the greedy kernel (a ``FusedGreedyDecoder``
     re-packed each step): (a) 20 steps, each with a finite loss and a
     non-zero advantage; (b) the grad pass's log-probabilities of the
     sampled words within 1e-4 of the sampler's on every masked position,
     and the BN running statistics bit-identical after the steps; (c) at
     steps 1 and 20 the kernel's baseline tokens differ from the torch
     engine's greedy tokens on the same weights in at most 1%, and the
     kernel is held against its plain version at the baseline's shapes
     (B=32, V=4368 untied, the batch's valid memory) on jittered weights
     and random memory K/V; (d) one fresh-Adam step at lr 1e-5 lowers the
     loss recomputed on the last step's samples and advantages; (e) the
     greedy and log-mel kernels launch on this path; (f) phase 4's
     flagship API runs "dbs", "sample", "top5", "top0.9" and "gumbel" on
     CUDA with the JAX API's shapes, "dbs" within 1% of the tokens of the
     same call on a CPU copy of the model.  The mean sampled reward of
     the first and last 5 steps is printed;
 19. time the SCST step (median of 10 after 3 warm-up steps, float32,
     TF32 off) split by CUDA events into the sample pass (the baseline's
     repack, frontend + encode, the greedy kernel, the sampling loop),
     the host rewards, the grad pass (forward, backward, clip) and the
     optimizer; the repack alone; clips/s, peak memory, the device time
     and idle share (``torch.profiler``); the clip beside torch's
     (``clip_times``); the greedy kernel at the baseline's shapes beside its plain version and its bound; the native
     CIDEr-D scorer against the Python one on the batch's rewards; the
     flagship's "dbs" and "top0.9" through the API at B=64 x 10 s;
 20. knowledge distillation of ``zoo.kd_student_cdur5(vocab_size=4368)``
     (Cdur5 encoder, 1-layer decoder, emb 128) from
     ``zoo.cnn14rnn_trm(vocab_size=4368)`` at the recipe of
     ``configs/synthetic_v2/kd_token.yaml`` (KL at T=2, weight 0.5, Adam
     5e-4, L2 1e-6, clip 1.0) through ``training/distill.py`` on one
     device-made batch of 32 x 10 s at 32 kHz: (a) the greedy kernel
     against its plain version at the student's shapes (E=128, one
     layer, S=250, V=4368 untied); (b) a token-KD step on the card
     against a CPU copy (relative 1e-4); (c) 20 steps lower the KD loss,
     2 log-mel launches a step; (d) seq KD: the teacher's pseudo captions
     through the greedy kernel against the torch engine; (e) encoder KD
     with and without captions, the InfoNCE against a CPU copy (1e-5);
     (f) the student's val score through the greedy kernel (``kd_path``);
 21. time the token-KD step (median of 10 after 3, float32, TF32 off)
     split by CUDA events into teacher forward, student forward, KD + sup
     loss, backward and optimizer; KD clips/s, peak memory, idle share;
     the greedy kernel at the student's shapes warm and cold against its
     plain version and its bound; the val score per 64 clips;
 22. the evaluation path of the three trained families at full width
     (``eval_path``): the flagship ``zoo.effb2_trm`` (V=4981 tied, 16
     kHz), ``zoo.cnn14rnn_trm`` and ``zoo.kd_student_cdur5`` (V=4368
     untied, 32 kHz), random weights from a seed, decoders jittered by
     0.15, BN calibrated; each written by ``save_checkpoint`` and read
     back through ``cli/run.py::experiment_model`` from its recipe's
     model node (no PyYAML); 64 device-made 10 s clips a family in
     batches of 32, beam 3, max length 20, through the runner's decode:
     (a) vs ``generate`` beam 3, (b) the beam kernel vs the plain search
     in float64 at each family's shapes (scores within 1e-4), (c) greedy
     through the greedy kernel, (d) ``evaluate_captions`` (every JAX key
     without Java, finite) on the first EVAL_SCORED clips, (e) a
     two-member ensemble on the card vs CPU copies and its dcase csv,
     (f) the flagship's HF export decoded by the API, (g) the inference
     core on 16 wav files at 16, 32 and 44.1 kHz (the short clip
     skipped), (h) the launches;
 23. evaluation times (``eval_times``): clips/s per family at B=32 x 10 s
     split into encode, memory K/V, beam kernel and host, the idle share;
     the beam kernel at the cnn14rnn_trm and KD-student shapes warm and
     cold vs its plain version and bound; the metric suite's host time
     per scorer; the ensemble's torch-engine beam per batch;
 24. the flagship trained on a reduced corpus v2 that the port generates
     (``synthetic_flagship_path``: 960 / 64 / 64 clips of 10 s at 32 kHz,
     4 epochs of the recipe, ``cli/recipes.py``; the corpus is kept for
     phases 26 and 27, which take its first train clips), its val
     score through the greedy kernel, then ``Runner.evaluate`` of the best
     checkpoint at beam 3 through the beam kernel: the loss falls, the
     best val score beats the best constant caption, the test scores are
     finite; on the trained weights the greedy kernel decodes the val set
     as the torch engine does (or diverges at a near tie) and the beam
     kernel passes ``float64_floor_check``;
 25. the temporal pair on a reduced temporal corpus
     (``synthetic_temporal_path``: 320 / 64 / 64 clips, kept for phase
     30): ``train_sed``
     (its log-mel bank through the log-mel kernel, within 1e-3 dB of the
     plain version or no further than it from float64),
     the tag-conditioned captioner for 3 epochs, ``evaluate_temporal``
     with the SED net's tags: both losses fall, the val tag accuracy beats
     the most frequent tag's share and the val score the best constant
     caption;
 26. augmented training of ``zoo.cnn14rnn_trm`` at full width
     (``synthetic_aug_path``): a reduced corpus v2 (320 / 64 / 64 clips,
     phase 24's first train clips) and its speed-perturbed train split (``cli/data_tools.py
     speed_perturb --compute``), ``Runner.train_aug`` of
     ``cli/recipes.py::aug_train`` for 2 epochs (B=32 real + 32 aug
     clips a step): the loss falls, the val score through the greedy
     kernel beats the best constant caption, the greedy kernel launches
     once a val batch an epoch and the log-mel kernel twice a step and
     once a val batch, the log-mel kernel on the first real and aug
     batches within 1e-3 dB of plain or no further from float64; the BN
     running buffers after one aug step equal, bit for bit, those after
     the real forward alone; ``Runner.train`` with ``specaug: True`` for
     three steps, each step's SpecAugment on the card equal to
     ``drop_stripes`` on the CPU for the same stripes, bit for bit, the
     stripes in range; the aug step split by CUDA events (real forward,
     aug forward, backward, optimizer), the idle share and peak memory;
 27. the rest of the 32 kHz captioner family at full width
     (``family_path``, the JAX builder's defaults, 10 s clips at 32 kHz):
     (a) each new encoder from a config dict (Cnn6, Cnn10, Cdur8,
     MobileNetV2, plain Cnn14, Cnn14Transformer at d_model 512 and 2
     layers) forward in ``eval()`` at B=32, fed by the log-mel kernel
     (held against plain on that batch), its time (CUDA events, median
     of 10) and peak memory; on a reduced corpus v2 (640 / 64 / 64
     clips, phase 24's first train clips): (b) ``Runner.train`` for 2
     epochs of a Cnn10 + 2-layer
     ``BahAttnAddFcDecoder`` (emb and d_model 512) with the XE recipe's
     settings and scheduled sampling: the loss falls and the val score
     (torch engine) beats the best constant caption; its step split and
     idle share; (c) SCST of (b)'s best checkpoint (``ScstWrapper``,
     torch engine), its step split and rewards; (d) a Cnn14Transformer +
     ``TransformerDecoder`` captioner trained 40 steps, its val score
     through the greedy kernel and ``Runner.evaluate`` at beam 3 through
     the beam kernel; both kernels against their plain versions at these
     shapes (E=256, S=32, memory width 512) and timed; (e)
     ``ensemble_evaluate`` of (b) and (d), a GRU and a transformer member,
     beam 3, and the same ensemble on CPU copies on 4 clips; (f) the
     conditioned decoders, each a few ``Runner.train`` steps:
     ``ConditionalBahAttnDecoder`` + ``ConditionLossWrapper`` (argmax and
     gumbel) on a ``condition.csv`` of the corpus, a seeded
     ``HmClassifier``; ``SpecificityBahAttnDecoder`` +
     ``SpecificityLossWrapper`` on a word-specificity ``.npy`` of the
     corpus vocabulary; ``StructBahAttnDecoder``: losses finite, the
     condition term moved by the steps, and a decode through
     ``RandomConditionDataset`` (random structure ids for the last);
 28. the MBConv kernel's bf16 work dtype and the feature-input path:
     (a) phase 13's bf16 EffB2 walked on folded weights
     (``bf16_walk``): each of the 19 stride-1 blocks through the kernel in
     bf16 against ``mbconv_plain`` in bf16 within 1e-2 * max(1, max
     |plain|), the walked ``attn_emb`` against the bf16 cuDNN encoder's
     within twice the bf16 encoder's own distance from float32, the
     greedy captions of phase 4's clips through each (equal, or every
     divergence where the bf16 model's margin is below bf16's move of
     it), the 19 blocks timed beside the plain version, the bf16 cuDNN
     blocks and the bound; (b)-(g) on a reduced corpus v1 (64 / 16 / 16
     clips, ``feature_path``): a ``cnn14rnn_trm`` experiment and
     ``prepare_features --format npy`` of it (the log-mel kernel), M2 at
     ``m2_trm.yaml``'s width with device-resident banks and the
     prefetcher, its full resume (epoch, update count, optimizer state),
     ``test_m2.yaml`` through ``Runner.evaluate``, an
     ``AudioTransformerEncoder`` + ``TransformerDecoder`` on the same
     features (its val score through the greedy kernel, its evaluate
     through the beam kernel) and a pruned EffB2 (0.3) trained an epoch
     (its val score through the greedy kernel);
 29. the item-8 encoders and the PANNs classifiers: (a) MobileNetV3
     mn10, HTS-AT, UiT-xs, ESResNeXt-FBSP at its public AudioSet settings,
     ``Cnn10`` and ``Wavegram_Logmel_Cnn14``, each at its published width
     (seeded random weights, BN statistics jittered) on B=32 x 10 s: two
     clips held against a CPU copy of the same weights within 1e-3
     relative, the eval forward timed (median of 10), peak memory, the
     log-mel kernel's launches; (b)-(d) on a reduced corpus v1 (160 / 64
     / 64 clips, ``item8_path``): (b) the ``encoders`` recipe's HTS-AT +
     2-layer ``TransformerDecoder`` captioner trained 2 epochs (50 steps)
     with ``Runner.train``: the loss falls, the val CIDEr-D through the
     greedy kernel beats the best constant caption's, ``Runner.evaluate``
     at beam 3 through the beam kernel, both kernels against their plain
     versions at its shapes (S=32) and timed, the step split and idle
     share; (c) the ESResNeXt-FBSP captioner (``raw_wav``) for a few
     ``Runner.train`` steps, then steps on one batch whose loss falls, its
     evaluation through the beam kernel (S=7, held against plain); (d)
     ``prepare_features`` with ``htsat``, ``panns_cnn10`` and
     ``panns_wavegram`` on 4 clips, card against CPU;
 30. item 8b on phase 25's temporal corpus, each clip's keywords the
     multi-hot of its ground-truth events (527 columns, ``.npy`` rows in
     a temporary directory; ``keyword_path``): (a) the keyword captioner
     of ``cli/recipes.py::keyword_train`` (cnn14rnn_trm's Cnn14 + BiGRU
     encoder at full width, a ``KeywordProbTransformerDecoder`` at the
     JAX builder's defaults) trained 2 epochs (100 steps) with
     ``Runner.train``: the loss falls, the val CIDEr-D of the greedy
     decode with the keywords (torch engine: no kernel takes a
     condition) beats the best constant caption's, the decode with the
     keywords zeroed differs, the runner's own val score (no keywords)
     printed beside it, 2 clips on a CPU copy give the card's tokens or
     diverge at a near tie, the log-mel kernel on the first batch
     against plain, the step split and idle share, the log-mel kernel
     once an encode; (b) an ``EventTransformerDecoder`` for a few
     ``Runner.train`` steps on the same events and a conditioned greedy
     decode; (c) a ``StyleCaptionModel`` (Cnn10, ``StyleBahAttnDecoder``)
     for a few ``Runner.train`` steps, then steps on one batch whose loss
     falls, then a greedy decode with each one-hot ``style_weight``
     through ``style_of_weight``;
 31. the modules that finish the port (``port_tools_path``): (a) ROADMAP
     Queue 3 M's batches (corpus v2's first 160 train clips perturbed,
     the aug loader's first 10 batches of 32), each held by the log-mel
     rule of phase 25, unchanged; (b) the DFT input type: the flagship's
     16 kHz log-mel at B=64 x 10 s with ``compute_dtype=torch.bfloat16``
     against its CPU copy within 1e-3 dB (its distance from float64
     printed beside float32's), the 32 kHz kernel given bfloat16 equal to
     float32's; (c) ``create_word_embedding`` by word2vec on the card over
     corpus v2's train captions against the CPU copy on the card's draws,
     installed into a 256-wide decoder; (d) the demo (``cli/demo.py``,
     its REPL fed 3 wav paths) on phase 26's ``cnn14rnn_trm`` (the
     log-mel kernel) and phase 24's flagship, captions equal to
     ``generate``'s; (e) ``flops_estimate`` of the flagship's eval
     forward at B=32 x 10 s within 2% of an analytic count, ``mfu`` over
     its median time, ``host_rss_gb``; (f) ``Runner.train`` of a
     full-width ``cnn14rnn_trm`` under ``torchrun --nproc_per_node=1``
     (NCCL) against the same run in this process, and two ranks on the
     one card over gloo (this script run with ``--dp-worker``) against
     the single-process step on their global batch; (g) ``prepare_dataset
     clotho --no_pack`` from a Clotho-style csv of corpus v2.

Every kernel's launch counter is set to 0 just before each path is
driven (phases 4-5, the EffB2 serving path; phase 8, the temporal path;
phase 10, the folded encoder walks; phase 13, the bf16 EffB2 path, whose
counts by mode fill the bf16 entries; phase 14, the bf16 temporal path;
phase 16, the training path's val score, whose count is the greedy
entry's ``train_launches``; phase 18, the SCST path, whose counts are the
greedy and log-mel entries' ``scst_launches``; phase 20, the KD path,
whose counts are their ``kd_launches`` and whose val score's greedy
launches are the ``fused_greedy[kd_student]`` entry's; phase 22, the
evaluation path, whose counts are the beam, greedy and log-mel entries'
``eval_launches`` and whose beam launches by family the
``fused_beam[cnn14rnn_trm]`` and ``fused_beam[kd_student]`` entries';
phase 24, the flagship's training and evaluation, whose counts are the
greedy and beam entries' ``synthetic_launches``; phase 25, the temporal
pair, whose log-mel count is the log-mel entry's; phase 26, augmented
training, whose counts are the greedy and log-mel entries'
``aug_launches``; phase 27, the family, whose counts are the greedy, beam
and log-mel entries' ``family_launches`` and whose (d) launches the
``fused_greedy[cnn14trm]`` and ``fused_beam[cnn14trm]`` entries'; phase
28(a), the bf16 walk, whose MBConv count is the ``fused_mbconv[bf16]``
entry's; phase 28(b)-(g), the feature-input path, whose counts are the
greedy, beam and log-mel entries' ``feature_launches``; phase 29, the
item-8 path, whose counts are the greedy, beam and log-mel entries'
``item8_launches`` and whose (b) and (c) launches the
``fused_greedy[htsat]``, ``fused_beam[htsat]`` and
``fused_beam[esresnext]`` entries'; phase 30, the item-8b path, whose
log-mel count is the log-mel entry's ``keyword_launches``; phase 31,
whose log-mel count is the log-mel entry's ``phase31_launches``) and
read just after; the run fails if a kernel of that
path was not launched there.
The second-to-last line is the kernels JSON object, the last line
``{"ok": true, "device": {...}}``.

The script imports nothing of JAX.  It exits non-zero, printing no
result, where CUDA is unavailable or the package is not beside it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
E, NHEAD, FFN, V, NLAYERS = 256, 4, 1024, 4981, 2
B_KERNEL, S_KERNEL, L = 64, 31, 20
BEAMS = (3, 5, 8)             # phase 3: beam sizes held against plain
SR = 16000
SR_32K, B_LOGMEL = 32000, 64
MISMATCH_LIMIT = 0.01
SCORE_ATOL = 1e-4
LOGMEL_DB_ATOL = 1e-3
SED_ATOL = 1e-4
MBCONV_RTOL = 1e-4            # kernel vs plain, times max(1, max |plain|)
ENCODER_RTOL = 1e-3           # walked vs cuDNN attn_emb, times max |ref|
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s,
# and float32 products through the TF32 tensor cores in a 3xTF32 split
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12            # float64 outside the tensor cores
TF32X3_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12           # dense bf16 tensor-core peak
# phase 12, weights_bf16: a kernel n-best score against the plain version's
# float64 score of the same sequence (see bf16_kernels)
WEIGHTS_SCORE_ATOL = 2e-2
# phases 16-17: the flagship recipe's train step at full width
TRAIN_B, TRAIN_SECONDS, TRAIN_STEPS = 32, 10, 40
TRAIN_WORDS, TRAIN_CAP_LEN = 64, (8, 20)   # caption tokens, <bos>/<eos> in
TRAIN_LOSS_DROP = 0.10        # last 5 steps' mean loss vs the first 5
TRAIN_VAL_CLIPS = 64
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
SWA_ATOL = 1e-6
# phases 18-19: SCST of zoo.cnn14rnn_trm (configs/synthetic_v2/scst.yaml)
SCST_V, SCST_B, SCST_SECONDS, SCST_STEPS = 4368, 32, 10, 20
SCST_LR, SCST_FINAL_LR, SCST_WD, SCST_CLIP = 5e-5, 5e-7, 1e-6, 1.0
SCST_REFS = 5                 # references per clip, from the model's samples
SCST_DECODER_JITTER = 0.15    # a peaked, not one-word, decoder distribution
SCST_LOGPROB_ATOL = 1e-4      # grad pass vs sampler, on masked positions
# (d): one fresh-Adam step from the last step's weights, read at each of
# these learning rates (the recipe's is the last) for three parameter
# sets, beside its first-order prediction g . dtheta.  Gated: the decoder
# alone lowers the loss at every rate, every set at the smallest, where
# the change is within SCST_FIRST_ORDER of its first-order prediction (a
# gradient check of the card's path, cuDNN GRU backward included)
SCST_PROBE_LRS = (1e-7, 1e-6, 1e-5, 5e-5)
SCST_PROBE_SETS = {"whole model": lambda n: True,
                   "GRU + decoder (CNN frozen)":
                       lambda n: not n.startswith("encoder.cnn."),
                   "decoder": lambda n: n.startswith("decoder.")}
SCST_FIRST_ORDER = 0.1        # |change / prediction - 1| at the smallest lr
SCST_WARMUP, SCST_TIMED = 3, 10
NEW_METHODS = ("dbs", "sample", "top5", "top0.9", "gumbel")
# phases 20-21: knowledge distillation (configs/synthetic_v2/kd_token.yaml):
# zoo.kd_student_cdur5 distilled from zoo.cnn14rnn_trm
KD_V, KD_B, KD_SECONDS, KD_STEPS = 4368, 32, 10, 20
KD_LR, KD_FINAL_LR, KD_WD, KD_CLIP = 5e-4, 5e-7, 1e-6, 1.0
KD_T, KD_WEIGHT, KD_SHARED = 2.0, 0.5, 1024
KD_STEP_RTOL = 1e-4           # (b) loss and gradient norm, card vs CPU copy
KD_NCE_ATOL = 1e-5            # (e) InfoNCE, card vs CPU copy
KD_VAL_CLIPS = 64
KD_WARMUP, KD_TIMED = 3, 10

# phases 22-23: evaluation of the three trained families, as
# configs/*/test.yaml runs it (beam 3, max length 20, batches of 32); each
# family's model node is its recipe's (the configs named), an experiment
# written by save_checkpoint and read back through cli/run.py's
# experiment_model without PyYAML
EVAL_FAMILIES = {
    "effb2_trm": dict(vocab=4981, sr=SR, seed=SEED + 40, node={
        # configs/audiocaps/effb2_trm.yaml
        "type": "captioning.models.transformer_model.TransformerModel",
        "args": {},
        "encoder": {"type": "captioning.models.cnn_encoder.EfficientNetB2",
                    "args": {}},
        "decoder": {
            "type": "captioning.models.transformer_decoder."
                    "TransformerDecoder",
            "args": {"vocab_size": 4981, "emb_dim": 256, "fc_emb_dim": 1408,
                     "attn_emb_dim": 1408, "nlayers": 2, "dropout": 0.2,
                     "tie_weights": True}}}),
    "cnn14rnn_trm": dict(vocab=4368, sr=SR_32K, seed=1, node={
        # configs/synthetic_v2/cnn14rnn_trm.yaml
        "type": "captioning.models.transformer_model.TransformerModel",
        "args": {},
        "encoder": {
            "type": "captioning.models.crnn_trm_encoder.Cnn14RnnEncoder",
            "args": {"freeze_cnn": False, "freeze_cnn_bn": False},
            "cnn": {"type": "captioning.models.cnn_encoder.Cnn14Encoder",
                    "args": {"sample_rate": 32000}},
            "rnn": {"type": "captioning.models.rnn_encoder.RnnEncoder",
                    "args": {"bidirectional": True, "hidden_size": 256,
                             "dropout": 0.5, "num_layers": 3,
                             "spec_dim": -1, "fc_feat_dim": 2048,
                             "attn_feat_dim": 2048}}},
        "decoder": {
            "type": "captioning.models.transformer_decoder."
                    "TransformerDecoder",
            "args": {"emb_dim": 256, "fc_emb_dim": 512, "attn_emb_dim": 512,
                     "nlayers": 2, "dropout": 0.2}}}),
    "kd_student": dict(vocab=4368, sr=SR_32K, seed=SEED + 41, node={
        # configs/synthetic_v2/kd_token.yaml
        "type": "captioning.models.transformer_model.TransformerModel",
        "args": {},
        "encoder": {"type": "captioning.models.crnn_trm_encoder.Cdur5Encoder",
                    "args": {"sample_rate": 32000}},
        "decoder": {
            "type": "captioning.models.transformer_decoder."
                    "TransformerDecoder",
            "args": {"emb_dim": 128, "nlayers": 1, "dropout": 0.2}}}),
}
EVAL_CLIPS, EVAL_B, EVAL_SECONDS = 64, 32, 10
EVAL_ARGS = {"sample_method": "beam", "beam_size": 3, "max_length": L}
EVAL_REFS = 5                 # references per clip, from the model's samples
# (d) scores the first EVAL_SCORED clips of each family: meteor_py's chunk
# search runs to its 100k-pairing budget on the one-word loops of these
# random models (~0.75 s a caption-reference pair on the host)
EVAL_SCORED = 4
EVAL_ENSEMBLE_SEED = 2        # the second cnn14rnn_trm member (the first: 1)
EVAL_ENSEMBLE_CPU = 4         # clips of the ensemble's card-vs-CPU check
EVAL_WAVS = 16                # wav files of the inference core, one short
EVAL_WAV_SECONDS = (1.0, 10.0)
EVAL_WARMUP, EVAL_TIMED = 2, 10
EVAL_DISTINCT = 10            # (b): distinct tokens of the plain search, above
# phases 24-25: reduced synthetic corpora (train / val / test clips of 10 s
# at 32 kHz, seed 0), the recipes' epochs cut to these, SWA from epoch 2
# The flagship learns to name its events only after some 500-900 steps at
# the recipe's rates (the full recipe's val CIDEr-D: 0.20 after epoch 1,
# 2.70 after epoch 2; before that, greedy captions score about what a
# constant caption does), and its schedule decays the rate a thousandfold
# over the run: so phase 24 takes 600 steps and decays the rate tenfold
# (750 until the script's time went to phase 28; the val score beat the
# constant caption from the fourth epoch of 150 steps on in both runs).
# The temporal recipe learns within 150 steps as it is.
SYN_V2_SIZES, SYN_V2_EPOCHS = (960, 64, 64), 4
SYN_V2_FINAL_LR = 5e-5
SYN_TEMPORAL_SIZES, SYN_SED_EPOCHS, SYN_TEMPGRU_EPOCHS = (320, 64, 64), 8, 3
SYN_WORKERS = 6               # train loader workers (the card host has 8 cores)
CLIP_TIMED = 20               # calls of each clip in phases 17 and 19
SYN_TIE = 1e-4                # a greedy divergence at a log-prob gap below it
SYN_CONSTANT_CANDIDATES = 20  # the most frequent train captions tried as a
                              # constant val prediction
# phase 26: augmented training of zoo.cnn14rnn_trm on a reduced corpus v2
# and its speed-perturbed copy; the recipe's schedule decays the rate only
# tenfold over these epochs, as phase 24's does
SYN_AUG_SIZES, SYN_AUG_EPOCHS = (320, 64, 64), 2
SYN_AUG_FINAL_LR = 5e-5
SYN_AUG_SPECAUG_SAMPLES = 96  # (d): three Runner.train steps of 32
SYN_AUG_WARMUP, SYN_AUG_TIMED = 2, 6
# phase 27: the rest of the 32 kHz family on a reduced corpus v2
FAM_SIZES = (640, 64, 64)     # clips; 5 captions a train clip
FAM_B, FAM_SECONDS = 32, 10   # (a)
FAM_XE_EPOCHS = 2             # (b): 100 steps of 32 an epoch
FAM_XE_FINAL_LR = 5e-5
FAM_SCST_STEPS = 24           # (c)
FAM_TRM_EPOCHS = 1            # (d)
FAM_TRM_STEPS = 40            # (d): Runner.train steps of its epoch
FAM_COND_STEPS = 3            # (f): Runner.train steps of each decoder
FAM_WARMUP, FAM_TIMED = 2, 10
FAM_STEP_TIMED = 6            # (b), (c): timed steps after FAM_WARMUP
# phase 28: the feature-input path on a reduced corpus v1, and the MBConv
# kernel's bf16 work dtype on the bf16 EffB2 walk
FEAT_SIZES, FEAT_EPOCHS = (64, 16, 16), 1
MBCONV_BF16_RTOL = 1e-2       # bf16 kernel vs bf16 plain, times max(1, max)
BF16_WALK_FACTOR = 2.0        # walked vs cuDNN bf16, times bf16's own error
# phase 29: the item-8 encoders and PANNs classifiers
ENC_B, ENC_SECONDS = 32, 10   # (a)
ENC_CPU_CLIPS = 2             # (a): clips held against a CPU copy
ENC_RTOL = 1e-3               # (a), (d): card vs CPU, times max(1, max |CPU|)
ENC_SIZES = (160, 64, 64)     # (b)-(d): corpus v1; 5 captions a train clip
ENC_EPOCHS = 2                # (b): 25 steps of 32 an epoch
ENC_FINAL_LR = 5e-5
ENC_RX_STEPS = 6              # (c): Runner.train steps, then steps on a batch
ENC_FEATURE_CLIPS = 4         # (d)
ITEM8 = ("mobilenet_v3", "htsat", "uit_xs", "esresnext", "panns_cnn10",
         "panns_wavegram")
# phase 30: item 8b on phase 25's temporal corpus (320 train clips, 5
# captions each: 50 steps of 32 an epoch)
KW_EPOCHS = 2                 # (a): the keyword captioner
KW_FINAL_LR = 5e-5
KW_CPU_CLIPS = 2              # (a): clips decoded on a CPU copy
KW_EVENT_STEPS = 3            # (b): Runner.train steps
KW_STYLE_STEPS = 3            # (c): Runner.train steps
KW_STYLE_BATCH_STEPS = 10     # (c): then steps on one repeated batch
# phase 31: (a) the speed-perturbed batches that once failed the log-mel
# rule: corpus v2's first 160 train clips, as phase 26 once ran them
QM_SIZES = (160, 64, 64)
QM_BATCHES = 10               # of the aug loader's 50 (5 captions a clip)
W2V_EMB, W2V_EPOCHS = 256, 2  # (c): the flagship decoder's width
W2V_RTOL_OF_MAX = 1e-5        # (c): test_torch_word_embedding.py's bound
DEMO_CLIPS = 3                # (d): wav paths fed to the demo's REPL
FLOPS_RTOL, FLOPS_TIMED = 0.02, 10   # (e)
FLOPS_B, FLOPS_SECONDS = 32, 10      # (e): the eval forward's batch
DP_SAMPLES = 128              # (f)(i): 4 steps of 32
DP_RTOL, DP_ATOL = 1e-5, 1e-5  # (f)(i): torchrun vs this process, or
DP_FLOOR_FACTOR = 4           # that times two runs' own gap here
DP_B, DP_VOCAB = 8, 4368      # (f)(ii): global batch, cnn14rnn_trm's vocab
DP_SECONDS = 10               # (f)(ii): clip length
DP_SS = 0.7                   # (f)(ii): the scheduled-sampling ratio
DP_TIMEOUT = 300              # (f): seconds a subprocess may take
FAM_ENCODERS = {
    "Cnn6Encoder": {}, "Cnn10Encoder": {}, "Cdur8Encoder": {},
    "MobileNetV2": {}, "Cnn14Encoder": {},
    "Cnn14TransformerEncoder": {"transformer": {"args": {"d_model": 512,
                                                         "nlayers": 2}}}}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def clip_times(params, card: str, label: str) -> dict:
    """The port's clip (``training/trainer.py::clip_grad_norm``, its norms
    in float64) beside ``nn.utils.clip_grad_norm_`` on the gradients the
    last step left, CLIP_TIMED calls each after a warm-up (max norm 1e9:
    both scale by 1, and the gradients keep their values)."""
    import torch
    from audiocaption_tpu_torch.training.trainer import clip_grad_norm
    params = [p for p in params if p.grad is not None]
    out = {"port_ms": cuda_ms(lambda: clip_grad_norm(params, 1e9),
                              CLIP_TIMED),
           "torch_ms": cuda_ms(lambda: torch.nn.utils.clip_grad_norm_(
               params, 1e9), CLIP_TIMED)}
    log(f"{label} clip over {len(params)} gradient tensors "
        f"({sum(p.numel() for p in params) / 1e6:.1f} M values): the port's "
        f"clip_grad_norm {out['port_ms']:.3f} ms, torch's clip_grad_norm_ "
        f"{out['torch_ms']:.3f} ms (CUDA events, mean of {CLIP_TIMED}) on "
        f"{card}")
    return out


def device_split(fn, iters: int = 5, launches=None) -> dict:
    """Device time per kernel (ms per call of ``fn``), from a
    ``torch.profiler`` trace of ``iters`` calls after one warm-up: the
    launches of a multi-kernel call apart, and the kernels' time without
    the host's.  Empty if the profiler records no device time.  A dict
    ``launches`` gets each kernel's launches per call."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            names = re.findall(r"[A-Za-z_]\w*_kernel\b", ev.key)
            name = names[0] if names else ev.key[:40]
            out[name] = out.get(name, 0.0) + us / 1e3 / iters
            if launches is not None:
                launches[name] = launches.get(name, 0) + ev.count / iters
    return {k: round(v, 4) for k, v in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


def jittered_decoder_inputs(device):
    """Random decoder weights (seeded, jittered as the parity tests do),
    packed for the kernels, and random well-spread memory K/V."""
    import torch
    from audiocaption_tpu_torch.decoding.fused_greedy import (
        pack_decoder_weights)
    from audiocaption_tpu_torch.models.transformer_decoder import (
        TransformerDecoder)
    from audiocaption_tpu_torch.models.zoo import random_init
    gen = torch.Generator().manual_seed(SEED)
    dec = TransformerDecoder(E, V, 1408, nlayers=NLAYERS, nhead=NHEAD,
                             dim_feedforward=FFN, tie_weights=True)
    random_init(dec, gen)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.4)
    packed = pack_decoder_weights(dec.eval()).to(device)
    memkv = torch.randn(NLAYERS, 2, B_KERNEL, S_KERNEL, E,
                        generator=gen).to(device)
    lens = torch.randint(1, S_KERNEL + 1, (B_KERNEL,), generator=gen)
    lens[0], lens[1] = S_KERNEL, 0          # full and fully-masked memory
    valid = (torch.arange(S_KERNEL)[None] < lens[:, None]).to(torch.uint8)
    return packed, memkv, valid.to(device)


def decode_flops(E_, F_, V_, S_valid, steps_per_row, rows_per_sample,
                 nl=NLAYERS, S_=S_KERNEL):
    """(product ops, attention ops) one decode needs: per executed step and
    row, the ``nl`` layers' and the vocabulary products (weights times the
    row), and self attention over t+1 keys plus cross attention over the
    valid memory, all S_ keys where none is valid (2 ops per
    multiply-add)."""
    per_step_weights = nl * 2 * (6 * E_ * E_ + 2 * E_ * F_) + 2 * V_ * E_
    mm = attn = 0
    for s_valid, steps in zip(S_valid, steps_per_row):
        keys = s_valid if s_valid > 0 else S_
        for t in range(steps):
            mm += rows_per_sample * per_step_weights
            attn += rows_per_sample * nl * 2 * 2 * E_ * ((t + 1) + keys)
    return mm, attn


def packed_double(packed):
    """The packed decoder's tables in float64 (its float32 values are
    exact there): the plain search without float32 rounding."""
    import dataclasses
    return dataclasses.replace(packed, **{
        k: getattr(packed, k).double() for k in ("emb", "cls", "pe",
                                                  "layers")})

def float64_floor_check(packed, memkv, valid, K, seq, score, p_seq,
                        p_score, **mode) -> bool:
    """Beam scores of the wider beams against the float32 plain version,
    with the float32 floor beside them.  At the flagship width with these
    jittered weights some of the float32 plain version's own n-best scores
    lie more than 1e-4 from the same search run in float64 (beam 5; this
    function prints by how much), so no kernel can hold all of them to
    1e-4.  A score of a sequence that the kernel,
    the plain version and the float64 plain version share passes if it is
    within SCORE_ATOL of the float32 plain version, or else no further
    from the float64 result than the float32 plain version is."""
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    p64 = packed_double(packed)
    mem64 = memkv if mode.get("cache_bf16") else memkv.double()
    s64, sc64 = FB.fused_beam_plain(p64, mem64, valid, L, K, **mode)
    same = (seq == p_seq).all(-1) & (seq == s64).all(-1)
    err = (score[same].double() - p_score[same].double()).abs()
    dev_k = (score[same].double() - sc64[same]).abs()
    dev_p = (p_score[same].double() - sc64[same]).abs()
    ok = (err <= SCORE_ATOL) | (dev_k <= dev_p)
    log(f"beam {K} {mode or ''} scores on {int(same.sum())} shared "
        f"sequences: kernel vs "
        f"float32 plain max {float(err.max()):.3g}; float32 plain vs float64 "
        f"plain max {float(dev_p.max()):.3g} ({int((dev_p > SCORE_ATOL).sum())}"
        f" above {SCORE_ATOL}); kernel vs float64 plain max "
        f"{float(dev_k.max()):.3g}; {int((~ok).sum())} fail")
    return bool(ok.all()) and int(same.sum()) > 0


def decode_bound_ms(mm: int, attn: int, nbytes: int,
                    mm_flops: float = FP32_FLOPS):
    """(bound ms, bound ms with the products at the 3xTF32 rate, bound_by):
    the bytes at the HBM rate against the operations at the float32 peak,
    67 TFLOP/s, which is also the FP64 tensor-core rate that the kernels'
    products run at (float32 products are exact in float64).  The 3xTF32
    figure is what the products would need at a third of the TF32 peak.
    ``mm_flops``: the products' rate (BF16_FLOPS for weights_bf16)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mm / mm_flops + attn / FP32_FLOPS) * 1e3
    t_tf32 = (mm / TF32X3_FLOPS + attn / FP32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), max(t_bytes, t_tf32),
            "bytes" if t_bytes >= t_ops else "operations")


def cold_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` with the L2 cold: a 64 MB buffer is
    written before each call (as the encoder does between decodes on the
    serving path), and only the call is timed."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for i in range(iters):
        flush.fill_(i & 0xff)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def input_bytes(packed, memkv, valid, out_bytes, weights_bf16=False):
    """Each input read once (the tied classifier is the embedding),
    each output written once.  The memory K/V at their element size (2
    bytes with cache_bf16); with weights_bf16 the embedding and the layer
    matrices at 2 bytes (biases and LayerNorm stay 4)."""
    wb = 2 if weights_bf16 else 4
    E_, F_ = packed.emb_dim, packed.ffn
    # wqkv, wo, xwq, xwo, w1, w2 of every layer
    n_mat = packed.nlayers * (6 * E_ * E_ + 2 * E_ * F_)
    n = packed.emb.numel() * wb + n_mat * wb
    n += (packed.layers.numel() - n_mat) * 4
    if packed.cls.data_ptr() != packed.emb.data_ptr():
        n += packed.cls.numel() * wb
    n += L * packed.pe.shape[1] * 4 + memkv.numel() * memkv.element_size()
    return n + valid.numel() + out_bytes


def jitter_model(api, gen) -> None:
    """Jitter the decoder and give every BN non-identity statistics."""
    import torch
    with torch.no_grad():
        for p in api.model.decoder.parameters():
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * 0.1)
        for m in api.model.encoder.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
    api._decode = {}


def jitter_temporal(api, gen) -> None:
    """Jitter the temporal decoder, sharpen the SED classifier (so SED tags
    vary and a user tag changes them) and give every BN (captioner encoder
    and SED) non-identity statistics."""
    import torch
    with torch.no_grad():
        for p in api.model.cap_model.decoder.parameters():
            # 0.1: larger jitters make the decoder GRU chaotic, so that
            # float32 rounding alone flips tokens late in a caption
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * 0.1)
        api.model.sed_model.fc_audioset.weight.mul_(2.7)
        for m in api.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))


def logmel_work(front, batch: int, samples: int):
    """(float ops, bytes) the log-mel function needs, whatever algorithm
    computes it.  Per frame: the window product (n_fft), a real FFT
    (2.5 n_fft log2 n_fft, the usual count), the power of the bins that
    carry mel weight (3 each), the mel product over the filterbank's
    nonzero weights (2 each) and the dB conversion (2 per mel).  Bytes:
    the wave read once, the window and the nonzero mel weights read once,
    the log-mel written once."""
    cfg = front.config
    n = cfg.n_fft
    n_frames = samples // cfg.hop + 1
    nonzero = front.mel_fb != 0
    nnz, bins = int(nonzero.sum()), int(nonzero.any(1).sum())
    per_frame = n + 2.5 * n * math.log2(n) + 3 * bins + 2 * nnz \
        + 2 * cfg.n_mels
    flops = int(batch * n_frames * per_frame)
    nbytes = 4 * (batch * samples + n + nnz + batch * n_frames * cfg.n_mels)
    return flops, nbytes


def stft_logmel(wav, front):
    """The library yardstick: the same log-mel with the spectrum from
    cuFFT (``torch.stft``: center, reflect pad, periodic Hann), then the
    mel product and dB.  Timed and checked here only; the port never
    calls it."""
    import torch
    from audiocaption_tpu_torch.ops.fused_logmel import amplitude_to_db
    cfg = front.config
    spec = torch.stft(wav, cfg.n_fft, cfg.hop,
                      window=torch.hann_window(cfg.n_fft, device=wav.device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    return amplitude_to_db(torch.matmul(power, front.mel_fb), cfg.top_db)


def float64_logmel(wav, front):
    """The log-mel in float64 (``torch.fft.rfft`` of the reflect-padded,
    windowed frames): the yardstick of both float32 versions' rounding."""
    import torch
    from audiocaption_tpu_torch.ops.fused_logmel import amplitude_to_db
    cfg = front.config
    frames = torch.nn.functional.pad(
        wav.double()[:, None], (cfg.n_fft // 2,) * 2, mode="reflect")[:, 0]
    frames = frames.unfold(1, cfg.n_fft, cfg.hop) * torch.hann_window(
        cfg.n_fft, dtype=torch.float64, device=wav.device)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    return amplitude_to_db(power @ front.mel_fb.double(), cfg.top_db)


def logmel_check(dev, card):
    """Phase 7: the log-mel kernel against its plain version at
    B=64 x 10 s, 32 kHz and 16 kHz presets -> max |diff| per preset."""
    import torch
    from audiocaption_tpu_torch.ops import frontend as TF
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    gen = torch.Generator().manual_seed(SEED + 2)
    errs = {}
    for name in ("CNN14_MEL_32K", "EFFB2_MEL_16K"):
        cfg = getattr(TF, name)
        front = TF.LogMelFrontend(cfg).to(dev)
        wav = torch.randn(B_LOGMEL, 10 * cfg.sample_rate, generator=gen) * 0.1
        wav[-1, wav.shape[1] // 2:] = 0.0          # silence: the 1e-10 floor
        wav = wav.to(dev)
        got = FL.fused_logmel(wav, front.basis, front.mel_fb, cfg)
        want = FL.fused_logmel_plain(wav, front.basis, front.mel_fb, cfg)
        ref = float64_logmel(wav, front)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs[name] = err
        log(f"log-mel kernel vs plain, {name}, B={B_LOGMEL} x 10 s "
            f"{tuple(got.shape)}: max |diff| {err:.3g} dB (limit "
            f"{LOGMEL_DB_ATOL}); against a float64 FFT: kernel "
            f"{float((got.double() - ref).abs().max()):.3g} dB, plain "
            f"{float((want.double() - ref).abs().max()):.3g} dB on {card}")
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert err <= LOGMEL_DB_ATOL, f"log-mel kernel disagrees on {name}"
    return errs


def temporal_path(dev, card, rng):
    """Phase 8: the temporal captioner end to end, kernel log-mel vs the
    same modules fed by the plain log-mel -> (api, launches)."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.hf_api import (
        Cnn14RnnTempAttnGruConfig, Cnn14RnnTempAttnGruModel, pad_bucket)
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    api = Cnn14RnnTempAttnGruModel(Cnn14RnnTempAttnGruConfig(vocab_size=V),
                                   seed=SEED, device="cuda")
    jitter_temporal(api, torch.Generator().manual_seed(SEED + 3))
    sr = SR_32K
    lens = np.asarray([10 * sr, 9 * sr, 7 * sr + 123, 5 * sr, 3 * sr + 7,
                       2 * sr, sr, sr + 4000])
    audio = (rng.randn(8, 10 * sr) * 0.1).astype(np.float32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0                        # zero-padded clips
    user_tag = np.asarray([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
    runs = [(m, t) for m in ("greedy", "beam") for t in (None, user_tag)]
    FG.reset_launches(FG.fused_greedy_decode)
    FG.reset_launches(FB.fused_beam_decode)
    FL.fused_logmel.launches = 0
    out = {}
    for method, tag in runs:
        out[method, tag is None] = api(audio, lens, temporal_tag=tag,
                                       sample_method=method, beam_size=3,
                                       max_length=L)
    launches = {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_beam": FB.fused_beam_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}
    log(f"temporal-path launches: {launches}")
    assert launches["fused_logmel"] > 0, "the log-mel kernel was not launched"

    wav = torch.from_numpy(pad_bucket(audio, sr)).to(dev)
    front = api.model.cap_model.frontend
    lms_kernel = api.log_mel(wav)
    lms_plain = FL.fused_logmel_plain(wav, front.basis, front.mel_fb, api.mel)
    with torch.no_grad():
        fw_k = api.model.sed_model(lms_kernel)["framewise_output"]
        fw_p = api.model.sed_model(lms_plain)["framewise_output"]
        lens_t = torch.from_numpy(lens).to(dev)
        enc_k = api.model.cap_model.encode_lms(lms_kernel,
                                               api.mel.feat_len(lens_t))
        enc_p = api.model.cap_model.encode_lms(lms_plain,
                                               api.mel.feat_len(lens_t))
    enc_err = float((enc_k["attn_emb"] - enc_p["attn_emb"]).abs().max())
    sed_err = float((fw_k - fw_p).abs().max())
    tags = api.sed_tags(lms_kernel)
    log(f"temporal path: kernel vs plain log-mel: SED framewise max |diff| "
        f"{sed_err:.3g} (limit {SED_ATOL}), captioner attn_emb max |diff| "
        f"{enc_err:.3g}; SED tags {tags.tolist()}, "
        f"user tags {user_tag.tolist()}, merged "
        f"{np.minimum(user_tag, tags).tolist()} on {card}")
    assert sed_err <= SED_ATOL, "SED output disagrees"
    np.testing.assert_array_equal(tags, api.sed_tags(lms_plain))
    for (method, no_tag), ids in out.items():
        assert ids.shape == (8, L) and ((ids >= 0) & (ids < V)).all()
        ref = api.decode_lms(lms_plain, lens, None if no_tag else user_tag,
                             sample_method=method, beam_size=3,
                             max_length=L).cpu().numpy()
        mis = int((ids != ref).sum())
        log(f"temporal end to end {method}, "
            f"{'SED tag' if no_tag else 'user tag'}: kernel log-mel vs "
            f"plain log-mel {mis}/{ids.size} tokens differ; first caption "
            f"{ids[0][:8]} on {card}")
        assert mis <= MISMATCH_LIMIT * ids.size, f"{method} path disagrees"
    assert len(np.unique(np.concatenate(list(out.values())))) > 10, \
        "degenerate temporal captions"
    return api, launches


def temporal_times(api, dev, card):
    """Phase 9: log-mel kernel, plain, library yardstick and bound; the
    split of one temporal batch; end-to-end clips/s.  B=64 x 10 s."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.models.sed import framewise_to_temporal_tags
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    front, B = api.model.cap_model.frontend, B_LOGMEL
    tables = (front.basis, front.mel_fb, api.mel)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    wav = torch.randn(B, 10 * SR_32K, generator=gen, device=dev) * 0.1
    lens = torch.full((B,), 10 * SR_32K, dtype=torch.long, device=dev)
    with torch.no_grad():
        lib_err = float((stft_logmel(wav, front)
                         - FL.fused_logmel_plain(wav, *tables)).abs().max())
        log(f"library yardstick (torch.stft + mel matmul) vs plain: max "
            f"|diff| {lib_err:.3g} dB (limit {LOGMEL_DB_ATOL})")
        assert lib_err <= LOGMEL_DB_ATOL, "the yardstick computes another function"
        k_ms = cuda_ms(lambda: FL.fused_logmel(wav, *tables), 10)
        p_ms = cuda_ms(lambda: FL.fused_logmel_plain(wav, *tables), 5,
                       warmup=1)
        lib_ms = cuda_ms(lambda: stft_logmel(wav, front), 10)
        k_ms2 = cuda_ms(lambda: FL.fused_logmel(wav, *tables), 10)
    flops, nbytes = logmel_work(front, B, wav.shape[1])
    # the bound is the function's: float32 out, float32 ops suffice (the
    # plain float32 version meets the float64 rule); the kernel's own
    # float64 arithmetic is a design choice, its op time printed beside
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    t_fp64 = flops / FP64_FLOPS * 1e3
    log(f"fused_logmel device time by kernel (torch.profiler): "
        f"{device_split(lambda: FL.fused_logmel(wav, *tables))}")
    log(f"fused_logmel: {k_ms:.4f} ms/call (again {k_ms2:.4f}; plain "
        f"{p_ms:.3f} ms, torch.stft yardstick {lib_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms: {nbytes} bytes, {flops} ops at the "
        f"float32 rate; the same ops at the float64 rate the kernel works "
        f"in {t_fp64:.4f} ms) B={B} x 10 s 32 kHz on {card}")
    timing = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    with torch.no_grad():
        lms = api.log_mel(wav)
        feat_len = api.mel.feat_len(lens)
        sed_ms = cuda_ms(lambda: api.model.sed_model(lms), 3, warmup=1)
        framewise = api.model.sed_model(lms)["framewise_output"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tags = framewise_to_temporal_tags(framewise.cpu().numpy())
        host_ms = (time.perf_counter() - t0) * 1e3
        enc_ms = cuda_ms(lambda: api.model.cap_model.encode_lms(lms,
                                                                feat_len),
                         3, warmup=1)
        enc = api.model.cap_model.encode_lms(lms, feat_len)
        tag_t = torch.from_numpy(tags).to(dev)
        dec_ms = {}
        for method in ("greedy", "beam"):
            dec_ms[method] = cuda_ms(lambda: generate(
                api.model.cap_model, enc=enc, temporal_tag=tag_t,
                sample_method=method, beam_size=3, max_length=L), 2,
                warmup=1)
    log(f"temporal batch split, B={B} x 10 s: frontend (log-mel kernel) "
        f"{k_ms:.3f} ms, SED network {sed_ms:.2f} ms, host tag step "
        f"{host_ms:.1f} ms (tags {np.bincount(tags, minlength=4).tolist()}), "
        f"captioner encoder {enc_ms:.2f} ms, decode greedy "
        f"{dec_ms['greedy']:.2f} ms / beam 3 {dec_ms['beam']:.2f} ms "
        f"on {card}")
    for method in ("greedy", "beam"):
        def fn():
            return api.decode_lms(api.log_mel(wav), lens,
                                  sample_method=method, beam_size=3,
                                  max_length=L)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # one batch, no warm-up: 2.4-3.1 s, nearly all the host tag step
        # (the batch split above ran each part at this batch's shapes)
        fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"temporal end to end {method}: {B / dt:.1f} clips/s "
            f"({dt * 1e3:.1f} ms per batch of {B} x 10 s) on {card}")
    return timing


def mbconv_work(spec, batch: int, H: int, W: int, squeeze: int,
                act_bytes: int = 4):
    """(1x1 product ops, other float ops, bytes) one folded MBConv block
    with ``squeeze`` SE channels needs on a [batch, C, H, W] input,
    whatever algorithm computes it: the expand and project products once
    (a multiply-add is 2 ops); besides them the bias adds (1), swish and
    sigmoid (4 each), the depthwise, the SE mean and the gate (1 per
    expanded value), the residual, and per sample the SE MLP.  Bytes: x
    read once and the output written once (``act_bytes`` a value: 2 in
    the bf16 work dtype), the float32 folded weights read once."""
    C, E, Co, k, S = spec.in_ch, spec.exp_ch, spec.out_ch, spec.kernel, \
        squeeze
    pt, pb, pl, pr = spec.pad
    Ho = (H + pt + pb - k) // spec.stride + 1
    Wo = (W + pl + pr - k) // spec.stride + 1
    mm_px = (2 * C * E if spec.has_expand else 0) + 2 * E * Co
    other_px = (5 * E if spec.has_expand else 0) + 2 * k * k * E + 5 * E \
        + 2 * E + Co + (Co if spec.has_residual else 0)
    per_sample = 2 * E * S + 5 * S + 2 * S * E + 5 * E
    mm = batch * Ho * Wo * mm_px
    other = batch * (Ho * Wo * other_px + per_sample)
    n_weights = (C * E + E if spec.has_expand else 0) + k * k * E + E \
        + E * S + S + S * E + E + E * Co + Co
    nbytes = (act_bytes * (batch * C * H * W + batch * Co * Ho * Wo)
              + 4 * n_weights)
    return mm, other, nbytes


def mbconv_bound_ms(mm: int, other: int, nbytes: int,
                    mm_flops: float = TF32X3_FLOPS):
    """(bound ms, bound ms with every op at the float32 CUDA-core rate,
    bound_by): the larger of the bytes at the HBM rate and the operations,
    the 1x1 products at ``mm_flops`` (the kernel's route: the 3xTF32
    tensor-core rate in float32, the bf16 dense rate in bf16) and the rest
    at the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mm / mm_flops + other / FP32_FLOPS) * 1e3
    t_fp32 = (mm + other) / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), max(t_bytes, t_fp32),
            "bytes" if t_bytes >= t_ops else "operations")


def checked_walk(encoder, lms, feat_len, errs, inputs=None):
    """Walk ``encoder`` on folded weights: each stride-1 block through the
    kernel, held against ``mbconv_plain`` on the same input (max |diff|
    and max |plain| appended to ``errs``; each block's input kept in
    ``inputs`` when given); stride-2 blocks through ``mbconv_plain``."""
    import functools
    import torch
    from audiocaption_tpu_torch.ops import fused_mbconv as FM

    def check(x, fn, weights, spec):
        if inputs is not None:
            inputs.append(x)
        got = fn(x, weights=weights, spec=spec)
        want = FM.mbconv_plain(x, weights, spec)
        errs.append((float((got - want).abs().max()),
                     float(want.abs().max())))
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        return got

    blocks = []
    for fn in FM.folded_blocks(encoder):
        if fn.func is FM.fused_mbconv_s1:
            fn = functools.partial(check, fn=fn.func, **fn.keywords)
        blocks.append(fn)
    with torch.no_grad():
        return encoder(lms, feat_len, blocks=blocks)


def folded_path(api, wav64, len64, audio, lens, dev, card):
    """Phase 10: the EffB2 encoders walked on folded weights, stride-1
    blocks through the MBConv kernel -> (launches, max |diff|, inputs of
    the stride-1 blocks, lms, feat_len)."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.hf_api import pad_bucket
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.models.effb2 import build_pruned_effb2
    from audiocaption_tpu_torch.ops import fused_mbconv as FM
    model, enc = api.model, api.model.encoder
    pruned = build_pruned_effb2(enc, prune_ratio=0.3, prune_head=False)
    with torch.no_grad():
        lms = model.frontend(wav64)
        feat_len = model.mel.feat_len(len64)
        ref = enc(lms, feat_len)
        pruned_ref = pruned(lms, feat_len)
        wav8 = torch.from_numpy(pad_bucket(audio, SR)).to(dev)
        len8 = torch.from_numpy(lens).to(dev)
        lms8, feat8 = model.frontend(wav8), model.mel.feat_len(len8)
        ref8 = enc(lms8, feat8)
    torch.cuda.synchronize()

    FM.fused_mbconv_s1.launches = 0
    errs, inputs, pruned_errs = [], [], []
    got = checked_walk(enc, lms, feat_len, errs, inputs)
    got8 = checked_walk(enc, lms8, feat8, [])
    got_pruned = checked_walk(pruned, lms, feat_len, pruned_errs)
    torch.cuda.synchronize()
    launches = FM.fused_mbconv_s1.launches
    log(f"folded-path launches: fused_mbconv {launches}")
    assert launches > 0, "the MBConv kernel was not launched"

    for name, e in (("flagship", errs), ("pruned 0.3", pruned_errs)):
        rel = [d / max(1.0, m) for d, m in e]
        log(f"MBConv kernel vs plain, {name} EffB2, {len(e)} stride-1 blocks "
            f"at B={lms.shape[0]} x 10 s: max |diff| per block "
            f"{[f'{d:.3g}' for d, _ in e]}, max relative {max(rel):.3g} "
            f"(limit {MBCONV_RTOL}) on {card}")
        assert len(e) == 19 and max(rel) <= MBCONV_RTOL, \
            f"MBConv kernel disagrees ({name})"
    for name, a, b in (("flagship", got, ref), ("pruned", got_pruned,
                                                pruned_ref),
                       ("flagship, 8 clips", got8, ref8)):
        err = float((a["attn_emb"] - b["attn_emb"]).abs().max())
        scale = float(b["attn_emb"].abs().max())
        log(f"walked encoder ({name}) vs cuDNN encoder: attn_emb "
            f"{tuple(a['attn_emb'].shape)} max |diff| {err:.3g}, max |ref| "
            f"{scale:.3g} (limit {ENCODER_RTOL} relative)")
        assert scale > 0.1 and err <= ENCODER_RTOL * scale, \
            f"walked encoder disagrees ({name})"
    for method in ("greedy", "beam"):
        ids = {}
        for name, e in (("walked", got8), ("cuDNN", ref8)):
            ids[name] = generate(model, enc=e, sample_method=method,
                                 beam_size=3, max_length=L)["seq"]
        ids = {k: v.cpu().numpy() for k, v in ids.items()}
        mis = int((ids["walked"] != ids["cuDNN"]).sum())
        log(f"captions from the walked vs cuDNN encoder, {method}: "
            f"{mis}/{ids['cuDNN'].size} tokens differ; "
            f"{len(np.unique(ids['cuDNN']))} distinct tokens; first caption "
            f"{ids['walked'][0][:8]} on {card}")
        assert mis <= MISMATCH_LIMIT * ids["cuDNN"].size, \
            f"{method} captions disagree"
    return launches, max(d for d, _ in errs), inputs, lms, feat_len


def mbconv_times(api, inputs, lms, feat_len, card):
    """Phase 11: per stride-1 block and summed over the 19, at B=64 x 10 s:
    the kernel, ``mbconv_plain``, the cuDNN block and the bound; the walked
    encoder against the cuDNN encoder."""
    import torch
    from audiocaption_tpu_torch.ops import fused_mbconv as FM
    enc = api.model.encoder
    blocks = [b for b in enc._blocks if b.plan["stride"] == 1]
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0, fp32=0.0, mm=0,
               other=0, nbytes=0)
    with torch.no_grad():
        for block, x in zip(blocks, inputs):
            spec, weights = FM.spec_of(block), FM.pack_mbconv(block)
            k_ms = cuda_ms(lambda: FM.fused_mbconv_s1(x, weights, spec), 10)
            p_ms = cuda_ms(lambda: FM.mbconv_plain(x, weights, spec), 10)
            c_ms = cuda_ms(lambda: block(x), 10)
            mm, other, nbytes = mbconv_work(spec, x.shape[0], x.shape[2],
                                            x.shape[3],
                                            weights["w_ser"].shape[1])
            bound, fp32, by = mbconv_bound_ms(mm, other, nbytes)
            idx = list(enc._blocks).index(block)
            plan = FM.plan_tiles(spec, x.shape[0], x.shape[2], x.shape[3])
            split = device_split(lambda: FM.fused_mbconv_s1(x, weights,
                                                             spec))
            log(f"fused_mbconv block {idx} {tuple(x.shape)} E={spec.exp_ch} "
                f"k={spec.kernel}: {k_ms:.4f} ms (plain {p_ms:.4f}, cuDNN "
                f"block {c_ms:.4f}, bound {bound:.4f} ms by {by}, float32-"
                f"only bound {fp32:.4f} ms: {nbytes} bytes, {mm} 1x1 ops, "
                f"{other} other ops; plan {tuple(plan)}; device ms by "
                f"launch {split})")
            for key, v in (("ms", k_ms), ("plain", p_ms), ("lib", c_ms),
                           ("bound", bound), ("fp32", fp32), ("mm", mm),
                           ("other", other), ("nbytes", nbytes)):
                tot[key] += v
        folded = FM.folded_blocks(enc)
        plain = FM.folded_blocks(enc, kernel=False)
        walk_ms = cuda_ms(lambda: enc(lms, feat_len, blocks=folded), 5)
        plain_walk_ms = cuda_ms(lambda: enc(lms, feat_len, blocks=plain), 5)
        cudnn_ms = cuda_ms(lambda: enc(lms, feat_len), 5)
    B = lms.shape[0]
    _, _, by = mbconv_bound_ms(tot["mm"], tot["other"], tot["nbytes"])
    log(f"fused_mbconv, 19 stride-1 blocks summed, B={B} x 10 s: "
        f"{tot['ms']:.3f} ms (plain {tot['plain']:.3f}, cuDNN blocks "
        f"{tot['lib']:.3f}, bound {tot['bound']:.4f} ms, float32-only "
        f"bound {tot['fp32']:.4f} ms; {tot['mm']} 1x1 ops, {tot['other']} "
        f"other ops, {tot['nbytes']} bytes) on {card}")
    log(f"EffB2 encoder, B={B} x 10 s log-mel in: walked with the "
        f"kernel {walk_ms:.3f} ms, walked all plain {plain_walk_ms:.3f} ms, "
        f"cuDNN modules {cudnn_ms:.3f} ms on {card}")
    return {"ms": tot["ms"], "plain_ms": tot["plain"],
            "library_ms": tot["lib"], "bound_ms": tot["bound"],
            "bound_by": by}


def decode_times(packed, memkv, valid, g_kernel, beams, launches,
                 greedy_err, score_err, card):
    """Phase 6: each decode kernel warm and with a cold L2, its device time
    (torch.profiler), its plain version, its bound from this run's inputs
    (operations at the float32 / FP64 tensor-core peak, the 3xTF32 figure
    beside it), both cluster sizes, wider beams, one-sample latency, the
    phase trace of a step and the cost of one cluster exchange and sync ->
    the decode kernels' JSON entries."""
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG

    inputs = {B_KERNEL: (memkv, valid),
              1: (memkv[:, :, :1].contiguous(), valid[:1].contiguous())}

    def greedy(B=B_KERNEL, C=None):
        if C is None:
            return FG.fused_greedy_decode(packed, *inputs[B], L)
        out = torch.empty(B, L, dtype=torch.int32, device=memkv.device)
        return FG.launch_decode("fused_greedy", packed, *inputs[B], L, 1,
                                out, None, 1, 2, 0, C)

    def beam(K=3, B=B_KERNEL, C=None):
        if C is None:
            return FB.fused_beam_decode(packed, *inputs[B], L, K)
        seq = torch.empty(B, K, L, dtype=torch.int32, device=memkv.device)
        score = torch.empty(B, K, device=memkv.device)
        return FG.launch_decode("fused_beam", packed, *inputs[B], L, K, seq,
                                score, 1, 2, 0, C)

    s_valid = valid.sum(1).tolist()
    eos_pos = [(row == 2).nonzero() for row in g_kernel.cpu()]
    g_steps = [int(p[0]) + 1 if len(p) else L for p in eos_pos]
    work = {"fused_greedy": decode_flops(E, FFN, V, s_valid, g_steps, 1)}
    work["fused_beam"] = decode_flops(E, FFN, V, s_valid,
                                      beams[3]["steps"].tolist(), 3)
    nbytes = {"fused_greedy": input_bytes(packed, memkv, valid,
                                          g_kernel.numel() * 4),
              "fused_beam": input_bytes(packed, memkv, valid,
                                        beams[3]["seq"].numel() * 4
                                        + beams[3]["score"].numel() * 4)}
    fns = {"fused_greedy": (greedy, lambda: FG.fused_greedy_plain(
               packed, memkv, valid, L), greedy_err,
               "audiocaption_tpu/decoding/fused_greedy.py:209"),
           "fused_beam": (beam, lambda: FB.fused_beam_plain(
               packed, memkv, valid, L, 3), score_err,
               "audiocaption_tpu/decoding/fused_beam.py:126")}
    kernels = []
    for name, (fn, plain, err, replaces) in fns.items():
        fn()
        plan = (FG.fused_greedy_decode if name == "fused_greedy"
                else FB.fused_beam_decode).last_plan
        ms = cuda_ms(fn, 10)
        cold = cold_ms(fn, 10)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        ms2 = cuda_ms(fn, 10)
        by_c = {C: cuda_ms(functools.partial(fn, C=C), 10) for C in (16, 8)}
        one = cuda_ms(functools.partial(fn, B=1), 10)
        split = device_split(fn)
        trace = FG.trace_phases(name, packed, memkv, valid, L,
                                1 if name == "fused_greedy" else 3)
        log(f"{name} phase trace (us per step, mean of {trace.shape[0]} "
            f"steps; slots in csrc/decoder_common.cuh::stamp): "
            f"{[round(v, 2) for v in trace.mean(0).tolist()]}, step "
            f"{float(trace.sum(1).mean()):.2f}")
        mm, attn = work[name]
        bound, tf32x3, by = decode_bound_ms(mm, attn, nbytes[name])
        log(f"{name}: {ms:.4f} ms/call warm (again {ms2:.4f}), {cold:.4f} "
            f"ms with the L2 cold (64 MB written before each call); by "
            f"cluster size {by_c}; B=1 {one:.4f} ms; device ms by kernel "
            f"{split}; plain {plain_ms:.3f} ms; bound {bound:.4f} ms by {by} "
            f"(3xTF32 products {tf32x3:.4f}: {nbytes[name]} bytes, {mm} product "
            f"ops, {attn} attention ops); plan {plan}; B={B_KERNEL} "
            f"S={S_KERNEL} L={L}" + (" beam 3" if name == "fused_beam" else "")
            + f" on {card}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"audiocaption_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None})
    for C in (8, 16):
        resident = FG.max_clusters_on_card("fused_beam")(
            C, FB.fused_beam_decode.last_plan.smem)
        log(f"one cluster exchange and sync, C={C}: " + ", ".join(
            f"{16 * n4} bytes to each peer {FG.cluster_sync_ns(C, n4):.0f} ns"
            for n4 in (0, 16, 64, 256)) + f"; {resident} clusters of {C} "
            f"resident at once on {card}")
    for K in BEAMS[1:]:
        k_ms = cuda_ms(functools.partial(beam, K), 5)
        log(f"fused_beam, beam {K}: {k_ms:.4f} ms/call (plan "
            f"{FB.fused_beam_decode.last_plan}) B={B_KERNEL} on {card}")
    return kernels


def bf16_kernels(packed, memkv, valid, card):
    """Phase 12: the bf16 modes of the decode kernels against their plain
    versions in the same mode, flagship width, B=64, S=31, L=20 ->
    {name: dict(err, plain inputs ...)} for the JSON line and phase 15."""
    import dataclasses
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    mk16 = memkv.to(torch.bfloat16)
    out = {}
    g = FG.fused_greedy_decode(packed, mk16, valid, L, cache_bf16=True)
    gp = FG.fused_greedy_plain(packed, mk16, valid, L, cache_bf16=True)
    torch.cuda.synchronize()
    mis = int((g != gp).sum())
    log(f"fused_greedy[cache_bf16] vs plain, B={B_KERNEL} S={S_KERNEL} L={L} "
        f"V={V}: {mis}/{g.numel()} tokens differ (plan "
        f"{FG.fused_greedy_decode.last_plan}) on {card}")
    assert mis <= MISMATCH_LIMIT * g.numel(), "greedy cache_bf16 disagrees"
    assert len(torch.unique(gp)) > 10, "degenerate greedy trajectories"
    out["fused_greedy[cache_bf16]"] = dict(err=float((g - gp).abs().max()),
                                           seq=g, mem=mk16, cache_bf16=True,
                                           weights_bf16=False)
    for K in BEAMS:
        seq, score = FB.fused_beam_decode(packed, mk16, valid, L, K,
                                          cache_bf16=True)
        steps = torch.zeros(B_KERNEL, dtype=torch.long, device=memkv.device)
        p_seq, p_score = FB.fused_beam_plain(packed, mk16, valid, L, K,
                                             steps=steps, cache_bf16=True)
        torch.cuda.synchronize()
        mis = int((seq != p_seq).sum())
        same = (seq == p_seq).all(-1)
        err = float((score[same] - p_score[same]).abs().max())
        log(f"fused_beam[cache_bf16] beam {K} vs plain: {mis}/{seq.numel()} "
            f"tokens differ, max |score diff| on matching sequences "
            f"{err:.3g} (plan {FB.fused_beam_decode.last_plan}) on {card}")
        assert mis <= MISMATCH_LIMIT * seq.numel(), \
            f"beam-{K} cache_bf16 disagrees"
        assert err <= SCORE_ATOL or float64_floor_check(
            packed, mk16, valid, K, seq, score, p_seq, p_score,
            cache_bf16=True), f"beam-{K} cache_bf16 scores disagree"
        if K == 3:
            out["fused_beam[cache_bf16]"] = dict(
                err=err, seq=seq, score=score, steps=steps, mem=mk16,
                cache_bf16=True, weights_bf16=False)

    # weights_bf16: every activation is rounded to bf16 at each product,
    # so a float32-level difference between two versions (here the bf16
    # mma's own float32 sums) flips a rounding now and then and the two
    # beams part ways.  Held: each kernel n-best score against the plain
    # version's float64 score of the kernel's own sequence.
    seq, score = FB.fused_beam_decode(packed, memkv, valid, L, 3,
                                      weights_bf16=True)
    steps = torch.zeros(B_KERNEL, dtype=torch.long, device=memkv.device)
    p_seq, p_score = FB.fused_beam_plain(packed, memkv, valid, L, 3,
                                         steps=steps, weights_bf16=True)
    p64 = dataclasses.replace(packed, **{
        k: getattr(packed, k).double() for k in ("emb", "cls", "pe",
                                                  "layers")})
    s64, sc64 = FB.fused_beam_plain(p64, memkv.double(), valid, L, 3,
                                    weights_bf16=True)
    rescored = FB.sequence_scores_plain(p64, memkv.double(), valid, seq,
                                        weights_bf16=True)
    torch.cuda.synchronize()
    real = score > -100               # not a -1000 beam filling a slot
    r_err = float((score[real].double() - rescored[real]).abs().max())
    mis = int((seq != p_seq).sum())
    same = (seq == p_seq).all(-1)
    err = float((score[same] - p_score[same]).abs().max())
    mis64 = int((p_seq != s64).sum())
    log(f"fused_beam[weights_bf16] beam 3 vs plain: {mis}/{seq.numel()} "
        f"tokens differ (the float32 plain version vs its float64 run: "
        f"{mis64}), max |score diff| on matching sequences {err:.3g}; "
        f"kernel scores vs the float64 plain version's scores of the "
        f"kernel's {int(real.sum())} sequences: max |diff| {r_err:.3g} "
        f"(limit {WEIGHTS_SCORE_ATOL}); best-beam mean score kernel "
        f"{float(score[:, 0].mean()):.4f}, plain "
        f"{float(p_score[:, 0].mean()):.4f}"
        f" (plan {FB.fused_beam_decode.last_plan}) on {card}")
    assert int(real.sum()) > 0 and r_err <= WEIGHTS_SCORE_ATOL, \
        "beam-3 weights_bf16 scores disagree with the model"
    out["fused_beam[weights_bf16]"] = dict(
        err=r_err, seq=seq, score=score, steps=steps, mem=memkv,
        cache_bf16=False, weights_bf16=True)
    return out


def same_weights(api, compute_dtype):
    """A second API of the same class and weights in ``compute_dtype``."""
    other = type(api)(api.config, seed=SEED, device="cuda",
                      compute_dtype=compute_dtype)
    other.model.load_state_dict(api.model.state_dict())
    return other


def bf16_effb2_path(api32, audio, lens, dev, card, rng):
    """Phase 13: ``Effb2TrmCaptioningModel(compute_dtype=bf16)`` end to end
    on 8 clips (greedy, beam 3, beam 5), the opt-in bf16-weight beam
    decoder (``FusedBeamDecoder(weights_bf16=True)`` on the float32
    model), and 16 clips through ``MicroBatchServer`` -> (api, launches
    by kernel and mode)."""
    import dataclasses
    import numpy as np
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.hf_api import pad_bucket
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.serving import MicroBatchServer, wire_decoder
    api = same_weights(api32, torch.bfloat16)
    wav = torch.from_numpy(pad_bucket(audio, SR)).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    FG.reset_launches(FG.fused_greedy_decode)
    FG.reset_launches(FB.fused_beam_decode)
    ids = {}
    for method, K in (("greedy", 3), ("beam", 3), ("beam", 5)):
        ids[method, K] = api(audio, lens, sample_method=method, beam_size=K,
                             max_length=L)
    fb_w = FB.FusedBeamDecoder(api32.model, max_length=L, beam_size=3,
                               device="cuda", weights_bf16=True)
    assert fb_w.weights_bf16 and not fb_w.cache_bf16
    w_seq, w_score = fb_w(wav, lens_t, n_best=True)

    clips = [(rng.randn(n) * 0.1).astype(np.float32)
             for n in rng.randint(SR, 10 * SR + 1, 16)]
    serve_fn = wire_decoder(functools.partial(
        api.decode, sample_method="beam", beam_size=3, max_length=L),
        "f32", device="cuda")
    with MicroBatchServer(serve_fn, max_batch=16, max_wait_ms=5000.0,
                          max_samples=10 * SR) as srv:
        futs = [srv.submit(c) for c in clips]
        served = np.stack([f.result(timeout=300) for f in futs])
        n_batches = srv.dispatched_batches
    batch = np.zeros((16, 10 * SR), np.float32)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    direct = serve_fn(batch, np.asarray([len(c) for c in clips],
                                        np.int32)).cpu().numpy()
    torch.cuda.synchronize()
    launches = {f"fused_greedy[{k}]": n for k, n in
                FG.fused_greedy_decode.mode_launches.items()}
    launches.update({f"fused_beam[{k}]": n for k, n in
                     FB.fused_beam_decode.mode_launches.items()})
    log(f"bf16 EffB2-path launches: {launches}")
    for name in ("fused_greedy[cache_bf16]", "fused_beam[cache_bf16]",
                 "fused_beam[weights_bf16]"):
        assert launches.get(name, 0) > 0, f"{name} was not launched"
    assert "fused_greedy[f32]" not in launches and \
        "fused_beam[f32]" not in launches, "a bf16 path ran a float32 kernel"
    log(f"bf16 serving: 16 clips in {n_batches} dispatch(es); "
        f"{int((served != direct).sum())} tokens differ from direct decode")
    assert n_batches == 1 and np.array_equal(served, direct)

    # held: the kernel path against the plain version in the same mode on
    # the same bf16 encoder output.  Printed: the bf16 and the float32
    # torch engines, and the float32 engine against the bf16 one.  The
    # fused decoders, as the JAX package's, run the decoder's products in
    # float32 on bf16 memory K/V and caches, where the bf16 engine rounds
    # every layer: two other functions, whose captions part at near ties.
    with torch.no_grad():
        enc = api.model.encode(wav, lens_t)
        memkv, mem_valid = FG.memory_kv(api.model.decoder, enc["attn_emb"],
                                        enc["attn_emb_len"], cache_bf16=True)
        packed = FG.pack_decoder_weights(api.model.decoder)
        plain = {("greedy", 3): FG.fused_greedy_plain(
            packed, memkv, mem_valid, L, cache_bf16=True)}
        for K in (3, 5):
            plain["beam", K] = FB.fused_beam_plain(
                packed, memkv, mem_valid, L, K, cache_bf16=True)[0][:, 0]
    for (method, K), got in ids.items():
        assert got.shape == (8, L) and ((got >= 0) & (got < V)).all()
        with torch.no_grad():
            ref16, ref32 = (generate(a.model, wav, lens_t, sample_method=method,
                                     beam_size=K, max_length=L)["seq"]
                            .cpu().numpy() for a in (api, api32))
        want = plain[method, K].cpu().numpy()
        mis = int((got != want).sum())
        log(f"bf16 end to end {method} {K}: kernel path vs plain version in "
            f"the same mode {mis}/{got.size} tokens differ (limit "
            f"{MISMATCH_LIMIT}); vs the bf16 torch engine "
            f"{int((got != ref16).sum())}, vs the float32 engine "
            f"{int((got != ref32).sum())}, float32 vs bf16 engine "
            f"{int((ref32 != ref16).sum())}; first caption {got[0][:8]} "
            f"on {card}")
        assert mis <= MISMATCH_LIMIT * got.size, \
            f"bf16 {method} {K} path disagrees"

    # the bf16-weight decoder: its n-best scores against the float64 plain
    # version's scores of its own sequences (see bf16_kernels)
    with torch.no_grad():
        enc32 = api32.model.encode(wav, lens_t)
        mem32, valid32 = FG.memory_kv(api32.model.decoder,
                                      enc32["attn_emb"], enc32["attn_emb_len"])
        p64 = dataclasses.replace(fb_w.packed, **{
            k: getattr(fb_w.packed, k).double()
            for k in ("emb", "cls", "pe", "layers")})
        rescored = FB.sequence_scores_plain(p64, mem32.double(), valid32,
                                            w_seq, weights_bf16=True)
        w_plain = FB.fused_beam_plain(fb_w.packed, mem32, valid32, L, 3,
                                      weights_bf16=True)[0]
    real = w_score > -100
    r_err = float((w_score[real].double() - rescored[real]).abs().max())
    log(f"bf16-weight beam 3 decoder on the float32 model: n-best scores vs "
        f"the float64 plain version's scores of its sequences max |diff| "
        f"{r_err:.3g} (limit {WEIGHTS_SCORE_ATOL}); "
        f"{int((w_seq != w_plain).sum())}/{w_seq.numel()} tokens differ "
        f"from the plain version in the same mode on {card}")
    assert int(real.sum()) > 0 and r_err <= WEIGHTS_SCORE_ATOL, \
        "the bf16-weight decoder's scores disagree with the model"
    return api, launches


def bf16_temporal_path(api32, dev, card, rng):
    """Phase 14: ``Cnn14RnnTempAttnGruModel(compute_dtype=bf16)`` end to
    end, kernel log-mel vs the same bf16 modules fed by the plain log-mel
    -> (api, log-mel launches)."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.hf_api import pad_bucket
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    api = same_weights(api32, torch.bfloat16)
    sr = SR_32K
    lens = np.asarray([10 * sr, 9 * sr, 7 * sr + 123, 5 * sr, 3 * sr + 7,
                       2 * sr, sr, sr + 4000])
    audio = (rng.randn(8, 10 * sr) * 0.1).astype(np.float32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    user_tag = np.asarray([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
    runs = [(m, t) for m in ("greedy", "beam") for t in (None, user_tag)]
    FL.fused_logmel.launches = 0
    out = {}
    for method, tag in runs:
        out[method, tag is None] = api(audio, lens, temporal_tag=tag,
                                       sample_method=method, beam_size=3,
                                       max_length=L)
    launches = FL.fused_logmel.launches
    log(f"bf16 temporal-path launches: fused_logmel {launches}")
    assert launches > 0, "the log-mel kernel was not launched"

    wav = torch.from_numpy(pad_bucket(audio, sr)).to(dev)
    front = api.model.cap_model.frontend
    lms_kernel = api.log_mel(wav)
    lms_plain = FL.fused_logmel_plain(wav, front.basis, front.mel_fb, api.mel)
    with torch.no_grad():
        fw_k = api.model.sed_model(lms_kernel)["framewise_output"]
        fw_p = api.model.sed_model(lms_plain)["framewise_output"]
        fw_32 = api32.model.sed_model(lms_kernel)["framewise_output"]
    sed_err = float((fw_k - fw_p).abs().max())
    sed_floor = float((fw_k - fw_32).abs().max())
    log(f"bf16 temporal path: SED framewise, kernel vs plain log-mel max "
        f"|diff| {sed_err:.3g} (limit {SED_ATOL}, or the float32-vs-bf16 "
        f"gap {sed_floor:.3g}) on {card}")
    assert sed_err <= max(SED_ATOL, sed_floor), "bf16 SED output disagrees"
    for (method, no_tag), ids in out.items():
        tag = None if no_tag else user_tag
        assert ids.shape == (8, L) and ((ids >= 0) & (ids < V)).all()
        ref = api.decode_lms(lms_plain, lens, tag, sample_method=method,
                             beam_size=3, max_length=L).cpu().numpy()
        ref32 = api32.decode_lms(lms_kernel, lens, tag, sample_method=method,
                                 beam_size=3, max_length=L).cpu().numpy()
        mis, floor = int((ids != ref).sum()), int((ids != ref32).sum())
        log(f"bf16 temporal end to end {method}, "
            f"{'SED tag' if no_tag else 'user tag'}: kernel vs plain log-mel "
            f"{mis}/{ids.size} tokens differ; float32 vs bf16 {floor}/"
            f"{ids.size}; first caption {ids[0][:8]} on {card}")
        assert mis <= max(MISMATCH_LIMIT * ids.size, floor), \
            f"bf16 temporal {method} path disagrees"
    return api, launches


def e2e_clips_per_s(decode, wav, lens, method, reps, warmup=True):
    """Clips/s of ``decode`` on a batch, greedy or beam 3, after a warm-up
    call unless ``warmup`` is False (a path whose host work dwarfs the
    first call's device set-up)."""
    import torch
    fn = functools.partial(decode, wav, lens, sample_method=method,
                           beam_size=3, max_length=L)
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    return wav.shape[0] / dt, dt * 1e3


def bf16_times(packed, memkv, valid, checks, f32_kernels, api16, api32,
               t_api16, t_api32, wav64, len64, launches, card):
    """Phase 15: each bf16 mode's kernel (warm, cold L2, B=1) beside the
    float32 kernel and its bound; bf16 clips/s of both models at B=64 x
    10 s beside float32; the bf16 EffB2 encode beside float32 -> JSON
    entries of the bf16 modes."""
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    f32_ms = {k["name"]: k["ms"] for k in f32_kernels}
    kernels = []
    for name, c in checks.items():
        base = name.split("[")[0]
        cache_bf16, weights_bf16 = c["cache_bf16"], c["weights_bf16"]
        mem = c["mem"]
        one = (mem[:, :, :1].contiguous(), valid[:1].contiguous())
        if base == "fused_greedy":
            def fn(m=mem, v=valid):
                return FG.fused_greedy_decode(packed, m, v, L,
                                              cache_bf16=cache_bf16)

            def plain():
                return FG.fused_greedy_plain(packed, mem, valid, L,
                                             cache_bf16=cache_bf16)
            seq = c["seq"]
            eos_pos = [(row == 2).nonzero() for row in seq.cpu()]
            steps = [int(p[0]) + 1 if len(p) else L for p in eos_pos]
            K, out_bytes = 1, seq.numel() * 4
        else:
            def fn(m=mem, v=valid):
                return FB.fused_beam_decode(packed, m, v, L, 3,
                                            cache_bf16=cache_bf16,
                                            weights_bf16=weights_bf16)

            def plain():
                return FB.fused_beam_plain(packed, mem, valid, L, 3,
                                           cache_bf16=cache_bf16,
                                           weights_bf16=weights_bf16)
            steps = c["steps"].tolist()
            K = 3
            out_bytes = c["seq"].numel() * 4 + c["score"].numel() * 4
        ms = cuda_ms(fn, 10)
        cold = cold_ms(fn, 10)
        b1 = cuda_ms(functools.partial(fn, *one), 10)
        plain_ms = cuda_ms(plain, 2, warmup=1)
        mm, attn = decode_flops(E, FFN, V, valid.sum(1).tolist(), steps, K)
        nbytes = input_bytes(packed, mem, valid, out_bytes, weights_bf16)
        bound, _, by = decode_bound_ms(
            mm, attn, nbytes, BF16_FLOPS if weights_bf16 else FP32_FLOPS)
        log(f"{name}: {ms:.4f} ms/call warm ({base} float32 "
            f"{f32_ms[base]:.4f}), {cold:.4f} ms with the L2 cold, B=1 "
            f"{b1:.4f} ms; plain {plain_ms:.3f} ms; bound {bound:.4f} ms by "
            f"{by} ({nbytes} bytes, {mm} product ops at "
            f"{'the bf16' if weights_bf16 else 'the FP64 / float32'} rate, "
            f"{attn} attention ops); B={B_KERNEL} S={S_KERNEL} L={L} on "
            f"{card}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"audiocaption_tpu_torch/csrc/{base}.cu",
            "replaces": ("audiocaption_tpu/decoding/fused_greedy.py:209"
                         if base == "fused_greedy" else
                         "audiocaption_tpu/decoding/fused_beam.py:126"),
            "launches": launches.get(name, 0),
            "max_abs_err": c["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None})

    with torch.no_grad():
        enc32 = cuda_ms(lambda: api32.model.encode(wav64, len64), 5)
        enc16 = cuda_ms(lambda: api16.model.encode(wav64, len64), 5)
    log(f"encode (log-mel + EffB2), B=64 x 10 s: bf16 {enc16:.2f} ms, "
        f"float32 {enc32:.2f} ms on {card}")
    for label, api in (("bf16", api16), ("float32", api32)):
        with torch.no_grad():
            split = device_split(lambda: api.model.encode(wav64, len64), 3)
        log(f"encode device ms by kernel, {label}: total "
            f"{sum(split.values()):.2f}; {dict(list(split.items())[:10])}")
    for method in ("greedy", "beam"):
        for label, api in (("bf16", api16), ("float32", api32)):
            cps, ms = e2e_clips_per_s(api.decode, wav64, len64, method, 5)
            log(f"EffB2 end to end {method}, {label}: {cps:.1f} clips/s "
                f"({ms:.2f} ms per batch of 64 x 10 s) on {card}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    wav = torch.randn(64, 10 * SR_32K, generator=gen, device="cuda") * 0.1
    lens = torch.full((64,), 10 * SR_32K, dtype=torch.long, device="cuda")

    def temporal(api):
        def decode(w, n, **kw):
            return api.decode_lms(api.log_mel(w), n, **kw)
        return decode
    for method in ("greedy", "beam"):
        for label, api in (("bf16", t_api16), ("float32", t_api32)):
            cps, ms = e2e_clips_per_s(temporal(api), wav, lens, method, 1,
                                      warmup=False)
            log(f"temporal end to end {method}, {label}: {cps:.1f} clips/s "
                f"({ms:.1f} ms per batch of 64 x 10 s) on {card}")
    return kernels


def train_batch(gen, cpu_gen, dev, subset, B, seconds, full: bool = False):
    """B device-made clips of ``seconds`` at 16 kHz (mixed lengths >= 1 s,
    the first full) and captions <bos> w ... <eos> of TRAIN_CAP_LEN tokens
    drawn from ``subset`` (padded to its upper end)."""
    import torch
    n = seconds * SR
    wav = torch.randn(B, n, generator=gen, device=dev) * 0.1
    wav_len = torch.randint(SR, n + 1, (B,), generator=cpu_gen)
    wav_len[0] = n
    if full:
        wav_len[:] = n
    lo, hi = TRAIN_CAP_LEN
    cap_len = torch.randint(lo, hi + 1, (B,), generator=cpu_gen)
    cap = torch.zeros(B, hi, dtype=torch.long)
    for i, c in enumerate(cap_len.tolist()):
        cap[i, 0], cap[i, c - 1] = 1, 2
        cap[i, 1:c - 1] = subset[torch.randint(len(subset), (c - 2,),
                                               generator=cpu_gen)]
    return {"wav": wav, "wav_len": wav_len.to(dev), "cap": cap.to(dev),
            "cap_len": cap_len.to(dev)}


def train_path(dev, card):
    """Phase 16: train the flagship (``zoo.effb2_trm(vocab_size=4981)``,
    random weights from a seed) with its recipe (label smoothing 0.1; Adam
    5e-4, L2 1e-6, clip 1.0; the exponential schedule, warm-up a fifth;
    dropout and drop-connect 0.2; scheduled sampling 1.0 -> 0.7) on a fixed
    device-made batch of TRAIN_B x TRAIN_SECONDS s: (a) the loss falls;
    (b) a NaN batch is skipped and changes nothing; (c) a checkpoint
    reloads into the HF API and decodes through the greedy kernel as
    through the torch engine; (d) the per-epoch val score over
    TRAIN_VAL_CLIPS clips launches the greedy kernel and decodes as the
    torch engine does; (e) SWA of two
    snapshots is their mean.  -> what phase 17 times, and the numbers."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli.run import ValScorer
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.hf_api import (
        Effb2TrmCaptioningModel, Effb2TrmConfig)
    from audiocaption_tpu_torch.losses.loss import masked_token_loss
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.models.zoo import effb2_trm, random_init
    from audiocaption_tpu_torch.optim.schedules import (
        exponential_decay_with_warmup)
    from audiocaption_tpu_torch.training.checkpoint import (
        load_checkpoint, model_variables, save_checkpoint)
    from audiocaption_tpu_torch.training.swa import swa_init, swa_update
    from audiocaption_tpu_torch.training.trainer import (
        create_train_state, train_step)

    model = effb2_trm(vocab_size=V)
    random_init(model, torch.Generator().manual_seed(SEED + 5))
    model.to(dev)
    state = create_train_state(
        model, 5e-4, exponential_decay_with_warmup(
            5e-4, 5e-7, TRAIN_STEPS, TRAIN_STEPS // 5), 1e-6, 1.0)
    loss_fn = masked_token_loss("label_smoothing", 0.1)
    cpu_gen = torch.Generator().manual_seed(SEED + 6)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    subset = 3 + torch.randperm(V - 3, generator=cpu_gen)[:TRAIN_WORDS]
    batch = train_batch(gen, cpu_gen, dev, subset, TRAIN_B, TRAIN_SECONDS)
    ss_gen = torch.Generator().manual_seed(SEED + 7)

    # (a) the loss on a fixed batch, ss_ratio 1.0 -> 0.7 per step
    t0 = time.perf_counter()
    losses, snaps = [], []
    for k in range(TRAIN_STEPS):
        ss = 1.0 - 0.3 * (k + 1) / TRAIN_STEPS
        m = train_step(state, loss_fn, batch, torch.tensor(ss), ss_gen)
        assert not m["skipped"], f"step {k} was skipped"
        losses.append(float(m["loss"]))
        if k + 1 in (TRAIN_STEPS // 2, TRAIN_STEPS):
            snaps.append({n: v.detach().clone()
                          for n, v in model.state_dict().items()})
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"train: {TRAIN_STEPS} steps on one batch of {TRAIN_B} x "
        f"{TRAIN_SECONDS} s in {time.perf_counter() - t0:.1f} s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}); lr count "
        f"{state.lr_count}; last raw grad norm {float(m['grad_norm']):.3f}")
    assert last <= (1 - TRAIN_LOSS_DROP) * first, "the loss did not fall"

    # (b) the NaN skip
    before = {n: v.clone() for n, v in model.state_dict().items()}
    opt_before = [{n: v.clone() for n, v in st.items()}
                  for st in state.optimizer.state.values()]
    count, lr = state.lr_count, state.optimizer.param_groups[0]["lr"]
    bad = dict(batch, wav=batch["wav"].clone())
    bad["wav"][TRAIN_B - 1, 1000] = float("nan")
    m = train_step(state, loss_fn, bad, torch.tensor(0.7), ss_gen)
    after = model.state_dict()
    same = (m["skipped"] and state.lr_count == count
            and state.optimizer.param_groups[0]["lr"] == lr
            and all(torch.equal(v, after[n]) for n, v in before.items())
            and all(torch.equal(v, st[n]) for b_, st in zip(
                opt_before, state.optimizer.state.values())
                for n, v in b_.items()))
    log(f"train: a NaN batch skipped {m['skipped']}; parameters, BN "
        f"buffers, Adam state and lr count unchanged: {same}")
    assert same, "the NaN skip changed the state"

    # (c) checkpoint -> HF API -> greedy kernel vs torch engine
    tok = DictTokenizer()
    for i in range(4, V):
        tok.add_word(f"w{i}")
    out_dir = ROOT / "build" / "train_smoke"
    save_checkpoint(str(out_dir / "last.pth"), model_variables(model),
                    epoch=1, lr_count=state.lr_count,
                    tokenizer_state=tok.state_dict())
    ckpt = load_checkpoint(str(out_dir / "last.pth"))
    api = Effb2TrmCaptioningModel(Effb2TrmConfig(vocab_size=V), device=dev)
    api.load_torch_state_dict(ckpt["variables"])
    rng = np.random.RandomState(SEED + 8)
    audio = (rng.randn(8, 10 * SR) * 0.1).astype(np.float32)
    lens = np.asarray([10 * SR, 9 * SR, 7 * SR + 123, 5 * SR, 3 * SR + 7,
                       2 * SR, 16000, 4000])
    FG.reset_launches(FG.fused_greedy_decode)
    ids = api(audio, lens, sample_method="greedy", max_length=L)
    api_launches = FG.fused_greedy_decode.launches
    ref = generate(api.model, torch.from_numpy(audio).to(dev),
                   torch.from_numpy(lens).to(dev), sample_method="greedy",
                   max_length=L)["seq"].cpu().numpy()
    mis = int((ids != ref).sum())
    log(f"train: checkpoint ({len(ckpt['variables'])} tensors) reloaded "
        f"into the API; greedy kernel ({api_launches} launch) vs torch "
        f"engine: {mis}/{ids.size} tokens differ; first caption "
        f"{ids[0][:8]}")
    assert api_launches > 0 or dev.type != "cuda"
    assert mis <= MISMATCH_LIMIT * ids.size, "reloaded checkpoint disagrees"

    # (d) the val score through the greedy kernel
    val = [batch] + [train_batch(gen, cpu_gen, dev, subset, TRAIN_B,
                                 TRAIN_SECONDS)
                     for _ in range(TRAIN_VAL_CLIPS // TRAIN_B - 1)]
    loader, refs = [], {}
    for j, vb in enumerate(val):
        keys = [f"clip{j * TRAIN_B + i}" for i in range(TRAIN_B)]
        caps = tok.decode(vb["cap"].cpu().numpy())
        refs.update({k: [c] for k, c in zip(keys, caps)})
        loader.append({"audio_id": keys, "wav": vb["wav"],
                       "wav_len": vb["wav_len"]})
    score_fn = ValScorer(model, tok, loader, refs, dev)
    FG.reset_launches(FG.fused_greedy_decode)
    _sync(dev)
    t0 = time.perf_counter()
    score = score_fn()
    _sync(dev)
    val_s = time.perf_counter() - t0
    val_launches = FG.fused_greedy_decode.launches
    # the tokens that call decoded, against the torch engine on the same
    # weights and batches
    model.eval()
    with torch.no_grad():
        val_ref = [generate(model, vb["wav"], vb["wav_len"],
                            sample_method="greedy",
                            max_length=model.special.max_length)["seq"]
                   .cpu().numpy() for vb in loader]
    model.train()
    val_mis = sum(int((a != r).sum())
                  for a, r in zip(score_fn.last_seq, val_ref))
    val_tokens = sum(r.size for r in val_ref)
    log(f"train: val score (greedy, CIDEr-D) over {len(refs)} clips "
        f"{score:.4f} in {val_s * 1e3:.1f} ms ({val_launches} greedy kernel "
        f"launches, batches of {TRAIN_B}); kernel vs torch engine: "
        f"{val_mis}/{val_tokens} tokens differ on {card}")
    assert np.isfinite(score) and score >= 0
    assert val_launches > 0 or dev.type != "cuda", \
        "the val score did not launch the greedy kernel"
    assert [a.shape for a in score_fn.last_seq] == [r.shape for r in val_ref]
    assert val_mis <= MISMATCH_LIMIT * val_tokens, \
        "the val score's greedy kernel disagrees with the torch engine"
    assert model.training
    # the kernel at the val score's shapes (TRAIN_B rows, the val batches'
    # valid memory) against its plain version, on phase 3's jittered
    # weights and random memory K/V, where greedy trajectories are far
    # from degenerate: the weights trained above end captions at once
    packed_j = jittered_decoder_inputs(dev)[0]
    kgen = torch.Generator().manual_seed(SEED + 9)
    k_mis = k_tokens = 0
    k_ids = []
    model.eval()
    with torch.no_grad():
        for vb in val:
            enc = model.encode(vb["wav"], vb["wav_len"])
            mem, mem_valid = FG.memory_kv(model.decoder, enc["attn_emb"],
                                          enc["attn_emb_len"], False)
            mem = torch.randn(mem.shape, generator=kgen).to(dev)
            got = FG.fused_greedy_decode(packed_j, mem, mem_valid, L)
            want = FG.fused_greedy_plain(packed_j, mem, mem_valid, L)
            k_mis += int((got != want).sum())
            k_tokens += want.numel()
            k_ids.append(want)
    model.train()
    k_distinct = len(torch.unique(torch.cat(k_ids)))
    log(f"train: greedy kernel vs plain at the val score's shapes (B="
        f"{TRAIN_B}, S={mem.shape[3]}, L={L}, jittered weights, random "
        f"memory): {k_mis}/{k_tokens} tokens differ, {k_distinct} distinct "
        f"(plan {getattr(FG.fused_greedy_decode, 'last_plan', None)})")
    assert k_mis <= MISMATCH_LIMIT * k_tokens, \
        "greedy kernel disagrees at the val score's shapes"
    assert k_distinct > 10, "degenerate greedy trajectories"

    # (e) SWA of two snapshots
    swa = swa_update(swa_update(swa_init(snaps[0]), snaps[0]), snaps[1])
    swa_err = max(float((swa[0][n] - (snaps[0][n] + snaps[1][n]) / 2)
                        .abs().max()) for n in snaps[0]
                  if snaps[0][n].is_floating_point())
    log(f"train: SWA of steps {TRAIN_STEPS // 2} and {TRAIN_STEPS}: max "
        f"|avg - mean| {swa_err:.3g}")
    assert swa[1] == 2 and swa_err <= SWA_ATOL, "SWA is not the mean"
    return dict(model=model, state=state, loss_fn=loss_fn, batch=batch,
                ss_gen=ss_gen, val_ms=val_s * 1e3, val_launches=val_launches)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def train_times(t, dev, card):
    """Phase 17: the median train step (TRAIN_TIMED steps after
    TRAIN_WARMUP) at the precision ``set_parity_precision`` sets, split by
    CUDA events into frontend + encoder forward, decoder forward (the SS
    loop, and the loss), backward (with the clip), optimizer; for the
    cached scheduled-sampling path, teacher forcing (``ss_ratio`` the float
    1.0) and the recompute oracle; the cached step's device time and idle
    share; clips/s, peak memory, model FLOPs per clip (3x the forward) and
    TFLOP/s."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from audiocaption_tpu_torch.models.captioner import ss_forward_recompute
    from audiocaption_tpu_torch.training.trainer import train_step
    model, state, batch = t["model"], t["state"], t["batch"]
    marks = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[name] = e

    def timed_loss(out):
        loss = t["loss_fn"](out)
        mark("decoder")
        return loss
    hooks = [model.encoder.register_forward_hook(
                 lambda *a: mark("encoder")),
             state.optimizer.register_step_pre_hook(
                 lambda *a: mark("backward"))]
    parts = ("encoder", "decoder", "backward", "end")
    ss = torch.tensor(0.85)
    results = {}
    try:
        for label, ratio, recompute in (("cached SS", ss, False),
                                        ("teacher forcing", 1.0, False),
                                        ("recompute SS", ss, True)):
            if recompute:
                model._ss_forward = functools.partial(ss_forward_recompute,
                                                      model)
            torch.cuda.reset_peak_memory_stats()
            rows = []
            for i in range(TRAIN_WARMUP + TRAIN_TIMED):
                mark("start")
                train_step(state, timed_loss, batch, ratio, t["ss_gen"])
                mark("end")
                torch.cuda.synchronize()
                prev, row = marks["start"], []
                for p in parts:
                    row.append(prev.elapsed_time(marks[p]))
                    prev = marks[p]
                rows.append(row)
            if recompute:
                del model._ss_forward
            rows = np.asarray(rows[TRAIN_WARMUP:])
            step = float(np.median(rows.sum(1)))
            split = dict(zip(("frontend+encoder fwd", "decoder fwd + loss",
                              "backward + clip", "optimizer"),
                             np.median(rows, 0).tolist()))
            results[label] = dict(step_ms=step, split=split,
                                  peak_gb=torch.cuda.max_memory_allocated()
                                  / 2 ** 30)
            log(f"train step, {label}: median {step:.2f} ms over "
                f"{TRAIN_TIMED} steps ({TRAIN_B / step * 1e3:.1f} clips/s; "
                f"split {', '.join(f'{k} {v:.2f}' for k, v in split.items())}"
                f" ms); peak memory {results[label]['peak_gb']:.2f} GiB; "
                f"B={TRAIN_B} x {TRAIN_SECONDS} s, float32, TF32 off, on "
                f"{card}")
    finally:
        for h in hooks:
            h.remove()
    clip_times(state.params, card, "train step")
    busy = device_split(lambda: train_step(state, t["loss_fn"], batch, ss,
                                           t["ss_gen"]), iters=3)
    total = sum(busy.values())
    step_ms = results["cached SS"]["step_ms"]
    log(f"train step, cached SS, device time (torch.profiler): {total:.2f} "
        f"ms a step of {step_ms:.2f} ms wall, idle share "
        f"{1 - total / step_ms:.3f}; top kernels "
        f"{dict(list(busy.items())[:8])} on {card}")
    model.train()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(batch["wav"], batch["wav_len"], batch["cap"], batch["cap_len"],
              ss, t["ss_gen"])
    fwd = fc.get_total_flops()
    log(f"train model FLOPs: forward {fwd / TRAIN_B / 1e9:.2f} GFLOP per "
        f"clip, training {3 * fwd / TRAIN_B / 1e9:.2f} GFLOP per clip (3x "
        f"the forward); achieved {3 * fwd / (step_ms * 1e-3) / 1e12:.2f} "
        f"TFLOP/s at {step_ms:.2f} ms a step (float32 non-tensor peak "
        f"{FP32_FLOPS / 1e12:.0f}) on {card}")
    log(f"train: val score {t['val_ms']:.1f} ms per {TRAIN_VAL_CLIPS} clips "
        f"on {card}")
    return results


def scst_batch(dev, gen, cpu_gen, B=None, seconds=None, sr=SR_32K):
    """B (SCST_B) device-made clips of ``seconds`` (SCST_SECONDS) at ``sr``
    (32 kHz), mixed lengths (each >= 1 s, the first full), each its own
    sound: noise at a level
    from 0.02 to 0.63, every other clip with a tone at its own pitch
    (100 Hz to 6.4 kHz), so that the encoder tells the clips apart and
    each clip's samples, and so its references, have words of their own
    (white noise alone gives every clip the same words, whose CIDEr-D
    weight is 0)."""
    import math
    import torch
    B, seconds = B or SCST_B, seconds or SCST_SECONDS
    n = seconds * sr
    t = torch.arange(n, device=dev) / sr
    freq = 100.0 * 2 ** (torch.arange(B, device=dev) / B * 6.0)
    level = 0.02 * 10 ** (torch.rand(B, generator=cpu_gen) * 1.5)
    tone = (torch.sin(2 * math.pi * freq[:, None] * t[None]) * 0.3
            * (torch.arange(B, device=dev)[:, None] % 2))
    wav = ((tone + torch.randn(B, n, generator=gen, device=dev))
           * level.to(dev)[:, None])
    wav_len = torch.randint(sr, n + 1, (B,), generator=cpu_gen)
    wav_len[0] = n
    return {"wav": wav, "wav_len": wav_len.to(dev)}


def calibrate_encoder_bn(model, batch) -> None:
    """Every encoder BN's running statistics from one batch (a random-init
    Cnn14 in ``eval()`` otherwise maps every clip to one output); each
    BN's momentum is kept."""
    import torch
    bns = [m for m in model.encoder.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None             # a cumulative average: one batch
    model.train()
    with torch.no_grad():
        model.encode(batch["wav"], batch["wav_len"])
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    model.eval()


def caption_words(seq, eos: int = 2):
    """Token ids -> the "w{id}" caption up to the first <eos>."""
    out = []
    for row in seq.tolist():
        words = []
        for w in row:
            if w == eos:
                break
            words.append(f"w{w}")
        out.append(" ".join(words))
    return out


def scst_path(api, audio, lens, dev, card):
    """Phase 18: SCST of ``zoo.cnn14rnn_trm(vocab_size=4368)`` at full width
    with the recipe of ``configs/synthetic_v2/scst.yaml`` through
    ``training/scst.py``, the greedy baseline through the greedy kernel
    (a ``FusedGreedyDecoder`` re-packed each step), on one device-made
    batch of SCST_B x SCST_SECONDS s at 32 kHz; then the new decode
    methods through phase 4's flagship API.  -> what phase 19 times, and
    the launch counts."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.hf_api import (
        Effb2TrmCaptioningModel, Effb2TrmConfig)
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.models.zoo import cnn14rnn_trm, random_init
    from audiocaption_tpu_torch.native import FastCiderD
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.optim.schedules import build_schedule
    from audiocaption_tpu_torch.training.checkpoint import model_variables
    from audiocaption_tpu_torch.training.scst import (
        apply_scst, scst_loss, scst_mode, scst_step)
    from audiocaption_tpu_torch.training.trainer import (
        bn_buffers, create_train_state)

    model = cnn14rnn_trm(vocab_size=SCST_V)
    gen_w = torch.Generator().manual_seed(SEED + 20)
    random_init(model, gen_w)
    with torch.no_grad():
        for p in model.decoder.parameters():
            if p.dim() == 2:
                p.add_(torch.randn(p.shape, generator=gen_w)
                       * SCST_DECODER_JITTER)
    model.to(dev)
    cpu_gen = torch.Generator().manual_seed(SEED + 21)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    batch = scst_batch(dev, gen, cpu_gen)
    calibrate_encoder_bn(model, batch)
    keys = [f"clip{i}" for i in range(SCST_B)]
    idx2word = {i: f"w{i}" for i in range(SCST_V)}
    # references: SCST_REFS of the model's own samples per clip
    ref_gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    refs = {k: [] for k in keys}
    with torch.no_grad():
        model.eval()
        enc = model.encode(batch["wav"], batch["wav_len"])
        for _ in range(SCST_REFS):
            seq = generate(model, enc=enc, sample_method="sample",
                           max_length=L, generator=ref_gen)["seq"].cpu()
            for k, c in zip(keys, caption_words(seq)):
                refs[k].append(c)
    schedule = build_schedule(
        {"type": "ExponentialDecayScheduler",
         "args": {"final_lrs": SCST_FINAL_LR}}, SCST_LR, SCST_STEPS,
        SCST_STEPS // 5)
    state = create_train_state(model, SCST_LR, schedule, SCST_WD, SCST_CLIP)
    baseline = FG.FusedGreedyDecoder(model, L, device=dev)
    scorer = FastCiderD()
    rl_gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    bn_before = [b.clone() for b in bn_buffers(model)]

    def engine_greedy():
        """The torch engine's greedy ids on the current weights (the
        comparison's log-mel launches are not the path's)."""
        n = FL.fused_logmel.launches
        with torch.no_grad():
            model.eval()
            out = generate(model, batch["wav"], batch["wav_len"],
                           sample_method="greedy", max_length=L)["seq"]
        FL.fused_logmel.launches = n
        return out

    # (a)-(c), (e): SCST_STEPS steps, the kernels' counts from this loop
    t0 = time.perf_counter()
    steps, baseline_mis = [], {}
    FG.reset_launches(FG.fused_greedy_decode)
    FL.fused_logmel.launches = 0
    for k in range(SCST_STEPS):
        check = k in (0, SCST_STEPS - 1)
        ref_greedy = engine_greedy() if check else None
        m = scst_step(state, batch, keys, refs, idx2word, max_length=L,
                      sample_temp=1.0, generator=rl_gen, scorer=scorer,
                      baseline=baseline)
        mask = m["mask"] > 0
        lp_err = float((m["token_logprob"] - m["sampled_logprob"])[mask]
                       .abs().max())
        n_adv = int((m["advantage"] != 0).sum())
        steps.append(dict(loss=m["loss"], reward=m["reward_sample"],
                          greedy_reward=m["reward_greedy"], lp_err=lp_err,
                          n_adv=n_adv))
        assert np.isfinite(m["loss"]), f"step {k}: loss {m['loss']}"
        assert n_adv > 0, f"step {k}: every advantage is 0"
        assert lp_err <= SCST_LOGPROB_ATOL, \
            f"step {k}: grad pass vs sampler log-probs {lp_err:.3g}"
        if check:
            mis = int((m["greedy"] != ref_greedy).sum())
            baseline_mis[k + 1] = mis
            assert mis <= MISMATCH_LIMIT * ref_greedy.numel(), \
                f"step {k + 1}: the kernel baseline disagrees ({mis})"
    _sync(dev)
    loop_s = time.perf_counter() - t0
    launches = {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}
    bn_same = all(torch.equal(a, b) for a, b in
                  zip(bn_before, bn_buffers(model)))
    first = np.mean([s["reward"] for s in steps[:5]])
    last = np.mean([s["reward"] for s in steps[-5:]])
    log(f"scst: {SCST_STEPS} steps of cnn14rnn_trm (V={SCST_V}, untied) on "
        f"one batch of {SCST_B} x {SCST_SECONDS} s at 32 kHz in "
        f"{loop_s:.1f} s; loss {steps[0]['loss']:.4f} -> "
        f"{steps[-1]['loss']:.4f}; mean sampled reward of the first 5 "
        f"steps {first:.4f}, of the last 5 {last:.4f}; greedy reward "
        f"{steps[0]['greedy_reward']:.4f} -> {steps[-1]['greedy_reward']:.4f}"
        f"; non-zero advantages per step "
        f"{min(s['n_adv'] for s in steps)}-{max(s['n_adv'] for s in steps)}"
        f" of {SCST_B}")
    log(f"scst (b): grad pass vs sampler log-probs on masked positions, "
        f"max over steps {max(s['lp_err'] for s in steps):.3g} (limit "
        f"{SCST_LOGPROB_ATOL}); BN running statistics bit-identical after "
        f"the steps: {bn_same}")
    assert bn_same, "SCST moved a BN running statistic"
    log(f"scst (c): kernel baseline vs torch engine greedy, steps 1 and "
        f"{SCST_STEPS}: {baseline_mis} of {SCST_B * L} tokens differ")
    log(f"scst (e): launches on the SCST path {launches}")
    assert dev.type != "cuda" or all(n > 0 for n in launches.values()), \
        "a kernel of the SCST path was not launched"

    # (c) the kernel against its plain version at the baseline's shapes
    # (SCST_B rows, V=4368 untied, the batch's valid memory) on jittered
    # weights and random memory K/V, where trajectories are far from
    # degenerate
    from audiocaption_tpu_torch.models.transformer_decoder import (
        TransformerDecoder)
    jgen = torch.Generator().manual_seed(SEED + 23)
    jdec = TransformerDecoder(E, SCST_V, 512, tie_weights=False)
    random_init(jdec, jgen)
    with torch.no_grad():
        for p in jdec.parameters():
            if p.dim() == 2:
                p.add_(torch.randn(p.shape, generator=jgen) * 0.3)
    jdec.to(dev).eval()
    packed_j = FG.pack_decoder_weights(jdec)
    n_g = FG.fused_greedy_decode.launches
    with torch.no_grad():
        mem, mem_valid = FG.memory_kv(model.decoder, enc["attn_emb"],
                                      enc["attn_emb_len"], False)
        mem = torch.randn(mem.shape, generator=jgen).to(dev)
        got = FG.fused_greedy_decode(packed_j, mem, mem_valid, L)
        want = FG.fused_greedy_plain(packed_j, mem, mem_valid, L)
    FG.fused_greedy_decode.launches = n_g
    k_mis = int((got != want).sum())
    k_distinct = len(torch.unique(want))
    greedy_err = float((got - want).abs().max())
    log(f"scst (c): greedy kernel vs plain at the baseline's shapes (B="
        f"{SCST_B}, S={mem.shape[3]}, V={SCST_V} untied, jittered weights, "
        f"random memory): {k_mis}/{want.numel()} tokens differ, "
        f"{k_distinct} distinct (plan {FG.fused_greedy_decode.last_plan})")
    assert k_mis <= MISMATCH_LIMIT * want.numel(), \
        "greedy kernel disagrees at the SCST shapes"
    assert k_distinct > 10, "degenerate greedy trajectories"

    # (d) learning direction: one fresh-Adam step lowers the loss
    # recomputed on the last step's own samples and advantages
    args = (batch["wav"], batch["wav_len"], m["sampled"], m["advantage"],
            m["mask"])
    named = dict(model.named_parameters())
    saved = {n: p.detach().clone() for n, p in named.items()}
    trainable = {n: p.requires_grad for n, p in named.items()}
    n_l = FL.fused_logmel.launches

    def probe_loss():
        with torch.no_grad(), scst_mode(model):
            return float(scst_loss(model, *args)[0])
    before = probe_loss()
    probes = {}
    for set_name, keep in SCST_PROBE_SETS.items():
        for lr in SCST_PROBE_LRS:
            for n, p in named.items():
                p.requires_grad_(trainable[n] and keep(n))
            probe = create_train_state(model, lr, lambda c, lr=lr: lr,
                                       SCST_WD, SCST_CLIP)
            pm = apply_scst(probe, *args)
            coef = min(1.0, SCST_CLIP / (float(pm["grad_norm"]) + 1e-6))
            with torch.no_grad():
                first = sum(float((p.grad.double() * (p - saved[n]).double())
                                  .sum()) for n, p in named.items()
                            if p.grad is not None) / coef
            after = probe_loss()
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(saved[n])
                    p.grad = None
            probes[set_name, lr] = (after - before, first)
            log(f"scst (d): one fresh-Adam step of the {set_name} at lr "
                f"{lr:g}: loss on the step's own samples and advantages "
                f"{before:.6f} -> {after:.6f} (change {after - before:.4g}; "
                f"first-order prediction g . dtheta {first:.4g}, ratio "
                f"{(after - before) / first:.4g})")
    for n, p in named.items():
        p.requires_grad_(trainable[n])
    FL.fused_logmel.launches = n_l
    low = SCST_PROBE_LRS[0]
    for (set_name, lr), (change, first) in probes.items():
        assert change < 0 or (set_name != "decoder" and lr != low), \
            f"an SCST step of the {set_name} at lr {lr:g} raised its loss"
        assert lr != low or abs(change / first - 1) <= SCST_FIRST_ORDER, \
            f"{set_name}: the loss change is not its first-order prediction"

    # (f) the new decode methods through phase 4's flagship API
    cpu_api = Effb2TrmCaptioningModel(Effb2TrmConfig(vocab_size=V),
                                      device="cpu")
    cpu_api.load_torch_state_dict(model_variables(api.model))
    for method in NEW_METHODS:
        ids = api(audio, lens, sample_method=method, beam_size=3,
                  max_length=L)
        shape = (len(audio), 3, L) if method == "dbs" else (len(audio), L)
        assert ids.shape == shape and ((ids >= 0) & (ids < V)).all(), \
            f"{method}: shape {ids.shape}"
        msg = f"scst (f): flagship API {method} on CUDA: shape {ids.shape}"
        if method == "dbs":
            ref = cpu_api(audio, lens, sample_method=method, beam_size=3,
                          max_length=L)
            mis = int((ids != ref).sum())
            msg += f"; vs a CPU copy of the model {mis}/{ids.size} differ"
            assert mis <= MISMATCH_LIMIT * ids.size, "dbs CUDA vs CPU"
        log(msg + f"; first caption {ids[0].reshape(-1)[:8]}")
    return dict(model=model, state=state, batch=batch, keys=keys,
                refs=refs, idx2word=idx2word, baseline=baseline,
                scorer=scorer, gen=rl_gen, launches=launches,
                greedy_err=greedy_err, loop_s=loop_s)


def scst_times(t, api, wav64, len64, card):
    """Phase 19: the SCST step (median of SCST_TIMED after SCST_WARMUP,
    float32, TF32 off) split by CUDA events into the sample pass (the
    baseline's repack, frontend + encode, the greedy kernel, the sampling
    loop), the host rewards, the grad pass (forward, backward, clip) and
    the optimizer; the repack alone; clips/s and peak memory; the device
    time and idle share (``torch.profiler``); the native scorer against
    the plain one on the batch's rewards; the flagship's "dbs" and
    "top0.9" through the API at B=64 x 10 s."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.metrics.cider import CiderD
    from audiocaption_tpu_torch.training.scst import (
        compute_batch_score, scst_step)
    marks = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[name] = e

    def step(mark_fn=None):
        return scst_step(t["state"], t["batch"], t["keys"], t["refs"],
                         t["idx2word"], max_length=L, sample_temp=1.0,
                         generator=t["gen"], scorer=t["scorer"],
                         baseline=t["baseline"], mark=mark_fn)
    parts = ("repack", "encode", "baseline", "sample", "rewards", "grad",
             "optimizer")
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(SCST_WARMUP + SCST_TIMED):
        mark("start")
        m = step(mark)
        torch.cuda.synchronize()
        prev, row = marks["start"], []
        for p in parts:
            row.append(prev.elapsed_time(marks[p]))
            prev = marks[p]
        rows.append(row)
    rows = np.asarray(rows[SCST_WARMUP:])
    step_ms = float(np.median(rows.sum(1)))
    split = dict(zip(parts, np.median(rows, 0).tolist()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sample_ms = sum(split[p] for p in parts[:4])
    log(f"scst step: median {step_ms:.2f} ms over {SCST_TIMED} steps "
        f"({SCST_B / step_ms * 1e3:.1f} clips/s); sample pass "
        f"{sample_ms:.2f} (repack {split['repack']:.2f}, frontend + encode "
        f"{split['encode']:.2f}, greedy kernel {split['baseline']:.2f}, "
        f"sampling loop {split['sample']:.2f}), host rewards "
        f"{split['rewards']:.2f}, grad pass (forward, backward, clip) "
        f"{split['grad']:.2f}, optimizer {split['optimizer']:.2f} ms; peak "
        f"memory {peak:.2f} GiB; B={SCST_B} x {SCST_SECONDS} s at 32 kHz, "
        f"float32, TF32 off, on {card}")
    clip_times(t["state"].params, card, "scst step")
    repack = cuda_ms(t["baseline"].refresh, 5)
    log(f"scst: FusedGreedyDecoder.refresh() alone {repack:.3f} ms on {card}")
    busy = device_split(step, iters=3)
    total = sum(busy.values())
    log(f"scst step, device time (torch.profiler): {total:.2f} ms a step of "
        f"{step_ms:.2f} ms wall, idle share {1 - total / step_ms:.3f}; top "
        f"kernels {dict(list(busy.items())[:8])} on {card}")
    sp = t["model"].special
    seqs = m["sampled"].cpu().numpy()
    times = {}
    scores = {}
    for name, scorer in (("native", t["scorer"]), ("python", None)):
        t0 = time.perf_counter()
        for _ in range(5):
            scores[name] = compute_batch_score(
                seqs, t["refs"], t["keys"], t["idx2word"], sp.bos, sp.eos,
                scorer if scorer is not None else CiderD())
        times[name] = (time.perf_counter() - t0) / 5 * 1e3
    err = float(np.abs(scores["native"] - scores["python"]).max())
    log(f"scst rewards of {SCST_B} sampled captions: native FastCiderD "
        f"{times['native']:.3f} ms, Python CiderD {times['python']:.3f} ms "
        f"(host clock, mean of 5), max |diff| {err:.3g}")
    assert err <= 1e-6 * max(1.0, float(np.abs(scores["python"]).max())), \
        "native and Python CIDEr-D disagree"
    # the greedy kernel at the baseline's shapes: this run's weights and
    # the batch's memory (the launches are not the path's)
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    model, batch = t["model"], t["batch"]
    packed = t["baseline"].packed
    n_g = FG.fused_greedy_decode.launches
    with torch.no_grad():
        model.eval()
        enc = model.encode(batch["wav"], batch["wav_len"])
        memkv, valid = FG.memory_kv(model.decoder, enc["attn_emb"],
                                    enc["attn_emb_len"], False)
        g = FG.fused_greedy_decode(packed, memkv, valid, L)
        k_ms = cuda_ms(lambda: FG.fused_greedy_decode(packed, memkv, valid,
                                                      L), 10)
        plain_ms = cuda_ms(lambda: FG.fused_greedy_plain(packed, memkv,
                                                         valid, L), 3, 1)
    FG.fused_greedy_decode.launches = n_g
    eos_pos = [(row == 2).nonzero() for row in g.cpu()]
    g_steps = [int(p_[0]) + 1 if len(p_) else L for p_ in eos_pos]
    mm, attn = decode_flops(E, FFN, SCST_V, valid.sum(1).tolist(), g_steps,
                            1)
    nbytes = input_bytes(packed, memkv, valid, g.numel() * 4)
    bound, _, by = decode_bound_ms(mm, attn, nbytes)
    log(f"fused_greedy at the SCST baseline's shapes (B={SCST_B}, S="
        f"{memkv.shape[3]}, V={SCST_V} untied, L={L}, steps per row "
        f"{min(g_steps)}-{max(g_steps)}): {k_ms:.4f} ms/call warm; plain "
        f"{plain_ms:.3f} ms; bound {bound:.4f} ms by {by} ({nbytes} bytes, "
        f"{mm} product ops, {attn} attention ops) on {card}")
    api_ms = {}
    for method in ("dbs", "top0.9"):
        def fn():
            return api.decode(wav64, len64, sample_method=method,
                              beam_size=3, max_length=L)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        api_ms[method] = (time.perf_counter() - t0) / 3 * 1e3
        log(f"flagship API {method}: {api_ms[method]:.2f} ms per batch of "
            f"64 x 10 s (torch engine) on {card}")
    return dict(step_ms=step_ms, split=split, repack_ms=repack, peak=peak,
                idle=1 - total / step_ms, api_ms=api_ms, greedy_ms=k_ms,
                greedy_bound_ms=bound)


@contextlib.contextmanager
def dropout_off(*models):
    """Every dropout of ``models`` at 0 inside the block (``nn.Dropout``
    modules and the float ``dropout`` rates the port's modules read),
    restored after."""
    import torch
    saved = []
    for model in models:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                saved.append((m, "p", m.p))
            elif isinstance(getattr(m, "dropout", None), float):
                saved.append((m, "dropout", m.dropout))
    for m, k, _ in saved:
        setattr(m, k, 0.0)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def kd_batch(dev, gen, cpu_gen, subset):
    """KD_B clips of KD_SECONDS at 32 kHz, each its own sound
    (``scst_batch``), with captions of TRAIN_CAP_LEN tokens from
    ``subset``."""
    import torch
    b = scst_batch(dev, gen, cpu_gen, KD_B, KD_SECONDS)
    lo, hi = TRAIN_CAP_LEN
    cap_len = torch.randint(lo, hi + 1, (KD_B,), generator=cpu_gen)
    cap = torch.zeros(KD_B, hi, dtype=torch.long)
    for i, c in enumerate(cap_len.tolist()):
        cap[i, 0], cap[i, c - 1] = 1, 2
        cap[i, 1:c - 1] = subset[torch.randint(len(subset), (c - 2,),
                                               generator=cpu_gen)]
    return dict(b, cap=cap.to(dev), cap_len=cap_len.to(dev))


def kd_path(dev, card):
    """Phase 20: knowledge distillation at the recipe of
    ``configs/synthetic_v2/kd_token.yaml``: the student
    ``zoo.kd_student_cdur5(vocab_size=4368)`` (random weights from a seed,
    its BN statistics calibrated on the batch) distilled from the teacher
    ``zoo.cnn14rnn_trm(vocab_size=4368)`` (random weights, decoder
    jittered by 0.15, BN calibrated) on one device-made batch of KD_B x
    KD_SECONDS s at 32 kHz, each clip its own sound, through
    ``training/distill.py``: KL at T=2 mixed 0.5 with label smoothing 0.1,
    Adam 5e-4, L2 1e-6, clip 1.0, the exponential schedule.  Checks (none
    caught): (a) the greedy kernel against its plain version at the
    student's shapes (E=128, 2 heads, FFN 512, one layer, V=4368 untied,
    S=250, B=KD_B; jittered weights, random memory K/V): at most 1% of
    tokens differ, one launch a call; (b) a token-KD step's loss and raw
    gradient norm on the card against the same step on a CPU copy of
    student, teacher and batch, dropout off in both (``dropout_off``):
    relative KD_STEP_RTOL; (c) KD_STEPS steps on the batch lower the KD
    loss (the mean of the last 5 below the first 5), 2 log-mel launches a
    step and no greedy launch; (d) seq KD: the teacher's pseudo captions
    (``generate_pseudo_captions``) through the greedy kernel against the
    torch engine's greedy tokens (at most 1% differ), and one train step
    of the student on them; (e) one encoder-KD step with captions and one
    without (``ContraEncoderKdHead``, the teacher's ``fc_emb`` on the
    fly) are finite, and the head's InfoNCE on the card lies within
    KD_NCE_ATOL of a CPU copy's; (f) ``ValScorer`` scores the student on
    KD_VAL_CLIPS clips through the greedy kernel (KD_VAL_CLIPS / KD_B
    launches), its tokens within 1% of the torch engine's.  The launch
    counts are set to 0 before (c) and read after (f); the comparisons'
    own launches are taken back out.  -> what phase 21 times."""
    import copy
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli.run import ValScorer
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.losses.kd import ContraEncoderKdHead
    from audiocaption_tpu_torch.losses.loss import masked_token_loss
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.models.transformer_decoder import (
        TransformerDecoder)
    from audiocaption_tpu_torch.models.zoo import (
        cnn14rnn_trm, kd_student_cdur5, random_init)
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.optim.schedules import build_schedule
    from audiocaption_tpu_torch.training.distill import (
        encoder_kd_step, generate_pseudo_captions, teacher_captions,
        teacher_embedding, teacher_logits, token_kd_step)
    from audiocaption_tpu_torch.training.trainer import (
        create_train_state, train_step)

    def schedule():
        return build_schedule(
            {"type": "ExponentialDecayScheduler",
             "args": {"final_lrs": KD_FINAL_LR}}, KD_LR, KD_STEPS,
            KD_STEPS // 5)

    def counts():
        return FL.fused_logmel.launches, FG.fused_greedy_decode.launches

    def restore(c):
        FL.fused_logmel.launches = c[0]
        FG.fused_greedy_decode.launches = c[1]

    gen_w = torch.Generator().manual_seed(SEED + 30)
    teacher = cnn14rnn_trm(vocab_size=KD_V)
    random_init(teacher, gen_w)
    with torch.no_grad():
        for p in teacher.decoder.parameters():
            if p.dim() == 2:
                p.add_(torch.randn(p.shape, generator=gen_w)
                       * SCST_DECODER_JITTER)
    student = kd_student_cdur5(vocab_size=KD_V)
    random_init(student, gen_w)
    teacher.to(dev)
    student.to(dev)
    cpu_gen = torch.Generator().manual_seed(SEED + 31)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    subset = 3 + torch.randperm(KD_V - 3, generator=cpu_gen)[:TRAIN_WORDS]
    batch = kd_batch(dev, gen, cpu_gen, subset)
    calibrate_encoder_bn(teacher, batch)
    calibrate_encoder_bn(student, batch)
    tok = DictTokenizer()
    for i in range(4, KD_V):
        tok.add_word(f"w{i}")
    keys = [f"clip{i}" for i in range(KD_B)]

    # (a) the kernel against its plain version at the student's shapes
    jgen = torch.Generator().manual_seed(SEED + 32)
    jdec = TransformerDecoder(128, KD_V, 256, nlayers=1, tie_weights=False)
    random_init(jdec, jgen)
    with torch.no_grad():
        for p in jdec.parameters():
            if p.dim() == 2:
                p.add_(torch.randn(p.shape, generator=jgen) * 0.3)
        jdec.to(dev).eval()
        packed = FG.pack_decoder_weights(jdec)
        c0 = counts()
        student.eval()
        enc = student.encode(batch["wav"], batch["wav_len"])
        memkv, valid = FG.memory_kv(student.decoder, enc["attn_emb"],
                                    enc["attn_emb_len"], False)
        memkv = torch.randn(memkv.shape, generator=jgen).to(dev)
        n_g = FG.fused_greedy_decode.launches
        got = FG.fused_greedy_decode(packed, memkv, valid, L)
        once = FG.fused_greedy_decode.launches - n_g
        want = FG.fused_greedy_plain(packed, memkv, valid, L)
        restore(c0)
    a_mis = int((got != want).sum())
    a_err = float((got - want).abs().max())
    a_distinct = len(torch.unique(want))
    log(f"kd (a): greedy kernel vs plain at the student's shapes (B={KD_B}, "
        f"E=128, 2 heads, FFN 512, 1 layer, V={KD_V} untied, S="
        f"{memkv.shape[3]}, L={L}, jittered weights, random memory): "
        f"{a_mis}/{want.numel()} tokens differ, {a_distinct} distinct, "
        f"{once} launch (plan {FG.fused_greedy_decode.last_plan})")
    assert memkv.shape == (1, 2, KD_B, KD_SECONDS * 25, 128), memkv.shape
    assert a_mis <= MISMATCH_LIMIT * want.numel(), \
        "greedy kernel disagrees at the student's shapes"
    assert a_distinct > 10, "degenerate greedy trajectories"
    assert once == (1 if dev.type == "cuda" else 0), once

    # (b) one token-KD step on the card against a CPU copy, dropout off
    cpu = torch.device("cpu")
    c0 = counts()
    got_b = {}
    for where, s_model, t_model in (
            ("card", copy.deepcopy(student), teacher),
            ("cpu", copy.deepcopy(student).to(cpu),
             copy.deepcopy(teacher).to(cpu))):
        d = next(s_model.parameters()).device
        st = create_train_state(s_model, KD_LR, schedule(), KD_WD, KD_CLIP)
        b = {k: v.to(d) for k, v in batch.items()}
        b["teacher_logit"] = teacher_logits(t_model, b)
        with dropout_off(s_model):
            got_b[where] = {k: float(v) for k, v in token_kd_step(
                st, b, KD_WEIGHT, "kl", KD_T, 0.1).items()}
    restore(c0)
    b_err = {k: abs(got_b["card"][k] / got_b["cpu"][k] - 1)
             for k in ("loss", "grad_norm")}
    log(f"kd (b): a token-KD step on the card {got_b['card']} vs on a CPU "
        f"copy {got_b['cpu']}: relative {b_err} (limit {KD_STEP_RTOL})")
    assert all(e <= KD_STEP_RTOL for e in b_err.values()), \
        "the token-KD step on the card disagrees with its CPU copy"

    # (c) KD_STEPS token-KD steps on the batch: the path's counts start
    state = create_train_state(student, KD_LR, schedule(), KD_WD, KD_CLIP)
    FL.fused_logmel.launches = 0
    FG.reset_launches(FG.fused_greedy_decode)
    t0 = time.perf_counter()
    steps = []
    for _ in range(KD_STEPS):
        b = dict(batch)
        b["teacher_logit"] = teacher_logits(teacher, b)
        m = token_kd_step(state, b, KD_WEIGHT, "kl", KD_T, 0.1)
        steps.append({k: float(v) for k, v in m.items()})
        assert np.isfinite(steps[-1]["loss"]), steps[-1]
    _sync(dev)
    loop_s = time.perf_counter() - t0
    c_counts = counts()
    first = np.mean([s_["kd_loss"] for s_ in steps[:5]])
    last = np.mean([s_["kd_loss"] for s_ in steps[-5:]])
    log(f"kd (c): {KD_STEPS} token-KD steps of the student (V={KD_V}) on one "
        f"batch of {KD_B} x {KD_SECONDS} s at 32 kHz in {loop_s:.1f} s; KD "
        f"loss (KL, T={KD_T}) mean of the first 5 {first:.4f}, of the last 5 "
        f"{last:.4f}; loss {steps[0]['loss']:.4f} -> {steps[-1]['loss']:.4f};"
        f" launches (log-mel, greedy) {c_counts}")
    assert last < first, "KD steps did not lower the KD loss"
    if dev.type == "cuda":
        assert c_counts == (2 * KD_STEPS, 0), c_counts

    # (d) seq KD: the teacher's pseudo captions through the greedy kernel
    fused = FG.FusedGreedyDecoder(teacher, L, device=dev)
    kernel_ids = []

    def teacher_generate(wav, wav_len):
        seq = teacher_captions(teacher, wav, wav_len, fused)
        kernel_ids.append(seq)
        return caption_words(seq.cpu())
    loader = [{"audio_id": keys, "wav": batch["wav"],
               "wav_len": batch["wav_len"]}]
    cache = generate_pseudo_captions(teacher_generate, loader)
    c0 = counts()
    engine = teacher_captions(teacher, batch["wav"], batch["wav_len"])
    restore(c0)
    d_mis = int((kernel_ids[0] != engine).sum())
    d_distinct = len(torch.unique(engine))
    enc_caps = tok([cache[k] for k in keys])
    b = dict(batch, cap=torch.as_tensor(enc_caps["cap"]).to(dev),
             cap_len=torch.as_tensor(enc_caps["cap_len"]).to(dev))
    seq_state = create_train_state(copy.deepcopy(student), KD_LR,
                                   schedule(), KD_WD, KD_CLIP)
    d_loss = float(train_step(seq_state, masked_token_loss(
        "label_smoothing", 0.1), b)["loss"])
    log(f"kd (d): seq KD pseudo captions of {len(cache)} clips through the "
        f"greedy kernel vs the torch engine: {d_mis}/{engine.numel()} "
        f"tokens differ ({d_distinct} distinct); first {cache[keys[0]][:60]!r}"
        f"; a train step on them: loss {d_loss:.4f}")
    assert len(cache) == KD_B and len(kernel_ids) == 1
    assert d_mis <= MISMATCH_LIMIT * engine.numel(), \
        "the teacher's pseudo captions disagree with the torch engine"
    assert np.isfinite(d_loss)

    # (e) encoder KD, with captions and without
    c0 = counts()
    tchr = teacher_embedding(teacher, batch["wav"], batch["wav_len"])
    restore(c0)
    head = ContraEncoderKdHead(256, tchr.shape[-1], KD_SHARED,
                               generator=torch.Generator().manual_seed(
                                   SEED + 33)).to(dev)
    e_student = copy.deepcopy(student)
    e_state = create_train_state(e_student, KD_LR, schedule(), KD_WD,
                                 KD_CLIP, head=head)
    e_losses = {}
    for unsup in (False, True):
        e_losses["unsup" if unsup else "sup"] = float(encoder_kd_step(
            e_state, head, dict(batch, tchr_emb=tchr), 1.0, 0.1,
            unsup=unsup)["loss"])
    c0 = counts()
    with torch.no_grad():
        e_student.eval()
        fc = e_student.encode(batch["wav"], batch["wav_len"])["fc_emb"]
        nce = float(head(fc, tchr))
        nce_cpu = float(copy.deepcopy(head).to(cpu)(fc.cpu(), tchr.cpu()))
    restore(c0)
    log(f"kd (e): encoder-KD steps {e_losses}; InfoNCE on the card {nce:.7f}"
        f", on a CPU copy {nce_cpu:.7f} (|diff| {abs(nce - nce_cpu):.3g}, "
        f"limit {KD_NCE_ATOL})")
    assert all(np.isfinite(v) for v in e_losses.values()), e_losses
    assert abs(nce - nce_cpu) <= KD_NCE_ATOL, "InfoNCE card vs CPU"

    # (f) the val score of the student through the greedy kernel
    val = [batch] + [kd_batch(dev, gen, cpu_gen, subset)
                     for _ in range(KD_VAL_CLIPS // KD_B - 1)]
    vloader, refs = [], {}
    for j, vb in enumerate(val):
        vkeys = [f"val{j * KD_B + i}" for i in range(KD_B)]
        refs.update({k: [c] for k, c in zip(vkeys, tok.decode(
            vb["cap"].cpu().numpy()))})
        vloader.append({"audio_id": vkeys, "wav": vb["wav"],
                        "wav_len": vb["wav_len"]})
    score_fn = ValScorer(student, tok, vloader, refs, dev)
    n_g = FG.fused_greedy_decode.launches
    _sync(dev)
    t0 = time.perf_counter()
    score = score_fn()
    _sync(dev)
    val_ms = (time.perf_counter() - t0) * 1e3
    val_launches = FG.fused_greedy_decode.launches - n_g
    launches = {"fused_logmel": FL.fused_logmel.launches,
                "fused_greedy": FG.fused_greedy_decode.launches}
    c0 = counts()
    student.eval()
    with torch.no_grad():
        val_ref = [generate(student, vb["wav"], vb["wav_len"],
                            sample_method="greedy", max_length=L)["seq"]
                   .cpu().numpy() for vb in vloader]
    student.train()
    restore(c0)
    val_mis = sum(int((a != r).sum())
                  for a, r in zip(score_fn.last_seq, val_ref))
    val_tokens = sum(r.size for r in val_ref)
    log(f"kd (f): the student's val score over {len(refs)} clips {score:.4f} "
        f"in {val_ms:.1f} ms ({val_launches} greedy kernel launches, "
        f"batches of {KD_B}); kernel vs torch engine {val_mis}/{val_tokens} "
        f"tokens differ on {card}")
    log(f"kd: launches on the KD path (c)-(f) {launches}")
    assert np.isfinite(score) and score >= 0
    assert val_mis <= MISMATCH_LIMIT * val_tokens, \
        "the student's val score disagrees with the torch engine"
    if dev.type == "cuda":
        assert val_launches == KD_VAL_CLIPS // KD_B, val_launches
        # (c) 2 a step; (d) the teacher's encode and the seq-KD step;
        # (e) the two encoder-KD steps; (f) one a val batch
        assert launches == {"fused_logmel": 2 * KD_STEPS + 4 + len(val),
                            "fused_greedy": 1 + len(val)}, launches
    return dict(student=student, teacher=teacher, state=state, batch=batch,
                packed=packed, memkv=memkv, valid=valid, greedy_err=a_err,
                score_fn=score_fn, val_ms=val_ms, val_launches=val_launches,
                launches=launches, loop_s=loop_s)


def kd_times(t, card):
    """Phase 21: the median token-KD step (KD_TIMED after KD_WARMUP,
    float32, TF32 off) split by CUDA events into the teacher's forward,
    the student's forward, the KD + supervised loss, the backward (with
    the clip) and the optimizer; KD clips/s, peak memory, the device time
    and idle share (``torch.profiler``); the greedy kernel at the
    student's shapes warm and with the L2 cold, its plain version and its
    bound; the val score per KD_VAL_CLIPS clips.  -> the kernel's JSON
    entry at the KD shapes."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.training.distill import (
        teacher_logits, token_kd_step)
    marks = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[name] = e

    def step(mark_fn=None):
        b = dict(t["batch"])
        b["teacher_logit"] = teacher_logits(t["teacher"], b)
        if mark_fn:
            mark_fn("teacher")
        return token_kd_step(t["state"], b, KD_WEIGHT, "kl", KD_T, 0.1,
                             mark=mark_fn)
    c0 = FL.fused_logmel.launches, FG.fused_greedy_decode.launches
    parts = ("teacher", "student", "loss", "backward", "optimizer")
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(KD_WARMUP + KD_TIMED):
        mark("start")
        step(mark)
        torch.cuda.synchronize()
        prev, row = marks["start"], []
        for p in parts:
            row.append(prev.elapsed_time(marks[p]))
            prev = marks[p]
        rows.append(row)
    rows = np.asarray(rows[KD_WARMUP:])
    step_ms = float(np.median(rows.sum(1)))
    split = dict(zip(parts, np.median(rows, 0).tolist()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"kd step: median {step_ms:.2f} ms over {KD_TIMED} steps "
        f"({KD_B / step_ms * 1e3:.1f} KD clips/s); teacher forward "
        f"{split['teacher']:.2f}, student forward {split['student']:.2f}, "
        f"KD + sup loss {split['loss']:.2f}, backward (with the clip) "
        f"{split['backward']:.2f}, optimizer {split['optimizer']:.2f} ms; "
        f"peak memory {peak:.2f} GiB; B={KD_B} x {KD_SECONDS} s at 32 kHz, "
        f"float32, TF32 off, on {card}")
    busy = device_split(step, iters=3)
    total = sum(busy.values())
    log(f"kd step, device time (torch.profiler): {total:.2f} ms a step of "
        f"{step_ms:.2f} ms wall, idle share {1 - total / step_ms:.3f}; top "
        f"kernels {dict(list(busy.items())[:8])} on {card}")
    entry = decode_entry("greedy", "kd_student", t["packed"], t["memkv"],
                         t["valid"], t["val_launches"], t["greedy_err"],
                         card)
    _sync(torch.device("cuda"))
    t0 = time.perf_counter()
    t["score_fn"]()
    _sync(torch.device("cuda"))
    val_ms = (time.perf_counter() - t0) * 1e3
    log(f"kd: the student's val score {val_ms:.1f} ms per {KD_VAL_CLIPS} "
        f"clips (first call {t['val_ms']:.1f} ms) on {card}")
    FL.fused_logmel.launches, FG.fused_greedy_decode.launches = c0
    return dict(step_ms=step_ms, split=split, peak=peak,
                idle=1 - total / step_ms, entry=entry)


@contextlib.contextmanager
def timed_scorers(spent: dict):
    """Inside the block, every scorer that ``metrics/eval.py::
    evaluate_captions`` calls (the PTB normalisation, BLEU, ROUGE-L,
    CIDEr-D, meteor_py, spice_py) adds its host seconds to ``spent``."""
    from audiocaption_tpu_torch.metrics import eval as ME
    names = ("ptb_tokenize", "corpus_bleu", "rouge_l", "meteor_py",
             "spice_py")
    saved = {n: getattr(ME, n) for n in names}
    cider = ME.CiderD

    def timed(key, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        return call

    class TimedCiderD(cider):
        def compute_score(self, *args, **kwargs):
            return timed("cider_d", super().compute_score)(*args, **kwargs)
    for n in names:
        setattr(ME, n, timed(n, saved[n]))
    ME.CiderD = TimedCiderD
    try:
        yield spent
    finally:
        for n in names:
            setattr(ME, n, saved[n])
        ME.CiderD = cider

def eval_model(name, dev, seed=None):
    """Family ``name``'s zoo model (random weights from ``seed``, the
    decoder's matrices jittered by SCST_DECODER_JITTER) on ``dev``."""
    import torch
    from audiocaption_tpu_torch.models.zoo import (
        cnn14rnn_trm, effb2_trm, kd_student_cdur5, random_init)
    fam = EVAL_FAMILIES[name]
    ctor = {"effb2_trm": effb2_trm, "cnn14rnn_trm": cnn14rnn_trm,
            "kd_student": kd_student_cdur5}[name]
    model = ctor(vocab_size=fam["vocab"])
    gen = torch.Generator().manual_seed(fam["seed"] if seed is None
                                        else seed)
    random_init(model, gen)
    with torch.no_grad():
        for p in model.decoder.parameters():
            if p.dim() == 2:
                p.add_(torch.randn(p.shape, generator=gen)
                       * SCST_DECODER_JITTER)
    return model.to(dev).eval()


def word_tokenizer(vocab: int):
    """A DictTokenizer whose id i >= 4 is the word "w{i}"."""
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    tok = DictTokenizer()
    for i in range(4, vocab):
        tok.add_word(f"w{i}")
    return tok


def write_wavs(directory, gen_seed: int):
    """EVAL_WAVS wav files through ``scipy.io.wavfile`` at 16, 32 and
    44.1 kHz in turn (16-bit and 32-bit PCM, float32, 8-bit unsigned, one
    stereo), 1-10 s, each its own tone over noise; the last 0.2 s long
    (skipped by the inference core)."""
    import numpy as np
    from scipy.io import wavfile
    rng = np.random.RandomState(gen_seed)
    rates = (16000, 32000, 44100)
    for i in range(EVAL_WAVS):
        sr = rates[i % 3]
        seconds = (0.2 if i == EVAL_WAVS - 1
                   else rng.uniform(*EVAL_WAV_SECONDS))
        t = np.arange(int(sr * seconds)) / sr
        x = (0.3 * np.sin(2 * np.pi * 100 * 2 ** (i / 3) * t)
             + rng.randn(len(t)) * 0.02 * (i + 1)) * 0.8
        kind = i % 5
        if kind == 0:
            data = (x * 32767).astype(np.int16)
        elif kind == 1:
            data = (x * 2 ** 31 * 0.9).astype(np.int32)
        elif kind == 2:
            data = x.astype(np.float32)
        elif kind == 3:
            data = (x * 127 + 128).clip(0, 255).astype(np.uint8)
        else:
            data = (np.stack([x, x * 0.5], 1) * 32767).astype(np.int16)
        wavfile.write(str(directory / f"clip{i:02d}.wav"), sr, data)


def eval_path(dev, card):
    """Phase 22: the evaluation path at full width.  Three experiments
    (``EVAL_FAMILIES``: the flagship ``zoo.effb2_trm``, V=4981 tied, 16
    kHz; ``zoo.cnn14rnn_trm`` and ``zoo.kd_student_cdur5``, V=4368, 32
    kHz), random weights from a seed, the decoder's matrices jittered by
    0.15 and the encoder's BN statistics calibrated on the first batch,
    written by ``save_checkpoint`` and read back through ``cli/run.py::
    experiment_model`` from the recipe's model node; EVAL_CLIPS
    device-made 10 s clips a family (each its own sound), decoded in
    batches of EVAL_B with beam 3 and max length 20 as
    ``configs/*/test.yaml`` does, through ``decoding/select.py::
    LoaderDecoder`` (the runner's decode).  Checks (none caught):
    (a) the runner's decode against ``generate`` beam 3 on the same
    weights, per family: at most 1% of tokens differ; (b) the beam kernel
    against ``fused_beam_plain`` at each family's shapes (the first
    batch's valid memory, random memory K/V): the plain search run in
    float64 on the same values, at most 1% of tokens differ, scores within
    SCORE_ATOL (the float32 plain version's own distance printed beside);
    (c) greedy ``inference_args`` through the greedy kernel against
    ``generate`` greedy for cnn14rnn_trm; (d) ``evaluate_captions`` of each
    family's predictions against EVAL_REFS of the model's own samples a
    clip: every key of the JAX package's result without Java, finite;
    ``skipped_scorers`` printed; (e) a two-member cnn14rnn_trm ensemble
    (seeds 1 and 2) through ``ensemble_generate`` beam 3 over the test set
    on the card, the dcase csv written and read back, and on
    EVAL_ENSEMBLE_CPU clips against the same call on CPU copies (at most
    1% of tokens differ); (f) ``export_hf_checkpoint`` of the flagship
    experiment loaded by ``Effb2TrmCaptioningModel.load_torch_checkpoint``
    decodes (a)'s tokens; (g) ``cli/inference.py::caption_files`` on
    EVAL_WAVS wav files at 16, 32 and 44.1 kHz (cnn14rnn_trm): the 0.2 s
    clip skipped, the captions equal to the runner's decode of the same
    resampled waves; (h) the launch counts, set to 0 before and read
    after, comparisons' launches taken back out: the beam kernel once a
    batch a family in (a), the greedy kernel once a batch in (c), the
    log-mel kernel once a 32 kHz batch.  -> what phase 23 times."""
    import copy
    import csv
    import tempfile
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli.inference import (
        caption_files, collect_inputs, load_waves)
    from audiocaption_tpu_torch.cli.run import (
        ensemble_decode_loader, experiment_model, export_hf_checkpoint,
        write_dcase_csv)
    from audiocaption_tpu_torch.data.collate import pad_sequences
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.decoding.ensemble import ensemble_generate
    from audiocaption_tpu_torch.decoding.select import LoaderDecoder
    from audiocaption_tpu_torch.hf_api import (
        Effb2TrmCaptioningModel, Effb2TrmConfig)
    from audiocaption_tpu_torch.metrics.eval import evaluate_captions
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.training.checkpoint import (
        load_checkpoint, model_variables, save_checkpoint)

    def counts():
        return (FB.fused_beam_decode.launches,
                FG.fused_greedy_decode.launches, FL.fused_logmel.launches)

    def restore(c):
        (FB.fused_beam_decode.launches, FG.fused_greedy_decode.launches,
         FL.fused_logmel.launches) = c

    def engine(model, loader, **args):
        """The torch engine's ids of every batch (a comparison: its
        log-mel launches are taken back out)."""
        c0 = counts()
        with torch.no_grad():
            out = [generate(model, b["wav"], b["wav_len"], **args)["seq"]
                   .cpu().numpy() for b in loader]
        restore(c0)
        return out

    def mismatch(got, want):
        return (sum(int((g != w).sum()) for g, w in zip(got, want)),
                sum(w.size for w in want))

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    FB.reset_launches(FB.fused_beam_decode)
    FG.reset_launches(FG.fused_greedy_decode)
    FL.fused_logmel.launches = 0
    t = {"families": {}, "beam_launches": {}, "scorer_s": {}, "scored": 0}
    cpu_gen = torch.Generator().manual_seed(SEED + 42)
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    for name, fam in EVAL_FAMILIES.items():
        tf0 = time.perf_counter()
        drawn = eval_model(name, dev)
        loader = []
        for j in range(EVAL_CLIPS // EVAL_B):
            b = scst_batch(dev, gen, cpu_gen, EVAL_B, EVAL_SECONDS, fam["sr"])
            b["audio_id"] = [f"{name}_{j * EVAL_B + i}"
                             for i in range(EVAL_B)]
            loader.append(b)
        c0 = counts()
        calibrate_encoder_bn(drawn, loader[0])
        restore(c0)
        tok = word_tokenizer(fam["vocab"])
        path = root / f"{name}.pth"
        save_checkpoint(str(path), model_variables(drawn), epoch=1,
                        tokenizer_state=tok.state_dict())
        model, exp_tok = experiment_model({"model": fam["node"]},
                                          load_checkpoint(str(path)), dev)
        same = model_variables(model)
        assert all(np.array_equal(v, same[k])
                   for k, v in model_variables(drawn).items()), name
        assert len(exp_tok) == fam["vocab"]
        del drawn

        # (a) the runner's decode, beam 3, against the torch engine
        decoder = LoaderDecoder(model, dev)
        n_b = FB.fused_beam_decode.launches
        key2pred = decoder.decode_loader(exp_tok, loader, **EVAL_ARGS)
        t["beam_launches"][name] = FB.fused_beam_decode.launches - n_b
        ids = decoder.last_seq
        a_mis, a_tok = mismatch(ids, engine(model, loader, **EVAL_ARGS))
        distinct = len(np.unique(np.concatenate(ids)))
        log(f"eval (a) {name}: the runner's beam-3 decode of {EVAL_CLIPS} "
            f"clips x {EVAL_SECONDS} s (batches of {EVAL_B}, "
            f"{t['beam_launches'][name]} beam kernel launches) vs the torch "
            f"engine: {a_mis}/{a_tok} tokens differ, {distinct} distinct; "
            f"first caption {key2pred[loader[0]['audio_id'][0]][0][:60]!r}")
        assert a_mis <= MISMATCH_LIMIT * a_tok, f"{name}: runner decode"
        if dev.type == "cuda":
            assert t["beam_launches"][name] == len(loader), name

        # (b) the beam kernel against its plain version at these shapes
        c0 = counts()
        with torch.no_grad():
            enc = model.encode(loader[0]["wav"], loader[0]["wav_len"])
            memkv, valid = FG.memory_kv(model.decoder, enc["attn_emb"],
                                        enc["attn_emb_len"], False)
        packed = FG.pack_decoder_weights(model.decoder).to(dev)
        bgen = torch.Generator().manual_seed(SEED + 43)
        memkv = torch.randn(memkv.shape, generator=bgen).to(dev)
        seq, score = FB.fused_beam_decode(packed, memkv, valid, L, 3)
        steps = torch.zeros(EVAL_B, dtype=torch.long, device=dev)
        p_seq, p_score = FB.fused_beam_plain(packed, memkv, valid, L, 3)
        p64 = packed_double(packed)
        s64, sc64 = FB.fused_beam_plain(p64, memkv.double(), valid, L, 3,
                                        steps=steps)
        restore(c0)
        b_mis = int((seq != s64).sum())
        shared = (seq == s64).all(-1)
        b_err = float((score[shared].double() - sc64[shared]).abs().max())
        p_same = (p_seq == s64).all(-1)
        p_err = float((p_score[p_same].double() - sc64[p_same]).abs().max())
        p_mis = int((p_seq != s64).sum())
        tied = packed.cls.data_ptr() == packed.emb.data_ptr()
        log(f"eval (b) {name}: beam kernel vs plain run in float64 at the "
            f"family's shapes (B={EVAL_B}, E={packed.emb_dim}, "
            f"{packed.nlayers} layer(s), S={memkv.shape[3]}, "
            f"V={packed.vocab_size} {'tied' if tied else 'untied'}, "
            f"the batch's valid memory, random memory K/V): {b_mis}/"
            f"{seq.numel()} tokens differ, max |score diff| on "
            f"{int(shared.sum())} matching sequences {b_err:.3g} (limit "
            f"{SCORE_ATOL}); the float32 plain version vs float64: {p_mis} "
            f"tokens, max {p_err:.3g}; {len(torch.unique(s64))} distinct "
            f"(plan {FB.fused_beam_decode.last_plan})")
        assert b_mis <= MISMATCH_LIMIT * seq.numel(), f"{name}: beam kernel"
        assert b_err <= SCORE_ATOL, f"{name}: beam kernel scores"
        assert len(torch.unique(s64)) > EVAL_DISTINCT, \
            "degenerate beam trajectories"

        # (c) greedy inference_args through the greedy kernel
        if name == "cnn14rnn_trm":
            n_g = FG.fused_greedy_decode.launches
            decoder.decode_loader(exp_tok, loader, sample_method="greedy",
                                  max_length=L)
            g_launches = FG.fused_greedy_decode.launches - n_g
            c_mis, c_tok = mismatch(decoder.last_seq, engine(
                model, loader, sample_method="greedy", max_length=L))
            log(f"eval (c) {name}: greedy through the greedy kernel "
                f"({g_launches} launches) vs the torch engine: "
                f"{c_mis}/{c_tok} tokens differ")
            assert c_mis <= MISMATCH_LIMIT * c_tok, "greedy decode"
            if dev.type == "cuda":
                assert g_launches == len(loader), g_launches

        # (d) the metric suite on the predictions
        c0 = counts()
        ref_gen = torch.Generator(device=dev).manual_seed(SEED + 44)
        refs = {}
        with torch.no_grad():
            for b in loader:
                enc = model.encode(b["wav"], b["wav_len"])
                for _ in range(EVAL_REFS):
                    s = generate(model, enc=enc, sample_method="sample",
                                 max_length=L, generator=ref_gen)["seq"]
                    for k, c in zip(b["audio_id"],
                                    exp_tok.decode(s.cpu().numpy())):
                        refs.setdefault(k, []).append(c)
        restore(c0)
        scored = list(key2pred)[:EVAL_SCORED]
        t0 = time.perf_counter()
        with timed_scorers(t["scorer_s"]):
            result = evaluate_captions({k: key2pred[k] for k in scored},
                                       {k: refs[k] for k in scored})
        d_s = time.perf_counter() - t0
        t["scored"] += len(scored)
        want_keys = {"bleu_1", "bleu_2", "bleu_3", "bleu_4", "rouge_l",
                     "cider", "meteor_py", "spice_py", "spider_py"}
        scores = {k: v for k, v in result.items() if isinstance(v, float)}
        log(f"eval (d) {name}: evaluate_captions of the first {len(scored)} "
            f"predictions against {EVAL_REFS} sampled references each in "
            f"{d_s:.2f} s: {scores}; skipped_scorers "
            f"{result.get('skipped_scorers')}")
        assert want_keys <= set(scores), sorted(scores)
        assert all(math.isfinite(v) for v in scores.values()), scores
        assert result.get("skipped_scorers"), "skipped scorers not reported"
        t["families"][name] = dict(model=model, tok=exp_tok, loader=loader,
                                   decoder=decoder, packed=packed,
                                   memkv=memkv, valid=valid, steps=steps,
                                   err=b_err, ids=ids, key2pred=key2pred,
                                   refs=refs, seconds=time.perf_counter()
                                   - tf0)

    # (e) a two-member cnn14rnn_trm ensemble
    fam = t["families"]["cnn14rnn_trm"]
    second = eval_model("cnn14rnn_trm", dev, seed=EVAL_ENSEMBLE_SEED)
    c0 = counts()
    calibrate_encoder_bn(second, fam["loader"][0])
    restore(c0)
    members = [fam["model"], second]
    n_l = FL.fused_logmel.launches
    ens = ensemble_decode_loader(members, fam["tok"], fam["loader"], dev,
                                 **EVAL_ARGS)
    ens_logmel = FL.fused_logmel.launches - n_l
    csv_path = root / "dcase_predictions.csv"
    write_dcase_csv(csv_path, ens)
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [(r["file_name"], r["caption_predicted"]) for r in rows] == [
        (k, v[0]) for k, v in ens.items()], "dcase csv read back"
    c0 = counts()
    b0 = fam["loader"][0]
    n = EVAL_ENSEMBLE_CPU
    card_seq = ensemble_generate(members, b0["wav"][:n], b0["wav_len"][:n],
                                 **EVAL_ARGS)["seq"].cpu()
    cpu_members = [copy.deepcopy(m).cpu() for m in members]
    cpu_seq = ensemble_generate(cpu_members, b0["wav"][:n].cpu(),
                                b0["wav_len"][:n].cpu(), **EVAL_ARGS)["seq"]
    restore(c0)
    e_mis = int((card_seq != cpu_seq).sum())
    differs = sum(ens[k] != fam["key2pred"][k] for k in ens)
    log(f"eval (e): ensemble of two cnn14rnn_trm (seeds 1, "
        f"{EVAL_ENSEMBLE_SEED}) over {len(ens)} clips on the card "
        f"({ens_logmel} log-mel launches; {differs} captions differ from "
        f"member 1 alone); dcase csv of {len(rows)} rows read back; card vs "
        f"CPU copies on {n} clips: {e_mis}/{cpu_seq.numel()} tokens differ")
    assert e_mis <= MISMATCH_LIMIT * cpu_seq.numel(), "ensemble card vs CPU"
    del cpu_members

    # (f) the flagship exported to the HF format, decoded by the API
    flag = t["families"]["effb2_trm"]
    hf_path = export_hf_checkpoint(flag["model"], str(root / "hf.bin"))
    api = Effb2TrmCaptioningModel(
        Effb2TrmConfig(vocab_size=EVAL_FAMILIES["effb2_trm"]["vocab"]),
        device=dev)
    api.load_torch_checkpoint(hf_path)
    f_ids = [api.decode(b["wav"], b["wav_len"], sample_method="beam",
                        beam_size=3, max_length=L).cpu().numpy()
             for b in flag["loader"]]
    f_same = all(np.array_equal(a, b) for a, b in zip(f_ids, flag["ids"]))
    log(f"eval (f): export_hf of the flagship -> {len(torch.load(hf_path))} "
        f"tensors; Effb2TrmCaptioningModel beam 3 from it equals (a)'s "
        f"tokens: {f_same}")
    assert f_same, "the exported checkpoint decodes differently"
    del api

    # (g) the inference core on wav files
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    write_wavs(wav_dir, SEED + 45)
    entries = collect_inputs(str(wav_dir))
    g_out = caption_files(fam["model"], fam["tok"], entries, dev, EVAL_B,
                          **EVAL_ARGS)
    ids_g, wavs_g = load_waves(entries, SR_32K)
    g_loader = []
    for i in range(0, len(wavs_g), EVAL_B):    # caption_files' batches
        padded, lens = pad_sequences(wavs_g[i:i + EVAL_B], bucket=SR_32K)
        g_loader.append({"audio_id": ids_g[i:i + EVAL_B], "wav": padded,
                         "wav_len": lens})
    g_ref = fam["decoder"].decode_loader(fam["tok"], g_loader, **EVAL_ARGS)
    g_diff = {k: (v, g_ref[k][0]) for k, v in g_out.items()
              if g_ref.get(k, [None])[0] != v}
    g_same = not g_diff and len(g_ref) == len(g_out)
    log(f"eval (g): caption_files on {len(entries)} wav files (16, 32, 44.1 "
        f"kHz) -> {len(g_out)} captions, the 0.2 s clip skipped; equal to "
        f"the runner's decode of the same resampled waves: {g_same} "
        f"{g_diff}")
    assert len(entries) == EVAL_WAVS and len(g_out) == EVAL_WAVS - 1
    assert f"clip{EVAL_WAVS - 1:02d}.wav" not in g_out and g_same

    # (h) the launches of the path
    launches = {"fused_beam": FB.fused_beam_decode.launches,
                "fused_greedy": FG.fused_greedy_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}
    batches = EVAL_CLIPS // EVAL_B
    # (a) a launch a batch a family, (f) the API's, (g) two single batches
    want = {"fused_beam": 3 * batches + batches + 2,
            "fused_greedy": batches,
            # (a) two 32 kHz families, (c), (e) two members, (g)
            "fused_logmel": 2 * batches + batches + 2 * batches + 2}
    log(f"eval (h): launches on the evaluation path {launches} (expected "
        f"{want}); beam launches by family {t['beam_launches']}")
    if dev.type == "cuda":
        assert launches == want, launches
    t.update(launches=launches, members=members, root=tmp)
    return t


def eval_times(t, dev, card):
    """Phase 23, float32, TF32 off: evaluation clips/s of each family at
    B=EVAL_B x 10 s, beam 3 (the median of EVAL_TIMED batches after
    EVAL_WARMUP of the runner's decode, tokenizer included), split by CUDA
    events into frontend + encode, memory K/V projection and the beam
    kernel, and the host work (ids to the host, tokenizer decode); the
    device idle share (``torch.profiler``); the beam kernel at the
    cnn14rnn_trm and KD-student shapes warm and with the L2 cold, its plain
    version and its bound (``decode_flops`` / ``decode_bound_ms``); the
    metric suite's host time per 1000 captions by scorer; the ensemble's
    torch-engine beam per batch.  -> the beam kernel's JSON entries at the
    two shapes."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.decoding.ensemble import ensemble_generate
    from audiocaption_tpu_torch.metrics.cider import CiderD
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    c0 = (FB.fused_beam_decode.launches, FG.fused_greedy_decode.launches,
          FL.fused_logmel.launches)
    out = {}
    for name, fam in t["families"].items():
        model, tok, b = fam["model"], fam["tok"], fam["loader"][0]
        loader = [b]
        packed = FG.pack_decoder_weights(model.decoder).to(dev)
        marks = {}

        def mark(key):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks[key] = e
        rows, walls = [], []
        for _ in range(EVAL_WARMUP + EVAL_TIMED):
            w0 = time.perf_counter()
            fam["decoder"].decode_loader(tok, loader, **EVAL_ARGS)
            walls.append(time.perf_counter() - w0)
            with torch.no_grad():
                mark("start")
                enc = model.encode(b["wav"], b["wav_len"])
                mark("encode")
                memkv, valid = FG.memory_kv(model.decoder, enc["attn_emb"],
                                            enc["attn_emb_len"], False)
                mark("memkv")
                seq, _ = FB.fused_beam_decode(packed, memkv, valid, L, 3)
                mark("beam")
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            tok.decode(seq[:, 0].cpu().numpy())
            host = (time.perf_counter() - h0) * 1e3
            rows.append([marks["start"].elapsed_time(marks["encode"]),
                         marks["encode"].elapsed_time(marks["memkv"]),
                         marks["memkv"].elapsed_time(marks["beam"]), host])
        rows = np.asarray(rows[EVAL_WARMUP:])
        wall = float(np.median(walls[EVAL_WARMUP:])) * 1e3
        split = dict(zip(("encode", "memkv", "beam", "host"),
                         np.median(rows, 0).tolist()))
        busy = device_split(lambda: fam["decoder"].decode_loader(
            tok, loader, **EVAL_ARGS), iters=3)
        total = sum(busy.values())
        out[name] = dict(wall=wall, split=split, idle=1 - total / wall,
                         clips_s=EVAL_B / wall * 1e3)
        log(f"eval times {name}: {EVAL_B / wall * 1e3:.1f} clips/s (the "
            f"runner's decode of a batch of {EVAL_B} x {EVAL_SECONDS} s, "
            f"beam 3, median of {EVAL_TIMED}: {wall:.2f} ms); split "
            f"frontend + encode {split['encode']:.3f}, memory K/V "
            f"{split['memkv']:.3f}, beam kernel {split['beam']:.3f}, host "
            f"(ids to host, tokenizer) {split['host']:.3f} ms; device "
            f"{total:.2f} ms a batch, idle share {1 - total / wall:.3f}; top "
            f"kernels {dict(list(busy.items())[:6])} on {card}")

    entries = []
    for name in ("cnn14rnn_trm", "kd_student"):
        fam = t["families"][name]
        entries.append(decode_entry(
            "beam", name, fam["packed"], fam["memkv"], fam["valid"],
            t["beam_launches"][name], fam["err"], card,
            steps=fam["steps"].tolist()))

    # the metric suite's host time, by scorer, inside (d)'s calls
    per_1000 = {k: v * 1e3 / t["scored"] * 1000
                for k, v in t["scorer_s"].items()}
    log(f"metric suite host time, ms per 1000 captions (from phase 22 (d): "
        f"{t['scored']} captions, {EVAL_REFS} references each): "
        f"{ {k: round(v, 1) for k, v in per_1000.items()} } on the host "
        f"beside {card}")

    # the ensemble's torch-engine beam
    b = t["families"]["cnn14rnn_trm"]["loader"][0]

    def ens():
        return ensemble_generate(t["members"], b["wav"], b["wav_len"],
                                 **EVAL_ARGS)["seq"]
    ens_ms = []
    for _ in range(1 + 3):
        _sync(dev)
        t0 = time.perf_counter()
        ens()
        _sync(dev)
        ens_ms.append((time.perf_counter() - t0) * 1e3)
    ens_ms = float(np.median(ens_ms[1:]))
    log(f"ensemble of two cnn14rnn_trm, torch-engine beam 3 (encodes "
        f"included): {ens_ms:.1f} ms per batch of {EVAL_B} x {EVAL_SECONDS} "
        f"s ({EVAL_B / ens_ms * 1e3:.1f} clips/s) on {card}")
    (FB.fused_beam_decode.launches, FG.fused_greedy_decode.launches,
     FL.fused_logmel.launches) = c0
    return dict(times=out, entries=entries, metrics=per_1000, ens_ms=ens_ms)

def _epoch_curve(log_path, loss_key: str, score_key: str):
    """[(loss, score)] of a run's ``train.log`` epoch lines."""
    import re
    out = []
    for line in Path(log_path).read_text().splitlines():
        m = re.search(rf"epoch \d+: {loss_key} (\S+) {score_key} (\S+)",
                      line)
        if m:
            out.append((float(m.group(1)), float(m.group(2))))
    return out


def constant_caption_cider(train_text: str, val_text: str) -> tuple:
    """The best CIDEr-D (the val score's scorer) that one caption earns as
    every val clip's prediction, among the most frequent train captions
    -> (score, caption)."""
    from collections import Counter
    from audiocaption_tpu_torch.data.dataset import load_caption_json
    from audiocaption_tpu_torch.metrics.tokenize import ptb_tokenize
    from audiocaption_tpu_torch.native import FastCiderD
    counts = Counter(c for caps in load_caption_json(train_text).values()
                     for c in caps)
    refs = load_caption_json(val_text)
    scorer, best = FastCiderD(), (-1.0, "")
    for cap, _ in counts.most_common(SYN_CONSTANT_CANDIDATES):
        score = scorer.compute_score(ptb_tokenize(refs), ptb_tokenize(
            {k: [cap] for k in refs}))[0]
        best = max(best, (score, cap))
    return best


# the synthetic corpora that phases 24-30 train on (10 s clips at 32 kHz,
# seed 0), in one temporary directory removed when the script exits.  A
# spawned worker process starts generating them with the script
# (:func:`start_corpora`), so that this host work (numpy, wav files)
# overlaps the earlier phases; a phase that takes fewer train clips than a
# corpus holds gets its first ones (``synthetic_corpus.subset``: the
# corpus the generator writes for that size, without generating it again)
_GENERATORS = {"v1": "generate", "v2": "generate_v2",
               "temporal": "generate_temporal"}
# the corpora's directory, and per (kind, sizes) the worker's future, or
# None for a corpus made in this process
_CORPORA = {"root": None, "made": {}}


def _generate_corpus(kind: str, path: str, sizes: tuple) -> float:
    """Corpus ``kind`` at ``sizes`` in ``path`` -> the seconds it took (run
    in the corpus worker, or in this process)."""
    sys.path.insert(0, str(ROOT))
    from audiocaption_tpu_torch.cli import synthetic_corpus as SC
    t0 = time.perf_counter()
    getattr(SC, _GENERATORS[kind])(path, *sizes, sr=SR_32K, seed=0)
    return time.perf_counter() - t0


def _corpus_dir(kind: str, sizes: tuple) -> Path:
    if _CORPORA["root"] is None:
        import atexit
        import shutil
        import tempfile
        _CORPORA["root"] = Path(tempfile.mkdtemp(prefix="chip_smoke_corpora_"))
        atexit.register(shutil.rmtree, _CORPORA["root"], True)
    return _CORPORA["root"] / f"{kind}_{'_'.join(map(str, sizes))}"


def start_corpora() -> None:
    """Start the corpus worker (one spawned process) on every corpus the
    later phases generate: phase 24's corpus v2 (26 and 27 take its first
    train clips), phase 25's temporal corpus (30 reuses it) and the two
    corpora v1 of phases 28 and 29.  The worker is shut down at exit."""
    import atexit
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    specs = [(kind, tuple(sizes)) for kind, sizes in (
        ("v2", SYN_V2_SIZES), ("temporal", SYN_TEMPORAL_SIZES),
        ("v1", FEAT_SIZES), ("v1", ENC_SIZES))]
    paths = [str(_corpus_dir(*spec)) for spec in specs]
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))
    # atexit runs last-registered first: the worker ends before the
    # directory goes
    atexit.register(pool.shutdown, wait=True, cancel_futures=True)
    for spec, path in zip(specs, paths):
        _CORPORA["made"][spec] = pool.submit(_generate_corpus, spec[0], path,
                                             spec[1])


def shared_corpus(kind: str, sizes) -> tuple:
    """(the directory of the corpus ``kind``, "v1", "v2" or "temporal", at
    ``sizes`` (train, val, test), the seconds this call waited for it):
    the corpus worker's, a subset of a larger train split already asked
    for, or else generated here."""
    from audiocaption_tpu_torch.cli import synthetic_corpus as SC
    sizes = tuple(sizes)
    path = _corpus_dir(kind, sizes)
    made = _CORPORA["made"]
    t0 = time.perf_counter()
    if (kind, sizes) in made:
        if made[(kind, sizes)] is not None:
            made[(kind, sizes)].result()
        return path, time.perf_counter() - t0
    larger = [s for k, s in made if k == kind and s[0] > sizes[0]
              and s[1:] == sizes[1:]]
    if larger:
        if made[(kind, larger[0])] is not None:
            made[(kind, larger[0])].result()
        SC.subset(str(_corpus_dir(kind, larger[0])), str(path), sizes[0])
    else:
        _generate_corpus(kind, str(path), sizes)
    made[(kind, sizes)] = None
    return path, time.perf_counter() - t0


def synthetic_flagship_path(dev, card):
    """:func:`_synthetic_flagship` in a temporary directory, which is removed
    also when a check fails."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_v2_"))
    try:
        return _synthetic_flagship(root, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _synthetic_flagship(root, dev, card):
    """Phase 24: generate a reduced corpus v2 (``cli/synthetic_corpus.py``:
    SYN_V2_SIZES clips of 10 s at 32 kHz, float32 wav files; kept for the
    run by :func:`shared_corpus`) and train the
    flagship recipe on it through ``Runner.train``
    (``cli/recipes.py::flagship_train``:
    ``configs/synthetic_v2/effb2_trm.yaml`` with the corpus's directory;
    epochs cut to SYN_V2_EPOCHS,
    the schedule's final rate SYN_V2_FINAL_LR, SWA from epoch 2,
    SYN_WORKERS loader workers), its val score through
    the greedy kernel, then ``Runner.evaluate`` of its best checkpoint at
    beam 3 through the beam kernel (``flagship_test``, 16 kHz).  Bars: the
    epoch loss falls from the first epoch to the last; the best val score
    beats the best constant caption (``constant_caption_cider``); every
    test score finite.  On the trained weights: (a) the greedy kernel's
    decode of the val set against the torch engine's greedy decode: 0
    tokens apart, or every diverging caption diverging first at a near tie
    (the engine's log-probabilities of the two words within SYN_TIE);
    (b) the beam kernel on the first test batch's memory against the
    plain search (``float64_floor_check``); (c) the launches, set to 0
    before the run and read after it (the checks' taken back out): the
    greedy kernel once a val batch an epoch, the beam kernel once a test
    batch."""
    import torch
    import torch.nn.functional as F
    from audiocaption_tpu_torch.cli import recipes
    from audiocaption_tpu_torch.cli.run import (
        Runner, build_dataloader, experiment_model, read_experiment)
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.ops import fused_logmel as FL

    data, t_gen = shared_corpus("v2", SYN_V2_SIZES)
    constant, const_cap = constant_caption_cider(
        str(data / "train_text.json"), str(data / "val_text.json"))
    over = [f"device={dev.type}", f"experiment_path={root}/effb2_trm",
            f"trainer.epochs={SYN_V2_EPOCHS}", "swa.start=2",
            f"lr_scheduler.args.final_lrs={SYN_V2_FINAL_LR:.7f}",
            f"data.train.dataloader_args.num_workers={SYN_WORKERS}"]
    FG.reset_launches(FG.fused_greedy_decode)
    FB.reset_launches(FB.fused_beam_decode)
    FL.fused_logmel.launches = 0
    runner = Runner()
    t0 = time.perf_counter()
    exp = runner.train(recipes.flagship_train(str(data)), *over)
    t_train = time.perf_counter() - t0
    scores = runner.evaluate(exp, recipes.flagship_test(str(data)),
                             f"device={dev.type}", "resume=best.pth",
                             "data.test.dataset.args.target_sr=16000",
                             "caption_output=predictions/best_beam3.json",
                             "score_output=results/best_beam3.txt")
    t_eval = time.perf_counter() - t0 - t_train
    launches = {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_beam": FB.fused_beam_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}
    keep_experiment(exp, "flagship", "best.pth")
    curve = _epoch_curve(Path(exp) / "train.log", "loss", "val_cider")
    for line in (Path(exp) / "train.log").read_text().splitlines():
        log(f"synthetic v2 {line}")
    floats = {k: v for k, v in scores.items() if isinstance(v, float)}
    log(f"synthetic v2: corpus {SYN_V2_SIZES} x 10 s in {t_gen:.1f} s; "
        f"{len(curve)} epochs in {t_train:.1f} s; loss {curve[0][0]:.4f} -> "
        f"{curve[-1][0]:.4f}; best val CIDEr-D "
        f"{max(c[1] for c in curve):.4f} (best constant caption "
        f"{constant:.4f}: {const_cap!r}); test beam 3 (best.pth, "
        f"{t_eval:.1f} s) "
        f"{json.dumps({k: round(v, 4) for k, v in floats.items()})}"
        f"; launches {launches} on {card}")
    n_val = -(-SYN_V2_SIZES[1] // 32)
    n_test = -(-SYN_V2_SIZES[2] // 32)
    if dev.type == "cuda":
        assert launches["fused_greedy"] == SYN_V2_EPOCHS * n_val, launches
        assert launches["fused_beam"] == n_test, launches

    # (a) and (b) on the trained weights; their launches are not the path's
    cfg, ckpt = read_experiment(exp, "best.pth")
    model, _ = experiment_model(cfg, ckpt, dev)
    mis = tokens = ties = 0
    for batch in build_dataloader(cfg["data"]["val"], train=False):
        wav = torch.as_tensor(batch["wav"]).to(dev).float()
        wav_len = torch.as_tensor(batch["wav_len"]).to(dev).long()
        with torch.no_grad():
            enc = model.encode(wav, wav_len)
            ref = generate(model, enc=enc, sample_method="greedy",
                           max_length=L)["seq"]
            if dev.type == "cuda":
                got = FG.FusedGreedyDecoder(model, max_length=L,
                                            device=dev)(wav, wav_len)
            else:
                got = ref
            mis += int((got != ref).sum())
            tokens += ref.numel()
            for r in torch.nonzero((got != ref).any(-1)).flatten().tolist():
                t = int(torch.nonzero(got[r] != ref[r])[0])
                prefix = torch.cat([ref.new_full((1,), model.special.bos),
                                    ref[r, :t]])[None]
                logit = model.decoder(
                    prefix, enc["attn_emb"][r:r + 1],
                    enc["attn_emb_len"][r:r + 1],
                    cap_padding_mask=prefix == model.special.pad)["logit"]
                lp = F.log_softmax(logit[0, -1].double(), -1)
                gap = float(lp[ref[r, t]] - lp[got[r, t]])
                assert gap <= SYN_TIE, f"greedy kernel diverges at gap {gap}"
                ties += 1
    log(f"synthetic v2 (a): the greedy kernel vs the torch engine on the "
        f"trained weights, {SYN_V2_SIZES[1]} val clips: {mis}/{tokens} "
        f"tokens differ, {ties} captions diverging at a near tie (log-prob "
        f"gap <= {SYN_TIE})")
    test_cfg = recipes.flagship_test(str(data))["data"]["test"]
    test_cfg["dataset"]["args"]["target_sr"] = 16000
    test = next(iter(build_dataloader(test_cfg, train=False)))
    with torch.no_grad():
        enc = model.encode(torch.as_tensor(test["wav"]).to(dev).float(),
                           torch.as_tensor(test["wav_len"]).to(dev).long())
        memkv, valid = FG.memory_kv(model.decoder, enc["attn_emb"],
                                    enc["attn_emb_len"], False)
    packed = FG.pack_decoder_weights(model.decoder).to(dev)
    seq, score = FB.fused_beam_decode(packed, memkv, valid, L, 3)
    p_seq, p_score = FB.fused_beam_plain(packed, memkv, valid, L, 3)
    b_mis = int((seq != p_seq).sum())
    log(f"synthetic v2 (b): the beam kernel vs the plain search on the "
        f"trained weights (B={seq.shape[0]}, beam 3): {b_mis}/{seq.numel()} "
        f"tokens differ")
    assert b_mis <= MISMATCH_LIMIT * seq.numel(), "beam kernel disagrees"
    assert float64_floor_check(packed, memkv, valid, 3, seq, score, p_seq,
                               p_score), "beam kernel scores disagree"
    assert floats and all(math.isfinite(v) for v in floats.values())
    assert len(curve) == SYN_V2_EPOCHS and curve[-1][0] < curve[0][0], \
        "synthetic v2: the loss did not fall"
    assert max(c[1] for c in curve) > constant, \
        "synthetic v2: the val score is no better than a constant caption"
    return {"launches": launches, "greedy_err": float(mis),
            "times": {"corpus_s": t_gen, "train_s": t_train,
                      "evaluate_s": t_eval}}


def synthetic_temporal_path(dev, card):
    """:func:`_synthetic_temporal` in a temporary directory, which is removed
    also when a check fails."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_temporal_"))
    try:
        return _synthetic_temporal(root, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _synthetic_temporal(root, dev, card):
    """Phase 25: generate a reduced temporal corpus (SYN_TEMPORAL_SIZES
    clips of 10 s at 32 kHz; kept for phase 30), train the SED net through
    ``Runner.train_sed`` (``cli/recipes.py::sed_train``, epochs cut to
    SYN_SED_EPOCHS; its log-mel bank through the log-mel kernel), the
    tag-conditioned captioner through ``Runner.train`` (``tempgru_train``,
    SYN_TEMPGRU_EPOCHS epochs, SWA from epoch 2) and score it with
    ``Runner.evaluate_temporal`` (``temporal_test``: the SED net's tags,
    beam 3 in the torch engine).  Bars: both losses fall from the first
    epoch to the last; the best val tag accuracy beats the most frequent
    val tag's share; the best val score beats the best constant caption;
    every test score finite.  The bank's log-mel (the kernel, on the first
    64 train clips) within LOGMEL_DB_ATOL of ``fused_logmel_plain``, or
    else no further from the log-mel in float64 than the float32 plain
    version is (``float64_floor_check``'s rule: these clips span ~90 dB,
    and a dense float32 DFT rounds the quiet bins' power by up to ~4e-3
    dB); and the bank those values in float16 exactly.  The log-mel kernel's
    launches, set to 0 before the path and read after it, must be above
    0."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli import recipes
    from audiocaption_tpu_torch.cli.run import Runner, _sed_audio
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.ops.frontend import (
        CNN14_MEL_32K, LogMelFrontend)
    from audiocaption_tpu_torch.training.sed_trainer import (
        build_lms_bank, load_sed_annotations)

    data, t_gen = shared_corpus("temporal", SYN_TEMPORAL_SIZES)
    constant, const_cap = constant_caption_cider(
        str(data / "train_text.json"), str(data / "val_text.json"))
    val_tags = np.asarray([a["tag"] for a in load_sed_annotations(
        str(data / "val_sed.json"))])
    const_tag = float(np.bincount(val_tags).max() / len(val_tags))
    dev_over = f"device={dev.type}"
    FL.fused_logmel.launches = 0
    runner = Runner()
    t0 = time.perf_counter()
    sed_exp = runner.train_sed(recipes.sed_train(str(data)), dev_over,
                               f"experiment_path={root}/sed",
                               f"trainer.epochs={SYN_SED_EPOCHS}")
    t_sed = time.perf_counter() - t0
    sed_launches = FL.fused_logmel.launches
    exp = runner.train(recipes.tempgru_train(str(data)), dev_over,
                       f"experiment_path={root}/tempgru",
                       f"trainer.epochs={SYN_TEMPGRU_EPOCHS}", "swa.start=2",
                       f"data.train.dataloader_args.num_workers={SYN_WORKERS}")
    t_train = time.perf_counter() - t0 - t_sed
    scores = runner.evaluate_temporal(
        exp, sed_exp, recipes.temporal_test(str(data)), dev_over,
        "caption_output=predictions/swa_beam3_sedtag.json",
        "score_output=results/swa_beam3_sedtag.txt")
    t_eval = time.perf_counter() - t0 - t_sed - t_train
    launches = {"fused_logmel": FL.fused_logmel.launches}
    for name, d in (("sed", sed_exp), ("tempgru", exp)):
        for line in (Path(d) / "train.log").read_text().splitlines():
            log(f"synthetic temporal {name} {line}")
    sed_curve = _epoch_curve(Path(sed_exp) / "train.log", "bce",
                             "val_tag_acc")
    curve = _epoch_curve(Path(exp) / "train.log", "loss", "val_cider")
    tag_acc = (Path(exp) / "results/sed_tag_accuracy.txt").read_text().strip()
    floats = {k: v for k, v in scores.items() if isinstance(v, float)}
    log(f"synthetic temporal: corpus {SYN_TEMPORAL_SIZES} x 10 s in "
        f"{t_gen:.1f} s; SED {len(sed_curve)} epochs in {t_sed:.1f} s, bce "
        f"{sed_curve[0][0]:.4f} -> {sed_curve[-1][0]:.4f}, best val tag "
        f"accuracy {max(c[1] for c in sed_curve):.4f} (most frequent tag "
        f"{const_tag:.4f}); tempgru {len(curve)} epochs in {t_train:.1f} s, "
        f"loss {curve[0][0]:.4f} -> {curve[-1][0]:.4f}, best val CIDEr-D "
        f"{max(c[1] for c in curve):.4f} (best constant caption "
        f"{constant:.4f}: {const_cap!r}); test with SED tags ({t_eval:.1f} "
        f"s; {tag_acc}) "
        f"{json.dumps({k: round(v, 4) for k, v in floats.items()})}; "
        f"log-mel launches: {sed_launches} for the SED banks, "
        f"{launches['fused_logmel']} in all, on {card}")
    if dev.type == "cuda":
        assert sed_launches > 0 and launches["fused_logmel"] > sed_launches

    # the bank's values against the plain log-mel (launches taken back out)
    n0 = FL.fused_logmel.launches
    ann = load_sed_annotations(str(data / "train_sed.json"))[:64]
    ids = [a["audio_id"] for a in ann]
    read = _sed_audio({"sed": str(data / "train_sed.json")})
    front = LogMelFrontend(CNN14_MEL_32K).to(dev)
    wav = torch.from_numpy(np.stack([read(a) for a in ids])).to(dev)
    with torch.no_grad():
        kernel = front(wav)
        plain = FL.fused_logmel_plain(wav, front.basis, front.mel_fb,
                                      front.config)
        f64 = float64_logmel(wav, front)
    bank = build_lms_bank(read, ids, LogMelFrontend(CNN14_MEL_32K), dev)
    FL.fused_logmel.launches = n0
    err = float((kernel - plain).abs().max())
    err64 = float((kernel.double() - f64).abs().max())
    plain64 = float((plain.double() - f64).abs().max())
    log(f"synthetic temporal: the SED bank's log-mel (kernel) vs "
        f"fused_logmel_plain on {len(ids)} train clips: max |diff| "
        f"{err:.3g} dB (limit {LOGMEL_DB_ATOL}); vs the float64 log-mel "
        f"{err64:.3g} dB, the float32 plain version vs float64 {plain64:.3g}"
        f" dB; bank == kernel in float16: "
        f"{bool(torch.equal(bank, kernel.half()))}")
    assert err <= LOGMEL_DB_ATOL or err64 <= plain64, \
        "SED bank: log-mel kernel disagrees"
    assert torch.equal(bank, kernel.half()), "SED bank is not the kernel's"
    assert floats and all(math.isfinite(v) for v in floats.values())
    assert sed_curve[-1][0] < sed_curve[0][0], "SED: the loss did not fall"
    assert max(c[1] for c in sed_curve) > const_tag, \
        "SED: the val tag accuracy is no better than a constant tag"
    assert curve[-1][0] < curve[0][0], "tempgru: the loss did not fall"
    assert max(c[1] for c in curve) > constant, \
        "tempgru: the val score is no better than a constant caption"
    return {"launches": launches, "logmel_err": err64,
            "times": {"corpus_s": t_gen, "train_sed_s": t_sed,
                      "train_s": t_train, "evaluate_s": t_eval}}


def synthetic_aug_path(dev, card):
    """:func:`_synthetic_aug` in a temporary directory, which is removed
    also when a check fails."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_aug_"))
    try:
        return _synthetic_aug(root, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _synthetic_aug(root, dev, card):
    """Phase 26: augmented training of ``zoo.cnn14rnn_trm`` at full width.
    (a) a reduced corpus v2 (SYN_AUG_SIZES clips of 10 s at 32 kHz, the
    first train clips of phase 24's) and
    its speed-perturbed train split (``cli/data_tools.py speed_perturb
    --compute``, 0.9 and 1.1); (b) ``Runner.train_aug`` of
    ``cli/recipes.py::aug_train`` (``configs/synthetic_v2/cnn14rnn_trm.yaml``
    with ``configs/synthetic/aug.yaml``'s ``data.train_aug`` and ``aug``
    nodes; SYN_AUG_EPOCHS epochs, the final rate SYN_AUG_FINAL_LR): the
    loss falls, the best val CIDEr-D beats the best constant caption, the
    greedy kernel launches once a val batch an epoch and the log-mel
    kernel twice a step and once a val batch; the log-mel kernel on the
    first real and aug batches within LOGMEL_DB_ATOL of
    ``fused_logmel_plain`` or no further from float64 than it (phase 25's
    rule); (c) on the trained weights, the BN running buffers after one
    aug step equal, bit for bit, those after the real forward alone (the
    CNN's dropout drawn alike), where a real and an aug forward would move
    them; (d) ``Runner.train`` with ``specaug: True`` for three steps:
    each step's SpecAugment on the card equals ``drop_stripes`` on the CPU
    for the same stripes, bit for bit, the stripes lie in their ranges,
    at least one is not empty, and the val score (``eval()``) draws none;
    (e) the aug step split by CUDA events (median of SYN_AUG_TIMED after
    SYN_AUG_WARMUP), the device's idle share (``torch.profiler``) and the
    peak memory."""
    import copy
    import itertools
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli import recipes
    from audiocaption_tpu_torch.cli.data_tools import speed_perturb
    from audiocaption_tpu_torch.cli.run import (
        Runner, build_dataloader, experiment_model, read_experiment,
        to_device)
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.losses.loss import build_loss
    from audiocaption_tpu_torch.models import captioner as CAP
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.ops.specaug import drop_stripes
    from audiocaption_tpu_torch.optim.schedules import build_schedule
    from audiocaption_tpu_torch.training.aug_runner import (
        aug_train_step, interleave_loaders)
    from audiocaption_tpu_torch.training.trainer import (
        bn_buffers, create_train_state)

    # (a) the corpus and its speed-perturbed train split
    data, t_gen = shared_corpus("v2", SYN_AUG_SIZES)
    aug = root / "aug"
    t0 = time.perf_counter()
    out = speed_perturb(str(data), str(aug), compute=True,
                        wav_csv=str(data / "train_wav.csv"),
                        text_json=str(data / "train_text.json"))
    Path(out["wav_csv"]).replace(aug / "train_wav.csv")
    Path(out["text_json"]).replace(aug / "train_text.json")
    t_sp = time.perf_counter() - t0
    constant, const_cap = constant_caption_cider(
        str(data / "train_text.json"), str(data / "val_text.json"))

    # (b) train_aug
    half = max(SYN_WORKERS // 2, 1)
    over = [f"device={dev.type}", f"experiment_path={root}/aug_exp",
            f"trainer.epochs={SYN_AUG_EPOCHS}",
            f"lr_scheduler.args.final_lrs={SYN_AUG_FINAL_LR:.7f}",
            f"data.train.dataloader_args.num_workers={half}",
            f"data.train_aug.dataloader_args.num_workers={half}"]
    FG.reset_launches(FG.fused_greedy_decode)
    FL.fused_logmel.launches = 0
    t0 = time.perf_counter()
    exp = Runner().train_aug(recipes.aug_train(str(data), str(aug)), *over)
    t_train = time.perf_counter() - t0
    launches = {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}
    keep_experiment(exp, "cnn14rnn_trm_aug", "last.pth")
    for line in (Path(exp) / "train.log").read_text().splitlines():
        log(f"synthetic aug {line}")
    curve = _epoch_curve(Path(exp) / "train.log", "loss", "val_cider")
    cfg, ckpt = read_experiment(exp, "last.pth")
    n_items = sum(len(a["captions"]) for a in json.loads(
        (data / "train_text.json").read_text())["audios"])
    steps = SYN_AUG_EPOCHS * (
        n_items // cfg["data"]["train"]["dataloader_args"]["batch_size"])
    n_val = -(-SYN_AUG_SIZES[1]
              // cfg["data"]["val"]["dataloader_args"]["batch_size"])
    log(f"synthetic aug (b): corpus {SYN_AUG_SIZES} x 10 s in {t_gen:.1f} "
        f"s, its {2 * SYN_AUG_SIZES[0]} perturbed train clips in {t_sp:.1f} "
        f"s; {len(curve)} epochs ({steps} aug steps) in {t_train:.1f} s; "
        f"loss {curve[0][0]:.4f} -> {curve[-1][0]:.4f}; best val CIDEr-D "
        f"{max(c[1] for c in curve):.4f} (best constant caption "
        f"{constant:.4f}: {const_cap!r}); launches {launches} on {card}")
    if dev.type == "cuda":
        assert launches["fused_greedy"] == SYN_AUG_EPOCHS * n_val, launches
        assert launches["fused_logmel"] == 2 * steps + SYN_AUG_EPOCHS * \
            n_val, launches

    model, tokenizer = experiment_model(cfg, ckpt, dev)
    pairs = [(to_device(r, dev), to_device(a, dev)) for r, a in
             itertools.islice(interleave_loaders(
                 build_dataloader(cfg["data"]["train"], tokenizer),
                 build_dataloader(cfg["data"]["train_aug"], tokenizer)),
                 SYN_AUG_WARMUP + SYN_AUG_TIMED)]
    real, augb = pairs[0]
    n0 = FL.fused_logmel.launches
    errs = []
    for b in (real, augb):
        with torch.no_grad():
            wav = b["wav"]
            kernel = model.frontend(wav)
            plain = FL.fused_logmel_plain(wav, model.frontend.basis,
                                          model.frontend.mel_fb,
                                          model.frontend.config)
            f64 = float64_logmel(wav, model.frontend)
        err = float((kernel - plain).abs().max())
        err64 = float((kernel.double() - f64).abs().max())
        plain64 = float((plain.double() - f64).abs().max())
        errs.append(err64)
        log(f"synthetic aug (b): log-mel kernel vs fused_logmel_plain on "
            f"the first batch {tuple(wav.shape)}: max |diff| {err:.3g} dB "
            f"(limit {LOGMEL_DB_ATOL}); vs float64 {err64:.3g} dB, plain vs "
            f"float64 {plain64:.3g} dB")
        assert err <= LOGMEL_DB_ATOL or err64 <= plain64, \
            "aug path: log-mel kernel disagrees"
    FL.fused_logmel.launches = n0

    # (c) BN buffers after an aug step: the real forward's alone
    loss_fn = build_loss(cfg.get("loss", {}))
    model.train()

    def forwards(m, *batches):
        torch.manual_seed(SEED + 26)          # the CNN's dropout alike
        with torch.no_grad():
            for b in batches:
                m(b["wav"], b["wav_len"], b["cap"], b["cap_len"])
        return [x.clone() for x in bn_buffers(m)]
    want = forwards(copy.deepcopy(model), real)
    moved = forwards(copy.deepcopy(model), real, augb)
    opt = cfg.get("optimizer", {}).get("args", {})
    state = create_train_state(
        model, opt.get("lr", 5e-4),
        build_schedule(cfg.get("lr_scheduler", {}), opt.get("lr", 5e-4),
                       100, 20), opt.get("weight_decay", 0.0), 1.0)
    torch.manual_seed(SEED + 26)
    aug_train_step(state, loss_fn, real, augb, 0.5)
    got = bn_buffers(model)
    bn_diff = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
    aug_moves = max(float((m_.double() - w.double()).abs().max())
                    for m_, w in zip(moved, want))
    log(f"synthetic aug (c): {len(got)} BN buffers after one aug step vs "
        f"after the real forward alone: max |diff| {bn_diff:.3g}; a real "
        f"and an aug forward would move them by up to {aug_moves:.3g}")
    assert bn_diff == 0.0 and aug_moves > 0.0, "aug step: BN buffers"

    # (d) SpecAugment in Runner.train: the card's stripes against the CPU
    records = []
    spec_augment = CAP.spec_augment

    def recording(lms, generator=None, **kw):
        stripes = {}
        out_ = spec_augment(lms, generator, stripes=stripes, **kw)
        records.append((lms.cpu(), out_.cpu(), {
            k: (d.cpu(), b.cpu()) for k, (d, b) in stripes.items()}))
        return out_
    sa_cfg = recipes.recipe("synthetic_v2/cnn14rnn_trm.yaml", str(data))
    n_steps = -(-SYN_AUG_SPECAUG_SAMPLES
                // sa_cfg["data"]["train"]["dataloader_args"]["batch_size"])
    CAP.spec_augment = recording
    try:
        Runner().train(
            sa_cfg, f"device={dev.type}", f"experiment_path={root}/specaug",
            "specaug=True", "trainer.epochs=1", "swa.use=False",
            f"data.train.dataloader_args.num_samples="
            f"{SYN_AUG_SPECAUG_SAMPLES}",
            f"data.train.dataloader_args.num_workers={half}")
    finally:
        CAP.spec_augment = spec_augment
    changed = 0
    for lms, got_, stripes in records:
        want_ = drop_stripes(drop_stripes(lms, 1, *stripes["time"]), 2,
                             *stripes["freq"])
        assert torch.equal(got_, want_), "SpecAugment: card != CPU"
        for (d, b), (width, dim) in ((stripes["time"], (64, lms.shape[1])),
                                     (stripes["freq"], (8, lms.shape[2]))):
            assert bool(((d >= 0) & (d < width)).all())
            assert bool(((b >= 0) & (b < torch.clamp(dim - d, min=1))).all())
        changed += int(not torch.equal(got_, lms))
    log(f"synthetic aug (d): Runner.train with specaug: {len(records)} "
        f"SpecAugment calls in {n_steps} steps (none in the val score), "
        f"each equal to drop_stripes on the CPU bit for bit, stripes in "
        f"range; {changed} changed the encoder's input; batch "
        f"{tuple(records[0][0].shape) if records else None}")
    assert len(records) == n_steps and changed > 0

    # (e) the aug step's time split, idle share and peak memory
    marks = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[name] = e
    parts = ("real", "aug", "backward", "optimizer")
    c0 = FL.fused_logmel.launches
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for r, a in pairs:
        mark("start")
        aug_train_step(state, loss_fn, r, a, 0.5, mark=mark)
        torch.cuda.synchronize()
        prev, row = marks["start"], []
        for p_ in parts:
            row.append(prev.elapsed_time(marks[p_]))
            prev = marks[p_]
        rows.append(row)
    rows = np.asarray(rows[SYN_AUG_WARMUP:])
    step_ms = float(np.median(rows.sum(1)))
    split = dict(zip(parts, np.median(rows, 0).tolist()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy = device_split(lambda: aug_train_step(state, loss_fn, *pairs[0],
                                               0.5), iters=3)
    total = sum(busy.values())
    FL.fused_logmel.launches = c0
    B = pairs[0][0]["wav"].shape[0]
    log(f"synthetic aug (e): aug step median {step_ms:.2f} ms over "
        f"{SYN_AUG_TIMED} steps ({B / step_ms * 1e3:.1f} real clips/s): "
        f"real forward + loss {split['real']:.2f}, aug forward + loss "
        f"{split['aug']:.2f}, backward (with the clip) "
        f"{split['backward']:.2f}, optimizer {split['optimizer']:.2f} ms; "
        f"device time {total:.2f} ms a step (torch.profiler), idle share "
        f"{1 - total / step_ms:.3f}; peak memory {peak:.2f} GiB; real "
        f"{tuple(pairs[0][0]['wav'].shape)}, aug "
        f"{tuple(pairs[0][1]['wav'].shape)}, float32, TF32 off, on {card}; "
        f"top kernels {dict(list(busy.items())[:6])}")
    assert len(curve) == SYN_AUG_EPOCHS and curve[-1][0] < curve[0][0], \
        "synthetic aug: the loss did not fall"
    assert max(c[1] for c in curve) > constant, \
        "synthetic aug: the val score is no better than a constant caption"
    return {"launches": launches, "logmel_err": max(errs),
            "step_ms": step_ms, "split": split, "peak": peak,
            "idle": 1 - total / step_ms,
            "times": {"corpus_s": t_gen, "speed_perturb_s": t_sp,
                      "train_s": t_train}}


def family_node(enc_type: str = "Cnn10Encoder",
                dec_type: str = "BahAttnAddFcDecoder",
                dec_args: dict = None, enc_extra: dict = None) -> dict:
    """A model node of the 32 kHz family for ``build_model_from_config``
    (the JAX builder's defaults where ``dec_args`` says nothing)."""
    node = {"type": "captioning.models.seq2seq.Seq2SeqAttnModel",
            "encoder": {"type": enc_type, "args": {"sample_rate": SR_32K}},
            "decoder": {"type": dec_type, "args": dict(dec_args or {})}}
    node["encoder"].update(enc_extra or {})
    return node


# (b): a Cnn10 and a 2-layer BahAttnAddFcDecoder at emb and d_model 512
FAM_GRU_NODE = family_node(dec_args={"emb_dim": 512, "d_model": 512,
                                     "num_layers": 2})
# (d): a Cnn14Transformer (d_model 512, 2 layers) and the transformer
# decoder of the cnn14rnn_trm recipe (emb 256, 2 layers, untied)
FAM_TRM_NODE = family_node(
    "Cnn14TransformerEncoder", "TransformerDecoder",
    {"emb_dim": 256, "nlayers": 2, "dropout": 0.2},
    FAM_ENCODERS["Cnn14TransformerEncoder"])


def median_ms(fn, timed: int = FAM_TIMED, warmup: int = FAM_WARMUP) -> float:
    """The median of ``timed`` calls' CUDA-event times after ``warmup``."""
    import numpy as np
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def family_encoders(dev, card) -> dict:
    """Phase 27(a): each new encoder built from a config dict (random
    weights from a seed) forward in ``eval()`` on B=FAM_B clips of
    FAM_SECONDS / 2 to FAM_SECONDS at 32 kHz, fed by the log-mel kernel;
    the kernel against ``fused_logmel_plain`` on that batch
    (LOGMEL_DB_ATOL, or no further from float64 than plain); each
    encoder's time (CUDA events, median of FAM_TIMED after FAM_WARMUP)
    and peak memory.  -> {encoder: {...}}, the log-mel error and the
    path's log-mel launches."""
    import torch
    from audiocaption_tpu_torch.models.zoo import random_init
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.utils.config import build_model_from_config
    gen = torch.Generator().manual_seed(SEED + 27)
    n = FAM_SECONDS * SR_32K
    wav = (torch.randn(FAM_B, n, generator=gen) * 0.1).to(dev)
    wav_len = torch.randint(n // 2, n + 1, (FAM_B,), generator=gen).to(dev)
    wav_len[0] = n
    out, launches, err = {}, 0, None
    for i, (name, extra) in enumerate(FAM_ENCODERS.items()):
        model, _ = build_model_from_config(
            family_node(name, "BahAttnCatFcDecoder", enc_extra=extra), 100)
        random_init(model, torch.Generator().manual_seed(SEED + i))
        model = model.to(dev).eval()
        with torch.no_grad():
            n0 = FL.fused_logmel.launches
            lms = model.log_mel(wav)
            launches += FL.fused_logmel.launches - n0
            feat_len = model.mel.feat_len(wav_len)
            if err is None:
                plain = FL.fused_logmel_plain(
                    wav, model.frontend.basis, model.frontend.mel_fb,
                    model.frontend.config)
                f64 = float64_logmel(wav, model.frontend)
                err = float((lms - plain).abs().max())
                err64 = float((lms.double() - f64).abs().max())
                plain64 = float((plain.double() - f64).abs().max())
                log(f"family (a): log-mel kernel vs fused_logmel_plain on "
                    f"{tuple(wav.shape)}: max |diff| {err:.3g} dB (limit "
                    f"{LOGMEL_DB_ATOL}); vs float64 {err64:.3g} dB, plain vs "
                    f"float64 {plain64:.3g} dB")
                assert err <= LOGMEL_DB_ATOL or err64 <= plain64, \
                    "family: log-mel kernel disagrees"
                del plain, f64
            ms = median_ms(lambda: model.encode_lms(lms, feat_len))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            enc = model.encode_lms(lms, feat_len)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in model.encoder.parameters())
        attn, fc = enc["attn_emb"], enc["fc_emb"]
        want_len = torch.div(feat_len, model.encoder.downsample_ratio,
                             rounding_mode="floor") if hasattr(
            model.encoder, "downsample_ratio") else None
        log(f"family (a) {name}: {n_params / 1e6:.2f} M parameters; "
            f"attn_emb {tuple(attn.shape)}, fc_emb {tuple(fc.shape)}, "
            f"attn_emb_len {enc['attn_emb_len'].min().item()}-"
            f"{enc['attn_emb_len'].max().item()}; forward (eval) "
            f"{ms:.3f} ms per batch of {FAM_B} x {FAM_SECONDS} s (CUDA "
            f"events, median "
            f"of {FAM_TIMED}), peak {peak:.2f} GiB, float32, TF32 off, on "
            f"{card}")
        assert bool(torch.isfinite(attn).all() & torch.isfinite(fc).all()), \
            f"family (a): {name} is not finite"
        assert attn.shape[0] == fc.shape[0] == FAM_B
        if want_len is not None and name != "Cnn14TransformerEncoder":
            assert torch.equal(enc["attn_emb_len"], want_len), name
        out[name] = {"ms": ms, "peak_gib": peak,
                     "attn_emb": list(attn.shape), "fc_emb": list(fc.shape),
                     "params_m": n_params / 1e6}
        del model, enc, lms
        torch.cuda.empty_cache()
    return {"encoders": out, "logmel_err": err, "logmel_launches": launches}


def family_path(dev, card):
    """:func:`_family` in a temporary directory, which is removed also
    when a check fails."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_family_"))
    try:
        return _family(root, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _word_specificity(tokenizer, text_json: str):
    """The corpus's word specificity, one value a vocabulary id: a word's
    inverse caption frequency, log((N + 1) / (df + 1)) over the N train
    captions, divided by its largest value; 0 for the special tokens."""
    import numpy as np
    from audiocaption_tpu_torch.data.dataset import load_caption_json
    caps = [c for v in load_caption_json(text_json).values() for c in v]
    df = np.zeros(len(tokenizer), np.float64)
    for c in caps:
        ids = set(int(i) for i in tokenizer([c])["cap"][0])
        for i in ids:
            df[i] += 1
    ws = np.log((len(caps) + 1) / (df + 1))
    for w in ("<start>", "<end>", "<pad>", "<unk>"):
        if w in tokenizer.word2idx:
            ws[tokenizer.word2idx[w]] = 0.0
    return (ws / ws.max()).astype(np.float32)


def _write_conditions(data, tokenizer, ws):
    """``condition_hm.csv`` (1 for a caption longer than the median
    caption, else 0: the human / machine target of the condition loss)
    and ``condition_spec.csv`` (a caption's summed word specificity: the
    target of the specificity loss) for every train caption, keyed
    ``{audio_id}_{cap_id}``."""
    import numpy as np
    text = json.loads((data / "train_text.json").read_text())
    rows = [(f"{a['audio_id']}_{c.get('cap_id', 0)}",
             c.get("tokens", c.get("caption", "")))
            for a in text["audios"] for c in a["captions"]]
    lens = [len(t.split()) for _, t in rows]
    med = float(np.median(lens))
    with open(data / "condition_hm.csv", "w") as f:
        f.write("cap_id\tprob\n")
        for (key, _), n in zip(rows, lens):
            f.write(f"{key}\t{1.0 if n > med else 0.0}\n")
    with open(data / "condition_spec.csv", "w") as f:
        f.write("cap_id\tprob\n")
        for key, t in rows:
            ids = tokenizer([t])["cap"][0][1:-1]
            f.write(f"{key}\t{float(ws[ids].sum()):.6f}\n")


def check_decode_kernels(packed, memkv, valid, tag, greedy=True):
    """The beam-3 kernel and, with ``greedy``, the greedy kernel against
    their plain versions on ``packed`` over ``memkv``; fails on a
    disagreement (the beam scores by :func:`float64_floor_check` beyond
    SCORE_ATOL).  The caller owns the launch counts. -> (greedy tokens
    apart or None, the beam's max |score diff| on matching sequences)."""
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    g_mis = None
    with torch.no_grad():
        if greedy:
            g = FG.fused_greedy_decode(packed, memkv, valid, L)
            g_mis = int((g != FG.fused_greedy_plain(packed, memkv, valid,
                                                    L)).sum())
            assert g_mis <= MISMATCH_LIMIT * g.numel(), \
                f"{tag}: greedy kernel"
        seq, score = FB.fused_beam_decode(packed, memkv, valid, L, 3)
        p_seq, p_score = FB.fused_beam_plain(packed, memkv, valid, L, 3)
    b_mis = int((seq != p_seq).sum())
    same = (seq == p_seq).all(-1)
    b_err = float((score[same] - p_score[same]).abs().max()) \
        if bool(same.any()) else float("inf")
    log(f"{tag}: memory {tuple(memkv.shape)}: greedy kernel vs plain "
        f"tokens apart {'not run' if g_mis is None else g_mis}; beam-3 "
        f"tokens apart {b_mis}/{seq.numel()}, max |score diff| on matching "
        f"sequences {b_err:.3g}")
    assert b_mis <= MISMATCH_LIMIT * seq.numel(), f"{tag}: beam kernel"
    assert b_err <= SCORE_ATOL or float64_floor_check(
        packed, memkv, valid, 3, seq, score, p_seq, p_score), \
        f"{tag}: beam kernel scores disagree"
    return g_mis, b_err


def decode_kernels_at(exp, resume, test_data, dev, tag, greedy=True):
    """The decoder of the experiment ``exp`` (checkpoint ``resume``) over
    its encoder's memory of the first batch of the loader config
    ``test_data``, both decode kernels checked there
    (:func:`check_decode_kernels`); the launch counts are left as they
    were. -> (packed weights, memory K/V, valid mask, greedy tokens apart
    or None, beam error, the model's feature frames of that batch's
    clips)."""
    import torch
    from audiocaption_tpu_torch.cli.run import (
        build_dataloader, experiment_model, read_experiment)
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    c0 = (FG.fused_greedy_decode.launches, FB.fused_beam_decode.launches,
          FL.fused_logmel.launches)
    cfg, ckpt = read_experiment(exp, resume)
    model, _ = experiment_model(cfg, ckpt, dev)
    test = next(iter(build_dataloader(test_data, train=False)))
    with torch.no_grad():
        enc = model.encode(torch.as_tensor(test["wav"]).to(dev).float(),
                           torch.as_tensor(test["wav_len"]).to(dev).long())
        memkv, valid = FG.memory_kv(model.decoder, enc["attn_emb"],
                                    enc["attn_emb_len"], False)
        packed = FG.pack_decoder_weights(model.decoder).to(dev)
    frames = int(model.mel.feat_len(torch.tensor([test["wav"].shape[1]])))
    del model, enc
    g_mis, b_err = check_decode_kernels(packed, memkv, valid,
                                        f"{tag} at its trained weights",
                                        greedy)
    (FG.fused_greedy_decode.launches, FB.fused_beam_decode.launches,
     FL.fused_logmel.launches) = c0
    return packed, memkv, valid, g_mis, b_err, frames


def decode_entry(kind, name, packed, memkv, valid, launches, err, card,
                 steps=None):
    """A decode kernel (``kind`` "greedy" or "beam" 3) at the shapes of
    ``name``: warm and L2-cold time, its plain version's and its bound
    from this run's inputs (``steps``: a beam search's executed steps a
    sample, else those of the float32 plain search) -> its JSON entry."""
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    B_ = memkv.shape[2]
    with torch.no_grad():
        if kind == "greedy":
            def fn():
                return FG.fused_greedy_decode(packed, memkv, valid, L)

            def plain():
                return FG.fused_greedy_plain(packed, memkv, valid, L)
            seq = fn()
            out_bytes = seq.numel() * 4
            steps = [int(p_[0]) + 1 if len(p_) else L
                     for p_ in ((row == 2).nonzero() for row in seq.cpu())]
            rows = 1
        else:
            def fn():
                return FB.fused_beam_decode(packed, memkv, valid, L, 3)

            def plain():
                return FB.fused_beam_plain(packed, memkv, valid, L, 3)
            seq, score = fn()
            out_bytes = seq.numel() * 4 + score.numel() * 4
            if steps is None:
                st = torch.zeros(B_, dtype=torch.long, device=memkv.device)
                FB.fused_beam_plain(packed, memkv, valid, L, 3, steps=st)
                steps = st.tolist()
            rows = 3
        k_ms = cuda_ms(fn, 10)
        cold = cold_ms(fn, 10)
        plain_ms = cuda_ms(plain, 3, 1)
    S_ = memkv.shape[3]
    mm, attn = decode_flops(packed.emb_dim, packed.ffn, packed.vocab_size,
                            valid.sum(1).tolist(), steps, rows,
                            nl=packed.nlayers, S_=S_)
    nbytes = input_bytes(packed, memkv, valid, out_bytes)
    bound, _, by = decode_bound_ms(mm, attn, nbytes)
    fam = FG.fused_greedy_decode if kind == "greedy" else FB.fused_beam_decode
    log(f"fused_{kind} at the {name} shapes (B={B_}"
        f"{', beam 3' if kind == 'beam' else ''}, E={packed.emb_dim}, "
        f"{packed.nlayers} layer(s), S={S_}, V={packed.vocab_size} untied, "
        f"L={L}, steps {min(steps)}-{max(steps)}): {k_ms:.4f} ms/call "
        f"warm, {cold:.4f} "
        f"ms with the L2 cold; plain {plain_ms:.3f} ms; bound {bound:.4f} "
        f"ms by {by} ({nbytes} bytes, {mm} product ops, {attn} attention "
        f"ops; plan {fam.last_plan}) on {card}")
    src = {"greedy": ("fused_greedy.cu", "fused_greedy.py:209"),
           "beam": ("fused_beam.cu", "fused_beam.py:126")}[kind]
    return {"name": f"fused_{kind}[{name}]", "route": "cuda",
            "source": f"audiocaption_tpu_torch/csrc/{src[0]}",
            "replaces": f"audiocaption_tpu/decoding/{src[1]}",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "cold_ms": cold, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def _family(root, dev, card):
    """Phase 27: the rest of the 32 kHz captioner family at full width
    (the module docstring's (a)-(f)).  The launch counters are set to 0
    here and read at the end, the checks' and timings' launches taken back
    out: the log-mel kernel in every encode of (a)-(f), the greedy kernel
    in (d)'s val score (once a val batch an epoch), the beam kernel in
    (d)'s ``Runner.evaluate`` (once a test batch)."""
    import copy
    import itertools
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli import recipes
    from audiocaption_tpu_torch.cli.run import (
        Runner, build_dataloader, build_tokenizer, experiment_model,
        read_experiment, to_device)
    from audiocaption_tpu_torch.data.dataset import load_caption_json
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.decoding.ensemble import ensemble_generate
    from audiocaption_tpu_torch.losses.loss import build_loss
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.models.zoo import random_init
    from audiocaption_tpu_torch.native import FastCiderD
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.optim.schedules import build_schedule
    from audiocaption_tpu_torch.training.scst import scst_step
    from audiocaption_tpu_torch.training.trainer import (
        TrainState, create_train_state, train_step)
    from audiocaption_tpu_torch.utils.config import build_model_from_config

    def counts():
        return {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_beam": FB.fused_beam_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}

    def restore(c):
        (FG.fused_greedy_decode.launches, FB.fused_beam_decode.launches,
         FL.fused_logmel.launches) = (c["fused_greedy"], c["fused_beam"],
                                      c["fused_logmel"])
    FG.reset_launches(FG.fused_greedy_decode)
    FB.reset_launches(FB.fused_beam_decode)
    FL.fused_logmel.launches = 0
    marks = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[name] = e

    def split_of(rows, parts):
        rows = np.asarray(rows[FAM_WARMUP:])
        return (float(np.median(rows.sum(1))),
                dict(zip(parts, np.median(rows, 0).tolist())))
    times = {}

    # (a) the new encoders
    t0 = time.perf_counter()
    enc_a = family_encoders(dev, card)
    times["a_s"] = time.perf_counter() - t0

    # the corpus, its conditions and the recipe's data nodes
    data, times["corpus_s"] = shared_corpus("v2", FAM_SIZES)
    constant, const_cap = constant_caption_cider(
        str(data / "train_text.json"), str(data / "val_text.json"))
    base = recipes.recipe("synthetic_v2/cnn14rnn_trm.yaml", str(data))
    base["swa"] = {"use": False}
    tokenizer = build_tokenizer(
        base["data"]["train"]["collate_fn"]["tokenizer"])
    ws = _word_specificity(tokenizer, str(data / "train_text.json"))
    np.save(data / "word_specificity.npy", ws)
    _write_conditions(data, tokenizer, ws)
    over = [f"device={dev.type}",
            f"data.train.dataloader_args.num_workers={SYN_WORKERS}"]
    n_items = sum(len(a["captions"]) for a in json.loads(
        (data / "train_text.json").read_text())["audios"])
    bs = base["data"]["train"]["dataloader_args"]["batch_size"]
    n_val = -(-FAM_SIZES[1] // base["data"]["val"]["dataloader_args"][
        "batch_size"])
    n_test = -(-FAM_SIZES[2] // recipes.flagship_test(str(data))["data"][
        "test"]["dataloader_args"]["batch_size"])
    runner = Runner()

    def train_run(name, cfg, *extra):
        c0 = counts()
        t_ = time.perf_counter()
        exp = runner.train(cfg, *over, f"experiment_path={root}/{name}",
                           *extra)
        dt = time.perf_counter() - t_
        for line in (Path(exp) / "train.log").read_text().splitlines():
            log(f"family {name} {line}")
        n = counts()
        return exp, dt, {k: n[k] - c0[k] for k in n}

    # (b) a Cnn10 + 2-layer BahAttnAddFcDecoder, the XE recipe's settings
    cfg_b = dict(copy.deepcopy(base), model=FAM_GRU_NODE)
    exp_b, times["b_train_s"], l_b = train_run(
        "gru", cfg_b, f"trainer.epochs={FAM_XE_EPOCHS}",
        f"lr_scheduler.args.final_lrs={FAM_XE_FINAL_LR:.7f}")
    curve_b = _epoch_curve(Path(exp_b) / "train.log", "loss", "val_cider")
    steps_b = FAM_XE_EPOCHS * (n_items // bs)
    log(f"family (b): Cnn10 + 2-layer BahAttnAddFcDecoder (emb, d_model "
        f"512) for {len(curve_b)} epochs ({steps_b} steps) in "
        f"{times['b_train_s']:.1f} s; loss {curve_b[0][0]:.4f} -> "
        f"{curve_b[-1][0]:.4f}; best val CIDEr-D "
        f"{max(c[1] for c in curve_b):.4f} (best constant caption "
        f"{constant:.4f}: {const_cap!r}); launches {l_b} on {card}")
    if dev.type == "cuda":
        assert l_b["fused_logmel"] == steps_b + FAM_XE_EPOCHS * n_val, l_b
        assert l_b["fused_greedy"] == l_b["fused_beam"] == 0, l_b
    assert len(curve_b) == FAM_XE_EPOCHS
    # its step split and idle share, on the trained weights
    c0 = counts()
    cfg, ckpt = read_experiment(exp_b, "last.pth")
    model_b, tok = experiment_model(cfg, ckpt, dev)
    opt = cfg["optimizer"]["args"]
    state = create_train_state(
        model_b, opt["lr"], build_schedule(cfg["lr_scheduler"], opt["lr"],
                                           100, 20),
        opt.get("weight_decay", 0.0), 1.0)
    loss_fn = build_loss(cfg["loss"])
    batches = [to_device(b, dev) for b in itertools.islice(
        build_dataloader(cfg["data"]["train"], tok),
        FAM_WARMUP + FAM_STEP_TIMED)]
    ss_gen = torch.Generator().manual_seed(SEED)
    rows = []
    for b in batches:
        mark("start")
        train_step(state, loss_fn, b, ss_ratio=torch.tensor(0.85),
                   generator=ss_gen, mark=mark)
        torch.cuda.synchronize()
        rows.append([marks["start"].elapsed_time(marks["forward"]),
                     marks["forward"].elapsed_time(marks["backward"]),
                     marks["backward"].elapsed_time(marks["optimizer"])])
    step_b, split_b = split_of(rows, ("forward", "backward", "optimizer"))
    busy = device_split(lambda: train_step(
        state, loss_fn, batches[0], ss_ratio=torch.tensor(0.85),
        generator=ss_gen), iters=3)
    idle_b = 1 - sum(busy.values()) / step_b
    log(f"family (b) step: median {step_b:.2f} ms over {FAM_STEP_TIMED} "
        f"steps ({bs / step_b * 1e3:.1f} clips/s): forward with "
        f"scheduled sampling + loss {split_b['forward']:.2f}, backward "
        f"(with the clip) {split_b['backward']:.2f}, optimizer "
        f"{split_b['optimizer']:.2f} ms; device {sum(busy.values()):.2f} ms "
        f"a step, idle share {idle_b:.3f}; top kernels "
        f"{dict(list(busy.items())[:6])}; B={bs} x 10 s, float32, TF32 "
        f"off, on {card}")
    del state, model_b
    restore(c0)

    # (c) SCST of (b)'s best checkpoint: the torch engine, no kernel
    cfg_c = copy.deepcopy(base)
    cfg_c.update(model={"type": "ScstWrapper", "model": FAM_GRU_NODE},
                 resume=str(Path(exp_b) / "best.pth"),
                 rl={"max_length": L}, scheduled_sampling={"use": False})
    cfg_c["trainer"]["finetune"] = True
    cfg_c["optimizer"]["args"]["lr"] = 5e-5
    exp_c, times["c_train_s"], l_c = train_run(
        "gru_scst", cfg_c, "trainer.epochs=1",
        f"data.train.dataloader_args.num_samples={FAM_SCST_STEPS * bs}")
    curve_c = _epoch_curve(Path(exp_c) / "train.log", "loss", "val_cider")
    assert len(curve_c) == 1 and math.isfinite(curve_c[0][0]), \
        "family (c): SCST"
    if dev.type == "cuda":
        assert l_c["fused_logmel"] == 2 * FAM_SCST_STEPS + n_val, l_c
        assert l_c["fused_greedy"] == l_c["fused_beam"] == 0, l_c
    c0 = counts()
    cfg, ckpt = read_experiment(exp_c, "last.pth")
    model_c, tok = experiment_model(cfg, ckpt, dev)
    state = create_train_state(
        model_c, 5e-5, build_schedule(cfg["lr_scheduler"], 5e-5, 100, 20),
        1e-6, 1.0)
    key2refs = load_caption_json(cfg["data"]["train"]["dataset"]["args"][
        "caption"])
    scorer, rl_gen = FastCiderD(), torch.Generator(device=dev).manual_seed(
        SEED)
    parts = ("repack", "encode", "baseline", "sample", "rewards", "grad",
             "optimizer")
    rows, rewards = [], []
    for b in itertools.islice(build_dataloader(cfg["data"]["train"], tok),
                              FAM_WARMUP + FAM_STEP_TIMED):
        keys = [str(k) for k in b["audio_id"]]
        b = to_device(b, dev)
        mark("start")
        m = scst_step(state, b, keys, key2refs, tok.idx2word, L, 1.0,
                      rl_gen, scorer, None, mark=mark)
        torch.cuda.synchronize()
        prev, row = marks["start"], []
        for p_ in parts:
            row.append(prev.elapsed_time(marks[p_]))
            prev = marks[p_]
        rows.append(row)
        rewards.append((m["reward_sample"], m["reward_greedy"]))
    step_c, split_c = split_of(rows, parts)
    r_s, r_g = np.mean(rewards, 0).tolist()
    log(f"family (c): SCST of (b)'s best.pth, {FAM_SCST_STEPS} Runner.train "
        f"steps in {times['c_train_s']:.1f} s (epoch loss = -reward "
        f"{curve_c[0][0]:.4f}, val CIDEr-D {curve_c[0][1]:.4f}); timed step "
        f"median {step_c:.2f} ms over {FAM_STEP_TIMED}: "
        f"{ {k: round(v, 2) for k, v in split_c.items()} } ms; "
        f"reward_sample {r_s:.4f}, reward_greedy {r_g:.4f} (mean of "
        f"{len(rewards)} steps); launches {l_c} on {card}")
    assert all(map(math.isfinite, (r_s, r_g, step_c)))
    del state, model_c
    restore(c0)

    # (d) a Cnn14Transformer + TransformerDecoder captioner
    cfg_d = dict(copy.deepcopy(base), model=FAM_TRM_NODE)
    exp_d, times["d_train_s"], l_d = train_run(
        "cnn14trm", cfg_d, f"trainer.epochs={FAM_TRM_EPOCHS}",
        f"data.train.dataloader_args.num_samples={FAM_TRM_STEPS * bs}")
    c0 = counts()
    t0 = time.perf_counter()
    scores_d = runner.evaluate(exp_d, recipes.flagship_test(str(data)),
                               f"device={dev.type}", "resume=best.pth",
                               "caption_output=predictions/best_beam3.json",
                               "score_output=results/best_beam3.txt")
    times["d_evaluate_s"] = time.perf_counter() - t0
    n = counts()
    l_d.update({"eval_" + k: n[k] - c0[k] for k in n})
    curve_d = _epoch_curve(Path(exp_d) / "train.log", "loss", "val_cider")
    floats_d = {k: round(v, 4) for k, v in scores_d.items()
                if isinstance(v, float)}
    log(f"family (d): Cnn14Transformer + TransformerDecoder for "
        f"{len(curve_d)} epochs in {times['d_train_s']:.1f} s, loss "
        f"{curve_d[0][0]:.4f} -> {curve_d[-1][0]:.4f}, best val CIDEr-D "
        f"{max(c[1] for c in curve_d):.4f}; test beam 3 (best.pth, "
        f"{times['d_evaluate_s']:.1f} s) {json.dumps(floats_d)}; launches "
        f"{l_d} on {card}")
    if dev.type == "cuda":
        assert l_d["fused_greedy"] == FAM_TRM_EPOCHS * n_val, l_d
        assert l_d["eval_fused_beam"] == n_test, l_d
        assert l_d["fused_beam"] == l_d["eval_fused_greedy"] == 0, l_d
    assert floats_d and all(map(math.isfinite, floats_d.values()))
    # both kernels against their plain versions at these shapes
    packed, memkv, valid, g_mis, b_err, frames = decode_kernels_at(
        exp_d, "best.pth", recipes.flagship_test(str(data))["data"]["test"],
        dev, "family (d)")
    assert memkv.shape[3] == frames // 32 + 1, "family (d): memory length"
    c0 = counts()
    entries = [
        decode_entry("greedy", "cnn14trm", packed, memkv, valid,
                     l_d["fused_greedy"], float(g_mis), card),
        decode_entry("beam", "cnn14trm", packed, memkv, valid,
                     l_d["eval_fused_beam"], b_err, card)]
    del memkv
    restore(c0)

    # (e) the ensemble of (b) and (d): a GRU and a transformer member
    ens_cfg = recipes.recipe("synthetic_v2/ensemble.yaml", str(data))
    ens_cfg.update(experiment_path=[exp_b, exp_d], resume="best.pth",
                   output_path=str(root / "ensemble"))
    c0 = counts()
    t0 = time.perf_counter()
    scores_e = runner.ensemble_evaluate(ens_cfg, f"device={dev.type}")
    times["e_s"] = time.perf_counter() - t0
    n = counts()
    l_e = {k: n[k] - c0[k] for k in n}
    c0 = counts()
    members = [experiment_model(*read_experiment(e, "best.pth"), dev)[0]
               for e in (exp_b, exp_d)]
    cpu_members = [copy.deepcopy(m).cpu() for m in members]
    k = EVAL_ENSEMBLE_CPU
    test = next(iter(build_dataloader(recipes.flagship_test(str(data))[
        "data"]["test"], train=False)))
    wav = torch.as_tensor(test["wav"][:k]).float()
    wav_len = torch.as_tensor(test["wav_len"][:k]).long()
    card_seq = ensemble_generate(members, wav.to(dev), wav_len.to(dev),
                                 sample_method="beam", beam_size=3,
                                 max_length=L)["seq"].cpu()
    cpu_seq = ensemble_generate(cpu_members, wav, wav_len,
                                sample_method="beam", beam_size=3,
                                max_length=L)["seq"]
    e_mis = int((card_seq != cpu_seq).sum())
    floats_e = {k_: round(v, 4) for k_, v in scores_e.items()
                if isinstance(v, float)}
    log(f"family (e): ensemble of (b) and (d), beam 3 over {FAM_SIZES[2]} "
        f"test clips in {times['e_s']:.1f} s: {json.dumps(floats_e)}; "
        f"launches {l_e}; card vs CPU copies on {k} clips: "
        f"{e_mis}/{cpu_seq.numel()} tokens differ")
    assert e_mis <= MISMATCH_LIMIT * cpu_seq.numel(), "ensemble card vs CPU"
    if dev.type == "cuda":
        assert l_e["fused_logmel"] == 2 * n_test, l_e
    del members, cpu_members
    restore(c0)

    # (f) the conditioned decoders
    dec512 = {"emb_dim": 512, "d_model": 512}
    inner = {"type": "LabelSmoothingLoss", "args": {"smoothing": 0.1}}

    def cond_ds(split, kind):
        return {"type": "ConditionCaptionDataset", "args": {
            "features": {"wav": str(data / f"{split}_wav.csv")},
            "caption": str(data / f"{split}_text.json"),
            "condition": str(data / f"condition_{kind}.csv"),
            "orig_sr": SR_32K, "target_sr": SR_32K}}
    dscrm = {"vocab_size": len(tokenizer), "seed": SEED + 3}
    runs = {
        "condition_argmax": ("ConditionalBahAttnDecoder", "hm", {
            "type": "ConditionLossWrapper",
            "args": {"loss": inner, "dscrm": dscrm,
                     "sample_method": "argmax"}}),
        "condition_gumbel": ("ConditionalBahAttnDecoder", "hm", {
            "type": "ConditionLossWrapper",
            "args": {"loss": inner, "dscrm": dscrm,
                     "sample_method": "gumbel"}}),
        "specificity": ("SpecificityBahAttnDecoder", "spec", {
            "type": "SpecificityLossWrapper",
            "args": {"loss": inner,
                     "word_specificity": str(data / "word_specificity.npy"),
                     "sentence_reduce": "sum"}}),
        "struct": ("StructBahAttnDecoder", None, inner)}
    l_f = {"fused_greedy": 0, "fused_beam": 0, "fused_logmel": 0}
    cond_out = {}
    for name, (dec_type, kind, loss_node) in runs.items():
        cfg_f = copy.deepcopy(base)
        cfg_f["model"] = family_node(dec_type=dec_type, dec_args=dec512)
        cfg_f["loss"] = loss_node
        if kind:
            cfg_f["data"]["train"]["dataset"] = cond_ds("train", kind)
        exp_f, dt, l_ = train_run(
            name, cfg_f, "trainer.epochs=1",
            f"data.train.dataloader_args.num_samples="
            f"{FAM_COND_STEPS * bs}")
        l_f = {k_: l_f[k_] + l_[k_] for k_ in l_f}
        curve = _epoch_curve(Path(exp_f) / "train.log", "loss", "val_cider")
        assert len(curve) == 1 and math.isfinite(curve[0][0]), name
        c0 = counts()
        cfg, ckpt = read_experiment(exp_f, "last.pth")
        trained, tok = experiment_model(cfg, ckpt, dev)
        # the condition term on one batch, before and after the steps;
        # and that the term itself reaches the decoder: one train_step
        # (the runner's, which routes the batch's condition to the
        # decoder and the loss) with alpha 1 against the same step with
        # alpha 0 and against a repeat of that, at learning rate 0
        term = grad_gap = None
        if kind:
            init, _ = build_model_from_config(cfg["model"], len(tok))
            random_init(init, torch.Generator().manual_seed(cfg["seed"]))
            init = init.to(dev).eval()
            b = to_device(next(iter(build_dataloader(cfg["data"]["train"],
                                                     tok))), dev)
            gen = torch.Generator(device=dev)
            wrap = build_loss(cfg["loss"], generator=gen, device=dev)
            wrap0 = build_loss(dict(cfg["loss"], args=dict(
                cfg["loss"]["args"], alpha=0.0)), generator=gen, device=dev)
            plain_loss = build_loss(inner)

            def term_of(m):
                gen.manual_seed(SEED)
                with torch.no_grad():
                    out = m(b["wav"], b["wav_len"], b["cap"], b["cap_len"],
                            cond_kwargs={"condition": b["condition"]})
                    out.update(tgt=b["cap"][:, 1:], tgt_len=b["cap_len"] - 1,
                               conditions=b["condition"])
                    return float(wrap(out) - plain_loss(out))
            term = (term_of(init), term_of(trained))
            assert all(map(math.isfinite, term)), \
                f"family (f) {name}: the condition term is not finite"
            sgd = torch.optim.SGD(init.parameters(), lr=0.0)
            state_f = TrainState(init, sgd, torch.optim.lr_scheduler.LambdaLR(
                sgd, lambda _: 1.0), float("inf"))

            def decoder_grads(loss_fn):
                torch.manual_seed(SEED)
                gen.manual_seed(SEED)
                train_step(state_f, loss_fn, b)
                return [p.grad.detach().clone() if p.grad is not None
                        else torch.zeros_like(p)
                        for p in init.decoder.parameters()]

            def gap(x, y):
                return max(float((u - v).abs().max()) for u, v in zip(x, y))
            g0 = decoder_grads(wrap0)
            g1 = decoder_grads(wrap)
            grad_gap = (gap(g1, g0), gap(decoder_grads(wrap0), g0))
            del init, state_f, sgd, g0, g1
            assert math.isfinite(grad_gap[0]) and grad_gap[0] > max(
                10 * grad_gap[1], 1e-7), \
                f"family (f) {name}: the condition term does not reach " \
                f"the decoder's gradient {grad_gap}"
        # a decode with conditions drawn by RandomConditionDataset
        val_cfg = copy.deepcopy(cfg["data"]["val"])
        if kind:
            val_cfg["dataset"] = {"type": "RandomConditionDataset", "args": {
                "features": {"wav": str(data / "val_wav.csv")},
                "condition": str(data / f"condition_{kind}.csv"),
                "orig_sr": SR_32K, "target_sr": SR_32K, "seed": SEED}}
        vb = next(iter(build_dataloader(val_cfg, train=False)))
        wav = torch.as_tensor(vb["wav"]).to(dev).float()
        wav_len = torch.as_tensor(vb["wav_len"]).to(dev).long()
        cond = ({"condition": torch.as_tensor(vb["condition"]).to(dev)}
                if kind else {"structure": torch.randint(
                    0, 4, (wav.shape[0],), generator=torch.Generator(
                    ).manual_seed(SEED)).to(dev)})
        seq = generate(trained, wav, wav_len, sample_method="beam",
                       beam_size=3, max_length=L, cond_kwargs=cond)["seq"]
        assert seq.shape == (wav.shape[0], L) and bool(
            ((seq >= 0) & (seq < len(tok))).all()), name
        c_vals = (torch.as_tensor(vb["condition"])[:4].tolist()
                  if kind else cond["structure"][:4].tolist())
        log(f"family (f) {name}: {dec_type}, {FAM_COND_STEPS} steps in "
            f"{dt:.1f} s, epoch loss {curve[0][0]:.4f}, val CIDEr-D "
            f"{curve[0][1]:.4f}; condition term before / after the steps "
            f"{term}; decoder gradient max |alpha 1 - alpha 0| / |alpha 0 "
            f"- alpha 0| {grad_gap}; a beam-3 decode of {wav.shape[0]} "
            f"val clips with conditions {c_vals}...: first caption "
            f"{tok.decode(seq[:1].cpu().numpy())[0]!r}; launches {l_} on "
            f"{card}")
        cond_out[name] = {"loss": curve[0][0], "term": term,
                          "grad_gap": grad_gap}
        del trained
        restore(c0)

    launches = counts()
    log(f"family: launches on the path {launches} (the checks' and "
        f"timings' taken out) on {card}")
    if dev.type == "cuda":
        assert launches["fused_logmel"] > 0 and launches["fused_greedy"] > 0 \
            and launches["fused_beam"] > 0, launches
    # the quality bars last
    assert curve_b[-1][0] < curve_b[0][0], "family (b): the loss did not fall"
    assert max(c[1] for c in curve_b) > constant, \
        "family (b): the val score is no better than a constant caption"
    return {"launches": launches, "entries": entries, "encoders": enc_a,
            "xe": {"step_ms": step_b, "split": split_b, "idle": idle_b},
            "scst": {"step_ms": step_c, "split": split_c,
                     "reward_sample": r_s, "reward_greedy": r_g},
            "conditioned": cond_out, "times": times}


# -- phase 28: the feature-input path and the MBConv kernel's bf16 ---------

def bf16_walk(api, api16, lms64, feat64, audio, lens, dev, card):
    """Phase 28(a): the bf16 EffB2 encoder of phase 13 walked on folded
    weights, every stride-1 block through the MBConv kernel in the bf16
    work dtype, each held against ``mbconv_plain`` in bf16 on the same
    input (MBCONV_BF16_RTOL * max(1, max |plain|)); the walked ``attn_emb``
    against the bf16 cuDNN encoder's, within BF16_WALK_FACTOR times the
    bf16 encoder's own distance from the float32 encoder; the greedy
    captions of phase 4's 8 clips through each, equal or every diverging
    caption diverging first where the bf16 model's margin between the two
    words is below what bf16 moves it (PR 6's rule: the float32 model's
    margin against the bf16 model's, on the common prefix); then times per
    block at B=64 x 10 s (kernel, plain, the bf16 cuDNN ``MBConvBlock``,
    the bound: 1x1 products at the bf16 dense rate, bf16 activations)
    -> the kernels-line entry (launches: the walks of B=64 and of the 8
    clips)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from audiocaption_tpu_torch.hf_api import pad_bucket
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.ops import fused_mbconv as FM
    model16, model32 = api16.model, api.model
    enc16, enc32 = model16.encoder, model32.encoder
    wav8 = torch.from_numpy(pad_bucket(audio, SR)).to(dev)
    len8 = torch.from_numpy(lens).to(dev)
    with torch.no_grad():
        lms8, feat8 = model16.frontend(wav8), model16.mel.feat_len(len8)
        ref64, ref8 = enc16(lms64, feat64), enc16(lms8, feat8)
        f32_64 = enc32(lms64, feat64)
    torch.cuda.synchronize()
    FM.fused_mbconv_s1.launches = 0
    errs, inputs = [], []
    got64 = checked_walk(enc16, lms64, feat64, errs, inputs)
    got8 = checked_walk(enc16, lms8, feat8, [])
    torch.cuda.synchronize()
    launches = FM.fused_mbconv_s1.launches
    assert (launches > 0 or dev.type != "cuda") and \
        all(x.dtype == torch.bfloat16 for x in inputs)
    rel = [d / max(1.0, m) for d, m in errs]
    log(f"MBConv kernel (bf16) vs plain (bf16), bf16 EffB2, {len(errs)} "
        f"stride-1 blocks at B={lms64.shape[0]} x 10 s: max |diff| per block "
        f"{[f'{d:.3g}' for d, _ in errs]}, max relative {max(rel):.3g} "
        f"(limit {MBCONV_BF16_RTOL}); launches {launches} on {card}")
    assert len(errs) == 19 and max(rel) <= MBCONV_BF16_RTOL, \
        "bf16 MBConv kernel disagrees"
    a_walk, a_ref = got64["attn_emb"], ref64["attn_emb"]
    walk_err = float((a_walk - a_ref).abs().max())
    bf16_err = float((a_ref - f32_64["attn_emb"]).abs().max())
    walk_f32 = float((a_walk - f32_64["attn_emb"]).abs().max())
    scale = float(a_ref.abs().max())
    log(f"bf16 walked encoder vs bf16 cuDNN encoder: attn_emb max |diff| "
        f"{walk_err:.4g} (max |ref| {scale:.4g}); bf16 cuDNN vs float32 "
        f"encoder {bf16_err:.4g}, walked vs float32 {walk_f32:.4g} (limit "
        f"{BF16_WALK_FACTOR} x {bf16_err:.4g})")
    assert scale > 0.1 and walk_err <= BF16_WALK_FACTOR * bf16_err, \
        "bf16 walked encoder disagrees"

    ids = {name: generate(model16, enc=e, sample_method="greedy",
                          max_length=L)["seq"]
           for name, e in (("walked", got8), ("cuDNN", ref8))}
    with torch.no_grad():
        enc32_8 = enc32(lms8, feat8)
    mis, ties = int((ids["walked"] != ids["cuDNN"]).sum()), 0
    for r in torch.nonzero((ids["walked"] != ids["cuDNN"]).any(-1)
                           ).flatten().tolist():
        t = int(torch.nonzero(ids["walked"][r] != ids["cuDNN"][r])[0])
        prefix = torch.cat([ids["cuDNN"].new_full((1,), model16.special.bos),
                            ids["cuDNN"][r, :t]])[None]
        lp = {}
        for name, m, e in (("bf16", model16, ref8), ("f32", model32,
                                                     enc32_8)):
            with torch.no_grad():
                logit = m.decoder(prefix, e["attn_emb"][r:r + 1],
                                  e["attn_emb_len"][r:r + 1])["logit"]
            lp[name] = F.log_softmax(logit[0, -1].double(), -1)
        a, b = int(ids["cuDNN"][r, t]), int(ids["walked"][r, t])
        margin = float(lp["bf16"][a] - lp["bf16"][b])
        moved = abs(float((lp["bf16"][a] - lp["bf16"][b])
                          - (lp["f32"][a] - lp["f32"][b])))
        assert margin <= moved, (f"bf16 walk diverges at margin "
                                 f"{margin:.4g} > bf16 move {moved:.4g}")
        ties += 1
    log(f"greedy captions from the bf16 walked vs bf16 cuDNN encoder, 8 "
        f"clips: {mis}/{ids['cuDNN'].numel()} tokens differ, {ties} captions "
        f"diverging where the margin is below bf16's move; first caption "
        f"{ids['walked'][0][:8].tolist()} on {card}")

    blocks = [b for b in enc16._blocks if b.plan["stride"] == 1]
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0, mm=0, other=0,
               nbytes=0)
    with torch.no_grad():
        for block, x in zip(blocks, inputs):
            spec, w = FM.spec_of(block), FM.pack_mbconv(block)
            k_ms = cuda_ms(lambda: FM.fused_mbconv_s1(x, w, spec), 10)
            p_ms = cuda_ms(lambda: FM.mbconv_plain(x, w, spec), 3)
            c_ms = cuda_ms(lambda: block(x), 10)
            mm, other, nbytes = mbconv_work(spec, x.shape[0], x.shape[2],
                                            x.shape[3], w["w_ser"].shape[1],
                                            act_bytes=2)
            bound, _, _ = mbconv_bound_ms(mm, other, nbytes, BF16_FLOPS)
            for key, v in (("ms", k_ms), ("plain", p_ms), ("lib", c_ms),
                           ("bound", bound), ("mm", mm), ("other", other),
                           ("nbytes", nbytes)):
                tot[key] += v
    _, _, by = mbconv_bound_ms(tot["mm"], tot["other"], tot["nbytes"],
                               BF16_FLOPS)
    FM.fused_mbconv_s1.launches = launches
    log(f"fused_mbconv (bf16), 19 stride-1 blocks summed, B="
        f"{lms64.shape[0]} x 10 s: "
        f"{tot['ms']:.3f} ms (plain bf16 {tot['plain']:.3f}, bf16 cuDNN "
        f"blocks {tot['lib']:.3f}, bound {tot['bound']:.4f} ms by {by}: "
        f"{tot['mm']} 1x1 ops at the bf16 rate, {tot['other']} other ops, "
        f"{tot['nbytes']} bytes) on {card}")
    return {"name": "fused_mbconv[bf16]", "route": "cuda",
            "source": "audiocaption_tpu_torch/csrc/fused_mbconv.cu",
            "replaces": "audiocaption_tpu/ops/pallas_mbconv.py:102",
            "launches": launches, "max_abs_err": max(d for d, _ in errs),
            "ms": tot["ms"], "plain_ms": tot["plain"],
            "bound_ms": tot["bound"], "bound_by": by,
            "library_ms": tot["lib"]}


def calibration_batch(data, dev):
    """The first 32 train clips of a corpus as one float32 batch on
    ``dev`` (the BN calibration of a random encoder)."""
    import torch
    from audiocaption_tpu_torch.data.collate import pad_sequences
    from audiocaption_tpu_torch.data.dataset import InferenceDataset
    ds = InferenceDataset({"wav": str(data / "train_wav.csv")})
    wav, lens = pad_sequences([ds[i]["wav"] for i in range(min(32, len(ds)))])
    return {"wav": torch.from_numpy(wav).to(dev),
            "wav_len": torch.from_numpy(lens).long().to(dev)}


def feature_path(dev, card):
    """:func:`_feature_path` in a temporary directory, which is removed
    also when a check fails."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_features_"))
    try:
        return _feature_path(root, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _feature_path(root, dev, card):
    """Phase 28(b)-(g) on a reduced corpus v1 (FEAT_SIZES clips of 10 s at
    32 kHz): (b) a ``cnn14rnn_trm``-width captioner (configs/synthetic/
    cnn14rnn_trm.yaml's model, seeded random weights, BN jittered) saved
    as an experiment, then ``prepare_features --format npy`` of it on the
    three splits (the log-mel kernel); (c) ``m2_trm.yaml`` at its full
    width (d_model 256, 2 + 2 layers, 4 heads, m 40, input 512) with its
    device-resident banks and the prefetcher, FEAT_EPOCHS epoch(s) and the
    val score; (d) a full resume of (c) (``trainer.finetune: False``) for
    one more epoch: the epoch, ``lr_count`` and the optimizer state go on;
    (e) ``test_m2.yaml`` through ``Runner.evaluate`` at beam 3 (the engine:
    M2 is not on the kernels); (f) an ``AudioTransformerEncoder`` +
    ``TransformerDecoder`` on the same features (input width read off the
    first row), its val score through the greedy kernel and its evaluate
    through the beam kernel; (g) the flagship's model with ``prune_ratio``
    0.3 on the corpus's waves at 16 kHz, its val score through the greedy
    kernel.  Launch counts set to 0 before (b) and read after (g)."""
    import pickle
    import numpy as np
    import torch
    import yaml
    from audiocaption_tpu_torch.cli import recipes
    from audiocaption_tpu_torch.cli.prepare_features import (
        experiment_encoder, write_features)
    from audiocaption_tpu_torch.cli.run import Runner, build_tokenizer
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.models.zoo import random_init
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.training.checkpoint import (
        model_variables, save_checkpoint)
    from audiocaption_tpu_torch.utils.config import build_model_from_config

    data, t_gen = shared_corpus("v1", FEAT_SIZES)
    FG.reset_launches(FG.fused_greedy_decode)
    FB.reset_launches(FB.fused_beam_decode)
    FL.fused_logmel.launches = 0
    times = {"corpus_s": t_gen}
    dv = f"device={dev.type}"

    # (b) a cnn14rnn_trm experiment and its features
    t0 = time.perf_counter()
    src_cfg = recipes.m2_source_train(str(data))
    tokenizer = build_tokenizer(src_cfg["data"]["train"]["collate_fn"][
        "tokenizer"])
    model, _ = build_model_from_config(src_cfg["model"],
                                       vocab_size=len(tokenizer))
    random_init(model, torch.Generator().manual_seed(SEED))
    model.to(dev)
    calibrate_encoder_bn(model, calibration_batch(data, dev))
    src = root / "cnn14rnn_trm" / "seed_1"
    src.mkdir(parents=True)
    (src / "config.yaml").write_text(yaml.safe_dump(src_cfg))
    save_checkpoint(str(src / "swa.pth"), model_variables(model),
                    tokenizer_state=tokenizer.state_dict())
    encode, bucket = experiment_encoder(str(src), "swa.pth", dev)
    n = {split: write_features(
        str(data / f"{split}_wav.csv"),
        str(data / "features_cnn14rnn" / split), encode, bucket, dev,
        batch_size=32, fmt="npy") for split in ("train", "val", "test")}
    feats = torch.from_numpy(np.load(next(iter(
        (data / "features_cnn14rnn" / "train" / "attn").glob("*.npy")))))
    times["prepare_features_s"] = time.perf_counter() - t0
    log(f"28(b): prepare_features --format npy of a cnn14rnn_trm experiment:"
        f" {n} clips, a row {tuple(feats.shape)}, finite "
        f"{bool(torch.isfinite(feats).all())}, {times['prepare_features_s']:.1f}"
        f" s; log-mel launches so far {FL.fused_logmel.launches}")
    assert feats.shape[-1] == 512 and bool(torch.isfinite(feats).all())
    assert float(feats.std()) > 0

    # (c) M2 at full width, banks and prefetch; (d) its full resume
    runner = Runner()
    m2_over = [dv, f"experiment_path={root}/m2",
               f"trainer.epochs={FEAT_EPOCHS}",
               "trainer.include_optim_in_ckpt=True"]
    t0 = time.perf_counter()
    m2 = Path(runner.train(recipes.m2_train(str(data)), *m2_over))
    first = pickle.loads((m2 / "last.pth").read_bytes())
    m2_over[2] = f"trainer.epochs={FEAT_EPOCHS + 1}"
    runner.train(recipes.m2_train(str(data)), *m2_over,
                 f"resume={m2}/last.pth", "trainer.finetune=False")
    after = pickle.loads((m2 / "last.pth").read_bytes())
    times["m2_train_s"] = time.perf_counter() - t0
    text = (m2 / "train.log").read_text()
    curve = _epoch_curve(m2 / "train.log", "loss", "val_cider")
    steps = first["lr_count"] // FEAT_EPOCHS
    log(f"28(c-d): M2 {len(curve)} epochs; checkpoint epoch / lr_count "
        f"{first['epoch']} / {first['lr_count']} -> after the full resume "
        f"{after['epoch']} / {after['lr_count']}; optimizer state "
        f"{'optimizer' in after}")
    assert f"train wav bank on {dev.type}" in text and \
        f"val wav bank on {dev.type}" in text, \
        "the device-resident banks were not built"
    assert f"(epoch {FEAT_EPOCHS + 1})" in text, "the full resume restarted"
    assert after["epoch"] == FEAT_EPOCHS + 1 and \
        after["lr_count"] == first["lr_count"] + steps > 0
    assert after["not_improve_cnt"] >= 0 and after["monitor_state"]
    assert all(math.isfinite(c[0]) for c in curve)

    # (e) test_m2.yaml through Runner.evaluate, beam 3
    t0 = time.perf_counter()
    scores = runner.evaluate(str(m2), recipes.m2_test(str(data)), dv)
    times["m2_evaluate_s"] = time.perf_counter() - t0
    floats = {k: round(v, 4) for k, v in scores.items()
              if isinstance(v, float)}
    log(f"28(e): test_m2.yaml beam 3 (swa.pth) {json.dumps(floats)}")
    assert floats and all(math.isfinite(v) for v in floats.values())

    # (f) AudioTransformerEncoder + TransformerDecoder on the features
    cfg = recipes.m2_train(str(data))
    cfg["model"] = {
        "type": "TransformerModel",
        "encoder": {"type": "AudioTransformerEncoder",
                    "args": {"d_model": 256, "nlayers": 2, "nhead": 4,
                             "dropout": 0.1}},
        "decoder": {"type": "TransformerDecoder",
                    "args": {"emb_dim": 256, "attn_emb_dim": 256,
                             "nlayers": 2, "dropout": 0.1}}}
    t0 = time.perf_counter()
    g0, b0 = FG.fused_greedy_decode.launches, FB.fused_beam_decode.launches
    trm = Path(runner.train(cfg, dv, f"experiment_path={root}/trm",
                            f"trainer.epochs={FEAT_EPOCHS}"))
    trm_scores = runner.evaluate(str(trm), recipes.m2_test(str(data)), dv)
    times["trm_s"] = time.perf_counter() - t0
    g1, b1 = FG.fused_greedy_decode.launches, FB.fused_beam_decode.launches
    log(f"28(f): AudioTransformerEncoder + TransformerDecoder: greedy "
        f"launches {g1 - g0} (val score), beam launches {b1 - b0} (evaluate);"
        f" test cider {trm_scores['cider']:.4f}")
    assert "from the first row of data.train" in \
        (trm / "train.log").read_text()
    assert dev.type != "cuda" or (
        g1 - g0 == FEAT_EPOCHS * -(-FEAT_SIZES[1] // 32)
        and b1 - b0 == -(-FEAT_SIZES[2] // 32))

    # (g) the flagship's model pruned at 0.3, on the corpus's waves
    t0 = time.perf_counter()
    pruned = Path(runner.train(
        recipes.recipe("synthetic/effb2_trm.yaml", str(data)), dv,
        f"experiment_path={root}/pruned", "trainer.epochs=1",
        "model.encoder.args.prune_ratio=0.3"))
    times["pruned_s"] = time.perf_counter() - t0
    g2 = FG.fused_greedy_decode.launches
    text = (pruned / "train.log").read_text()
    log(f"28(g): pruned EffB2 (0.3): greedy launches {g2 - g1} (val score)")
    assert "encoder pruned: prune_ratio 0.3" in text
    assert dev.type != "cuda" or g2 - g1 == -(-FEAT_SIZES[1] // 32)

    launches = {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_beam": FB.fused_beam_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}
    log(f"28: feature-path launches {launches}; times "
        f"{json.dumps({k: round(v, 1) for k, v in times.items()})} on {card}")
    assert dev.type != "cuda" or all(v > 0 for v in launches.values()), \
        launches
    return {"launches": launches, "times": times}


# -- phase 29: the item-8 encoders and the PANNs classifiers ---------------

def item8_model(name: str, seed: int = SEED):
    """An item-8 encoder or PANNs classifier at its published width (the
    JAX builder's defaults; ``uit_xs`` with its target length 1008),
    seeded random weights, every BN's statistics moved off the identity
    and ``bn0`` at a dB log-mel's (mean -40, variance 400) -> (module,
    its sample rate)."""
    import torch
    from audiocaption_tpu_torch.models import htsat, mobilenet_v3, panns
    from audiocaption_tpu_torch.models import resnext, uit
    from audiocaption_tpu_torch.models.zoo import random_init
    make = {
        "mobilenet_v3": lambda: mobilenet_v3.MobileNetV3Encoder("mn10"),
        "htsat": htsat.HtsatEncoder,
        "uit_xs": lambda: uit.UitEncoder(uit.UIT_VARIANTS["uit_xs"](
            outputdim=537, target_length=1008, classifier=False)),
        "esresnext": lambda: resnext.ESResNeXtFBSPEncoder(
            resnext.ESResNeXtFBSP(n_fft=2048, hop_length=561,
                                  win_length=1654, window="blackmanharris",
                                  normalized=True, apply_attention=True,
                                  classifier=False)),
        "panns_cnn10": panns.Cnn10,
        "panns_wavegram": panns.Wavegram_Logmel_Cnn14}[name]
    m = make()
    gen = torch.Generator().manual_seed(seed)
    random_init(m, gen)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                n = mod.num_features
                mod.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                mod.running_var.copy_(1 + torch.rand(n, generator=gen))
        bn0 = (m.trunk.init_bn[1] if name == "uit_xs"
               else getattr(m, "bn0", None))
        if bn0 is not None:
            bn0.running_mean.fill_(-40.0)
            bn0.running_var.fill_(400.0)
    return m.eval(), (16000 if name == "uit_xs" else SR_32K)


def item8_forward(name, model, front, wav, wav_len):
    """One eval forward as its caller runs it: an encoder over the log-mel
    of ``front`` and its frame counts, ESResNeXt over the wave, the PANNs
    classifiers as ``prepare_features`` calls them."""
    if name == "esresnext":
        return model(wav, wav_len)
    lms = front(wav)
    if name == "panns_cnn10":
        return model(lms)
    if name == "panns_wavegram":
        return model(wav, lms)
    return model(lms, front.config.feat_len(wav_len))


def item8_encoders(dev, card) -> dict:
    """Phase 29(a): each item-8 encoder and PANNs classifier
    (:func:`item8_model`) on B=ENC_B clips of ENC_SECONDS / 2 to
    ENC_SECONDS at its rate (the first ENC_CPU_CLIPS of full length), in
    ``eval()``: those clips' outputs against a CPU copy of the same
    weights within ENC_RTOL * max(1, max |CPU|); the forward's time (CUDA
    events, median of FAM_TIMED after FAM_WARMUP), peak memory and
    log-mel kernel launches.  -> {name: {...}} and the path's log-mel
    launches (the checks' taken out)."""
    import copy
    import torch
    from audiocaption_tpu_torch.models.uit import UIT_MEL_16K
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.ops.frontend import (
        CNN14_MEL_32K, LogMelFrontend)
    out, launches = {}, 0
    for i, name in enumerate(ITEM8):
        cpu_model, sr = item8_model(name, SEED + i)
        model = copy.deepcopy(cpu_model).to(dev)
        front = LogMelFrontend(UIT_MEL_16K if sr == 16000 else CNN14_MEL_32K)
        gen = torch.Generator().manual_seed(SEED + 29 + i)
        n = ENC_SECONDS * sr
        wav = torch.randn(ENC_B, n, generator=gen) * 0.1
        wav_len = torch.randint(n // 2, n + 1, (ENC_B,), generator=gen)
        wav_len[:ENC_CPU_CLIPS] = n
        wav = wav * (torch.arange(n)[None] < wav_len[:, None])
        w, wl = wav.to(dev), wav_len.to(dev)
        front_d = front.to(dev)
        with torch.no_grad():
            n0 = FL.fused_logmel.launches
            got = item8_forward(name, model, front_d, w, wl)
            launches += FL.fused_logmel.launches - n0
            ms = median_ms(lambda: item8_forward(name, model, front_d, w, wl))
            _sync(dev)
            torch.cuda.reset_peak_memory_stats()
            item8_forward(name, model, front_d, w, wl)
            _sync(dev)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            k = ENC_CPU_CLIPS
            want = item8_forward(name, cpu_model, front.cpu(), wav[:k],
                                 wav_len[:k])
        errs = {}
        for key, ref in want.items():
            g = got[key][:k].cpu()
            if not torch.is_floating_point(ref):
                assert torch.equal(g, ref), (name, key)
                continue
            assert bool(torch.isfinite(got[key]).all()), (name, key)
            errs[key] = float((g.double() - ref.double()).abs().max()) / max(
                1.0, float(ref.abs().max()))
        shapes = {key: list(v.shape) for key, v in got.items()}
        n_params = sum(p.numel() for p in model.parameters())
        log(f"29(a) {name}: {n_params / 1e6:.2f} M parameters; outputs "
            f"{shapes}; card vs CPU copy on {k} clips, max |diff| / max(1, "
            f"max |CPU|) {errs} (limit {ENC_RTOL}); forward (eval) "
            f"{ms:.3f} ms per batch of {ENC_B} x {ENC_SECONDS} s at {sr} Hz "
            f"(CUDA events, median of {FAM_TIMED}), peak {peak:.2f} GiB, "
            f"float32, TF32 off, on {card}")
        assert all(e <= ENC_RTOL for e in errs.values()), (name, errs)
        out[name] = {"ms": ms, "peak_gib": peak, "params_m": n_params / 1e6,
                     "shapes": shapes, "cpu_err": errs}
        del model, cpu_model, got
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        # every 32 kHz model but ESResNeXt (its own frontend) took one
        assert launches == 4, launches
    return {"encoders": out, "logmel_launches": launches}


def item8_path(dev, card):
    """:func:`_item8` in a temporary directory, which is removed also
    when a check fails."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_item8_"))
    try:
        return _item8(root, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _item8(root, dev, card):
    """Phase 29(b)-(d) on a reduced corpus v1 (ENC_SIZES clips of 10 s at
    32 kHz): (b) the ``encoders`` recipe's HTS-AT captioner
    (``recipes.encoders_train``: cnn14rnn_trm.yaml with the HTS-AT node,
    its 2-layer transformer decoder) trained ENC_EPOCHS epochs with
    ``Runner.train`` (the rate decayed to ENC_FINAL_LR): the loss falls,
    the val CIDEr-D (through the greedy kernel) beats the best constant
    caption's, ``Runner.evaluate`` at beam 3 through the beam kernel, both
    kernels against their plain versions at its shapes (S=32) and timed,
    the train step split and idle share; (c) the ESResNeXt-FBSP captioner
    (``input_mode="raw_wav"``) for ENC_RX_STEPS ``Runner.train`` steps,
    then ENC_RX_STEPS steps on one batch, whose loss in ``eval()`` (no
    dropout) falls; its
    ``Runner.evaluate`` through the beam kernel (S=7) and the beam kernel
    against plain; (d) ``prepare_features`` with ``htsat``,
    ``panns_cnn10`` and ``panns_wavegram`` (a checkpoint of
    :func:`item8_model`'s weights) on ENC_FEATURE_CLIPS val clips, the
    card's rows against the CPU's within ENC_RTOL.  The launch counts are
    set to 0 before (b) and read after (d), the checks' and timings'
    launches taken back out."""
    import itertools
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli import recipes
    from audiocaption_tpu_torch.cli.prepare_features import (
        named_encoder, write_features)
    from audiocaption_tpu_torch.cli.run import (
        Runner, build_dataloader, experiment_model, read_experiment,
        to_device)
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.losses.loss import build_loss
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.optim.schedules import build_schedule
    from audiocaption_tpu_torch.training.trainer import (
        create_train_state, train_step)

    def counts():
        return {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_beam": FB.fused_beam_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}

    def restore(c):
        (FG.fused_greedy_decode.launches, FB.fused_beam_decode.launches,
         FL.fused_logmel.launches) = (c["fused_greedy"], c["fused_beam"],
                                      c["fused_logmel"])
    data, t_gen = shared_corpus("v1", ENC_SIZES)
    times = {"corpus_s": t_gen}
    constant, const_cap = constant_caption_cider(
        str(data / "train_text.json"), str(data / "val_text.json"))
    FG.reset_launches(FG.fused_greedy_decode)
    FB.reset_launches(FB.fused_beam_decode)
    FL.fused_logmel.launches = 0
    runner = Runner()
    over = [f"device={dev.type}",
            f"data.train.dataloader_args.num_workers={SYN_WORKERS}"]
    marks = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[name] = e

    def run(name, cfg, *extra):
        c0 = counts()
        t_ = time.perf_counter()
        exp = runner.train(cfg, *over, f"experiment_path={root}/{name}",
                           *extra)
        times[f"{name}_train_s"] = time.perf_counter() - t_
        for line in (Path(exp) / "train.log").read_text().splitlines():
            log(f"29 {name} {line}")
        n = counts()
        return exp, {k: n[k] - c0[k] for k in n}

    def evaluate(name, exp, resume):
        c0 = counts()
        t_ = time.perf_counter()
        scores = runner.evaluate(
            exp, recipes.encoders_test(str(data), name), f"device={dev.type}",
            f"resume={resume}", "caption_output=predictions/beam3.json",
            "score_output=results/beam3.txt")
        times[f"{name}_evaluate_s"] = time.perf_counter() - t_
        n = counts()
        return ({k: round(v, 4) for k, v in scores.items()
                 if isinstance(v, float)},
                {k: n[k] - c0[k] for k in n})

    # (b) the HTS-AT captioner of the encoders recipe
    n_items = sum(len(a["captions"]) for a in json.loads(
        (data / "train_text.json").read_text())["audios"])
    cfg_b = recipes.encoders_train(str(data), "htsat")
    cfg_b["swa"] = {"use": False}
    bs = cfg_b["data"]["train"]["dataloader_args"]["batch_size"]
    n_val = -(-ENC_SIZES[1] // cfg_b["data"]["val"]["dataloader_args"][
        "batch_size"])
    n_test = -(-ENC_SIZES[2] // recipes.encoders_test(str(data), "htsat")[
        "data"]["test"]["dataloader_args"]["batch_size"])
    exp_b, l_b = run("htsat", cfg_b, f"trainer.epochs={ENC_EPOCHS}",
                     f"lr_scheduler.args.final_lrs={ENC_FINAL_LR:.7f}")
    curve_b = _epoch_curve(Path(exp_b) / "train.log", "loss", "val_cider")
    scores_b, le_b = evaluate("htsat", exp_b, "best.pth")
    steps_b = ENC_EPOCHS * (n_items // bs)
    log(f"29(b): HTS-AT + 2-layer TransformerDecoder (the encoders recipe) "
        f"for {len(curve_b)} epochs ({steps_b} steps) in "
        f"{times['htsat_train_s']:.1f} s; loss {curve_b[0][0]:.4f} -> "
        f"{curve_b[-1][0]:.4f}; best val CIDEr-D "
        f"{max(c[1] for c in curve_b):.4f} (best constant caption "
        f"{constant:.4f}: {const_cap!r}); test beam 3 (best.pth) "
        f"{json.dumps(scores_b)}; launches {l_b}, evaluate {le_b} on {card}")
    if dev.type == "cuda":
        assert l_b["fused_greedy"] == ENC_EPOCHS * n_val, l_b
        assert l_b["fused_logmel"] == steps_b + ENC_EPOCHS * n_val, l_b
        assert l_b["fused_beam"] == 0 and le_b["fused_beam"] == n_test, le_b
    assert len(curve_b) == ENC_EPOCHS and scores_b
    packed, memkv, valid, g_mis, b_err, _ = decode_kernels_at(
        exp_b, "best.pth", recipes.encoders_test(str(data), "htsat")[
            "data"]["test"], dev, "29(b) htsat")
    assert memkv.shape[3] == 32, "29(b): HTS-AT's memory is 32 steps"
    c0 = counts()
    entries = [
        decode_entry("greedy", "htsat", packed, memkv, valid,
                     l_b["fused_greedy"], float(g_mis), card),
        decode_entry("beam", "htsat", packed, memkv, valid,
                     le_b["fused_beam"], b_err, card)]
    restore(c0)
    # the step split and idle share, on the trained weights
    c0 = counts()
    cfg, ckpt = read_experiment(exp_b, "last.pth")
    model_b, tok = experiment_model(cfg, ckpt, dev)
    opt = cfg["optimizer"]["args"]
    state = create_train_state(
        model_b, opt["lr"], build_schedule(cfg["lr_scheduler"], opt["lr"],
                                           100, 20),
        opt.get("weight_decay", 0.0), 1.0)
    loss_fn = build_loss(cfg["loss"])
    batches = [to_device(b, dev) for b in itertools.islice(
        build_dataloader(cfg["data"]["train"], tok),
        FAM_WARMUP + FAM_STEP_TIMED)]
    ss_gen = torch.Generator().manual_seed(SEED)
    rows = []
    for b in batches:
        mark("start")
        train_step(state, loss_fn, b, ss_ratio=torch.tensor(0.85),
                   generator=ss_gen, mark=mark)
        _sync(dev)
        rows.append([marks["start"].elapsed_time(marks["forward"]),
                     marks["forward"].elapsed_time(marks["backward"]),
                     marks["backward"].elapsed_time(marks["optimizer"])])
    rows = np.asarray(rows[FAM_WARMUP:])
    step_b = float(np.median(rows.sum(1)))
    split_b = dict(zip(("forward", "backward", "optimizer"),
                       np.median(rows, 0).tolist()))
    per_kernel = {}
    busy = device_split(lambda: train_step(
        state, loss_fn, batches[0], ss_ratio=torch.tensor(0.85),
        generator=ss_gen), iters=3, launches=per_kernel)
    idle_b = 1 - sum(busy.values()) / step_b
    n_kernels = sum(per_kernel.values())
    log(f"29(b) step: median {step_b:.2f} ms over {FAM_STEP_TIMED} steps "
        f"({bs / step_b * 1e3:.1f} clips/s): forward with scheduled "
        f"sampling + loss {split_b['forward']:.2f}, backward (with the "
        f"clip) {split_b['backward']:.2f}, optimizer "
        f"{split_b['optimizer']:.2f} ms; device {sum(busy.values()):.2f} ms "
        f"a step in {n_kernels:.0f} kernel launches "
        f"({(step_b - sum(busy.values())) / max(n_kernels, 1) * 1e3:.1f} "
        f"us of idle per launch), idle share {idle_b:.3f}; top kernels "
        f"{dict(list(busy.items())[:6])}; most launched "
        f"{dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6])}; "
        f"B={bs} x 10 s, float32, TF32 off, on {card}")
    del state, model_b, batches
    restore(c0)

    # (c) the ESResNeXt-FBSP captioner (raw_wav)
    cfg_c = recipes.encoders_train(str(data), "esresnext")
    cfg_c["swa"] = {"use": False}
    exp_c, l_c = run("esresnext", cfg_c, "trainer.epochs=1",
                     f"data.train.dataloader_args.num_samples="
                     f"{ENC_RX_STEPS * bs}")
    curve_c = _epoch_curve(Path(exp_c) / "train.log", "loss", "val_cider")
    assert len(curve_c) == 1 and math.isfinite(curve_c[0][0]), curve_c
    c0 = counts()
    cfg, ckpt = read_experiment(exp_c, "last.pth")
    model_c, tok = experiment_model(cfg, ckpt, dev)
    state = create_train_state(
        model_c, 5e-4, build_schedule(cfg["lr_scheduler"], 5e-4, 100, 0),
        1e-6, 1.0)
    batch = to_device(next(iter(build_dataloader(cfg["data"]["train"],
                                                 tok))), dev)
    loss_fn = build_loss(cfg["loss"])

    def batch_loss():
        """The batch's teacher-forced loss in ``eval()`` (no dropout)."""
        model_c.eval()
        with torch.no_grad():
            out = model_c(batch["wav"], batch["wav_len"], batch["cap"],
                          batch["cap_len"])
            out.update(tgt=batch["cap"][:, 1:], tgt_len=batch["cap_len"] - 1)
            return float(loss_fn(out))
    losses = [batch_loss()]
    for _ in range(ENC_RX_STEPS):
        train_step(state, loss_fn, batch)
    losses.append(batch_loss())
    restore(c0)
    del state, model_c
    scores_c, le_c = evaluate("esresnext", exp_c, "last.pth")
    log(f"29(c): ESResNeXt-FBSP + 2-layer TransformerDecoder (raw_wav), "
        f"{ENC_RX_STEPS} Runner.train steps in "
        f"{times['esresnext_train_s']:.1f} s (epoch loss "
        f"{curve_c[0][0]:.4f}); then {ENC_RX_STEPS} steps on one batch: "
        f"its loss in eval() {losses[0]:.4f} -> {losses[1]:.4f}; test beam 3 "
        f"{json.dumps(scores_c)}; launches {l_c}, evaluate {le_c} on {card}")
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0], \
        "29(c): the ESResNeXt captioner's loss did not fall"
    if dev.type == "cuda":
        assert le_c["fused_beam"] == n_test and l_c["fused_logmel"] == 0 \
            and le_c["fused_logmel"] == 0, (l_c, le_c)
    _, memkv, valid, _, _, _ = decode_kernels_at(
        exp_c, "last.pth", recipes.encoders_test(str(data), "esresnext")[
            "data"]["test"], dev, "29(c) esresnext", greedy=False)
    assert memkv.shape[3] == 7, "29(c): ESResNeXt's memory is 7 steps"
    # the few-step decoder ends its beams after a few steps: the S=7
    # yardstick is (b)'s trained decoder (the same widths) over this memory
    c0 = counts()
    _, b_err_c = check_decode_kernels(
        packed, memkv, valid, "29(c) (b)'s decoder over the esresnext "
        "memory", greedy=False)
    entries.append(decode_entry("beam", "esresnext", packed, memkv, valid,
                                le_c["fused_beam"], b_err_c, card))
    restore(c0)

    # (d) prepare_features with the item-8 extractors, card vs CPU
    t0 = time.perf_counter()
    wav_csv = data / "features_clips.csv"
    rows = (data / "val_wav.csv").read_text().splitlines()
    wav_csv.write_text("\n".join(rows[:1 + ENC_FEATURE_CLIPS]) + "\n")
    feats = {}
    for i, name in enumerate(("htsat", "panns_cnn10", "panns_wavegram")):
        module, _ = item8_model(name, SEED + 40 + i)
        ckpt_path = root / f"{name}.pth"
        torch.save(module.state_dict(), ckpt_path)
        rows_by = {}
        for where in (dev, torch.device("cpu")):
            c0 = counts()
            encode, bucket = named_encoder(name, str(ckpt_path), where)
            out_dir = root / "features" / f"{name}_{where.type}"
            n = write_features(str(wav_csv), str(out_dir), encode, bucket,
                               where, batch_size=ENC_FEATURE_CLIPS,
                               fmt="npy")
            assert n == ENC_FEATURE_CLIPS
            if where.type == "cpu":
                restore(c0)
            rows_by[where.type] = {
                kind: {p.stem: np.load(p) for p in (out_dir / kind).glob(
                    "*.npy")}
                for kind in ("fc", "attn", "probs") if (out_dir / kind
                                                        ).is_dir()}
        got, want = rows_by[dev.type], rows_by["cpu"]
        errs = {}
        for kind, ref in want.items():
            assert set(got[kind]) == set(ref), (name, kind)
            errs[kind] = max(
                float(np.abs(got[kind][a] - r).max()) / max(
                    1.0, float(np.abs(r).max()))
                for a, r in ref.items() if got[kind][a].shape == r.shape)
            assert all(got[kind][a].shape == r.shape
                       for a, r in ref.items()), (name, kind)
        feats[name] = errs
        log(f"29(d): prepare_features --encoder {name}: {n} clips, the "
            f"card's rows vs the CPU's, max |diff| / max(1, max |CPU|) "
            f"{errs} (limit {ENC_RTOL}); kinds {sorted(want)}")
        assert all(e <= ENC_RTOL for e in errs.values()), (name, errs)
    times["features_s"] = time.perf_counter() - t0

    launches = counts()
    rounded = {k: round(v, 1) for k, v in times.items()}
    log(f"29: launches on the path {launches} (the checks' and timings' "
        f"taken out); times {json.dumps(rounded)} on {card}")
    if dev.type == "cuda":
        # the val scores of (b) and (c), their evaluations, every 32 kHz
        # log-mel model's encode
        assert launches["fused_greedy"] == l_b["fused_greedy"] + \
            l_c["fused_greedy"] and launches["fused_beam"] == \
            le_b["fused_beam"] + le_c["fused_beam"], launches
        assert launches["fused_logmel"] > 0, launches
    # the quality bars last
    assert curve_b[-1][0] < curve_b[0][0], "29(b): the loss did not fall"
    assert max(c[1] for c in curve_b) > constant, \
        "29(b): the val score is no better than a constant caption"
    return {"launches": launches, "entries": entries, "times": times,
            "xe": {"step_ms": step_b, "split": split_b, "idle": idle_b,
                   "launches": n_kernels},
            "features": feats, "constant": constant,
            "best_val_cider": max(c[1] for c in curve_b)}


# -- phase 30: item 8b, the conditioned transformer decoders and styles ----

def keyword_path(dev, card):
    """:func:`_keyword` in a temporary directory, which is removed also
    when a check fails (the corpus is phase 25's, kept for the run)."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_keyword_"))
    try:
        return _keyword(root, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _keyword(root, dev, card):
    """Phase 30 on phase 25's temporal corpus (SYN_TEMPORAL_SIZES clips of
    10 s at 32 kHz), each clip's keywords the multi-hot of its ground-truth
    events (527 columns, one ``.npy`` a clip in ``root``:
    ``recipes.write_keyword_rows``).  (a) The keyword captioner of
    ``recipes.keyword_train`` (cnn14rnn_trm's Cnn14 + 3-layer BiGRU(256)
    encoder, a ``KeywordProbTransformerDecoder`` at the JAX builder's
    defaults, scheduled sampling off) trained KW_EPOCHS epochs with
    ``Runner.train`` (the rate decayed to KW_FINAL_LR): the loss falls;
    the val CIDEr-D of ``generate(..., cond_kwargs={"event": keywords})``
    (torch engine, greedy; no kernel takes a condition) beats the best
    constant caption's; the same decode with the keywords zeroed differs
    on at least one clip; the runner's own val score (decoded without the
    keywords, ROADMAP Queue 3 L) is printed beside it; KW_CPU_CLIPS clips
    decoded on a CPU copy give the card's tokens or diverge first at a
    near tie (SYN_TIE); the log-mel kernel on the first batch within
    LOGMEL_DB_ATOL of plain or no further from float64; the step split
    (CUDA events) and idle share; the log-mel kernel once an encode (a
    train step, a val batch).  (b) An ``EventTransformerDecoder`` over the
    same encoder for KW_EVENT_STEPS ``Runner.train`` steps on the same
    events (the keyword rows ride its ``event`` argument): finite losses
    and a conditioned greedy decode.  (c) A ``StyleCaptionModel``
    (``family_node``'s Cnn10 and a ``StyleBahAttnDecoder`` at emb and
    d_model 512) for KW_STYLE_STEPS ``Runner.train`` steps, then
    KW_STYLE_BATCH_STEPS steps on one batch whose loss in ``eval()``
    falls, then a greedy decode with each one-hot ``style_weight``
    through ``style_of_weight``.  The log-mel kernel's count is set to 0
    before (a) and read after (c), the checks' and timings' launches taken
    back out."""
    import copy
    import itertools
    import numpy as np
    import torch
    import torch.nn.functional as F
    from audiocaption_tpu_torch.cli import recipes
    from audiocaption_tpu_torch.cli.run import (
        Runner, build_dataloader, experiment_model, read_experiment,
        to_device)
    from audiocaption_tpu_torch.data.dataset import load_caption_json
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.losses.loss import build_loss
    from audiocaption_tpu_torch.metrics.tokenize import ptb_tokenize
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.models.transformer_decoder import (
        EventTransformerDecoder, KeywordProbTransformerDecoder)
    from audiocaption_tpu_torch.native import FastCiderD
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.optim.schedules import build_schedule
    from audiocaption_tpu_torch.training.trainer import (
        create_train_state, train_step)

    def counts():
        return {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_beam": FB.fused_beam_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}

    def restore(c):
        (FG.fused_greedy_decode.launches, FB.fused_beam_decode.launches,
         FL.fused_logmel.launches) = (c["fused_greedy"], c["fused_beam"],
                                      c["fused_logmel"])
    times = {}
    t0 = time.perf_counter()
    data, times["corpus_s"] = shared_corpus("temporal", SYN_TEMPORAL_SIZES)
    kw_dir = root / "keywords"
    for split in ("train", "val", "test"):
        recipes.write_keyword_rows(str(data / f"{split}_sed.json"),
                                   str(kw_dir))
    times["keyword_rows_s"] = time.perf_counter() - t0 - times["corpus_s"]
    constant, const_cap = constant_caption_cider(
        str(data / "train_text.json"), str(data / "val_text.json"))
    base = recipes.keyword_train(str(data), str(kw_dir))
    base["swa"] = {"use": False}
    bs = base["data"]["train"]["dataloader_args"]["batch_size"]
    n_items = sum(len(a["captions"]) for a in json.loads(
        (data / "train_text.json").read_text())["audios"])
    n_val = -(-SYN_TEMPORAL_SIZES[1]
              // base["data"]["val"]["dataloader_args"]["batch_size"])
    over = [f"device={dev.type}",
            f"data.train.dataloader_args.num_workers={SYN_WORKERS}"]
    runner = Runner()
    FG.reset_launches(FG.fused_greedy_decode)
    FB.reset_launches(FB.fused_beam_decode)
    FL.fused_logmel.launches = 0

    def run(name, cfg, *extra):
        c0 = counts()
        t_ = time.perf_counter()
        exp = runner.train(cfg, *over, f"experiment_path={root}/{name}",
                           *extra)
        times[f"{name}_train_s"] = time.perf_counter() - t_
        for line in (Path(exp) / "train.log").read_text().splitlines():
            log(f"30 {name} {line}")
        n = counts()
        return exp, {k: n[k] - c0[k] for k in n}

    def val_batches(cfg):
        for b in build_dataloader(cfg["data"]["val"], train=False):
            yield (b["audio_id"], torch.as_tensor(b["wav"]).to(dev).float(),
                   torch.as_tensor(b["wav_len"]).to(dev).long(),
                   torch.as_tensor(b["keyword"]).to(dev).float())

    # (a) the keyword captioner
    exp_a, l_a = run("keyword", copy.deepcopy(base),
                     f"trainer.epochs={KW_EPOCHS}",
                     f"lr_scheduler.args.final_lrs={KW_FINAL_LR:.7f}")
    curve = _epoch_curve(Path(exp_a) / "train.log", "loss", "val_cider")
    steps_a = KW_EPOCHS * (n_items // bs)
    cfg, ckpt = read_experiment(exp_a, "last.pth")
    model, tok = experiment_model(cfg, ckpt, dev)
    assert type(model.decoder) is KeywordProbTransformerDecoder
    refs = load_caption_json(str(data / "val_text.json"))
    preds = {"keyword": {}, "zeroed": {}}
    first = None
    c_dec = counts()
    for ids, wav, wav_len, kw in val_batches(cfg):
        seq = generate(model, wav, wav_len, sample_method="greedy",
                       max_length=L, cond_kwargs={"event": kw})["seq"]
        c_chk = counts()
        zero = generate(model, wav, wav_len, sample_method="greedy",
                        max_length=L, cond_kwargs={
                            "event": torch.zeros_like(kw)})["seq"]
        restore(c_chk)
        if first is None:
            first = (wav, wav_len, kw, seq)
        for name, s in (("keyword", seq), ("zeroed", zero)):
            for aid, cap in zip(ids, tok.decode(s.cpu().numpy())):
                preds[name][str(aid)] = [cap]
    l_dec = {k: v - c_dec[k] for k, v in counts().items()}
    scorer = FastCiderD()
    cider = {name: scorer.compute_score(
        ptb_tokenize({k: refs[k] for k in p}), ptb_tokenize(p))[0]
        for name, p in preds.items()}
    moved = sum(preds["keyword"][k] != preds["zeroed"][k]
                for k in preds["keyword"])
    log(f"30(a): {type(model.decoder).__name__} (emb "
        f"{model.decoder.emb_dim}, {model.decoder.nlayers} layers, "
        f"{model.decoder.keyword_classes_num} keyword classes) over "
        f"{type(model.encoder).__name__} for {len(curve)} epochs "
        f"({steps_a} steps) in {times['keyword_train_s']:.1f} s; loss "
        f"{curve[0][0]:.4f} -> {curve[-1][0]:.4f}; val CIDEr-D greedy "
        f"(torch engine, last.pth) with the keywords {cider['keyword']:.4f}, "
        f"keywords zeroed {cider['zeroed']:.4f} ({moved}/{len(preds['keyword'])}"
        f" captions moved); the runner's val score (no keywords) "
        f"{[round(c[1], 4) for c in curve]}; best constant caption "
        f"{constant:.4f}: {const_cap!r}; e.g. "
        f"{list(preds['keyword'].items())[:2]}; launches {l_a} train, "
        f"{l_dec} keyword decode on {card}")
    if dev.type == "cuda":
        assert l_a["fused_logmel"] == steps_a + KW_EPOCHS * n_val, l_a
        assert l_dec["fused_logmel"] == n_val, l_dec
        assert l_a["fused_greedy"] == l_a["fused_beam"] == 0, l_a
    assert moved > 0, "30(a): the keywords do not reach the decode"

    # the card's tokens against a CPU copy's on KW_CPU_CLIPS clips
    c0 = counts()
    wav, wav_len, kw, seq = first
    k = KW_CPU_CLIPS
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        enc = cpu.encode(wav[:k].cpu(), wav_len[:k].cpu())
        cpu_seq = generate(cpu, enc=enc, sample_method="greedy",
                           max_length=L, cond_kwargs={
                               "event": kw[:k].cpu()})["seq"]
        card_seq = seq[:k].cpu()
        ties = 0
        for r in torch.nonzero((card_seq != cpu_seq).any(-1)).flatten(
                ).tolist():
            t = int(torch.nonzero(card_seq[r] != cpu_seq[r])[0])
            prefix = torch.cat([cpu_seq.new_full((1,), cpu.special.bos),
                                cpu_seq[r, :t]])[None]
            logit = cpu.decoder(prefix, enc["attn_emb"][r:r + 1],
                                enc["attn_emb_len"][r:r + 1],
                                event=kw[r:r + 1].cpu())["logit"]
            lp = F.log_softmax(logit[0, -1].double(), -1)
            gap = abs(float(lp[cpu_seq[r, t]] - lp[card_seq[r, t]]))
            assert gap <= SYN_TIE, f"30(a): card vs CPU diverge at gap {gap}"
            ties += 1
    cpu_mis = int((card_seq != cpu_seq).sum())
    del cpu, enc
    # the log-mel kernel on the first batch against plain and float64
    with torch.no_grad():
        kernel = model.frontend(wav)
        plain = FL.fused_logmel_plain(wav, model.frontend.basis,
                                      model.frontend.mel_fb,
                                      model.frontend.config)
        f64 = float64_logmel(wav, model.frontend)
    lm_err = float((kernel - plain).abs().max())
    err64 = float((kernel.double() - f64).abs().max())
    plain64 = float((plain.double() - f64).abs().max())
    del kernel, plain, f64
    log(f"30(a): {k} val clips on a CPU copy, with the keywords: "
        f"{cpu_mis}/{card_seq.numel()} tokens apart from the card's, "
        f"{ties} captions diverging at a near tie (log-prob gap <= "
        f"{SYN_TIE}); log-mel kernel vs fused_logmel_plain on the batch "
        f"{tuple(wav.shape)}: max |diff| {lm_err:.3g} dB (limit "
        f"{LOGMEL_DB_ATOL}); vs float64 {err64:.3g} dB, plain vs float64 "
        f"{plain64:.3g} dB")
    assert lm_err <= LOGMEL_DB_ATOL or err64 <= plain64, \
        "30(a): log-mel kernel disagrees"

    # the step split and idle share, on the trained weights
    marks = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[name] = e
    opt = cfg["optimizer"]["args"]
    state = create_train_state(
        model, opt["lr"], build_schedule(cfg["lr_scheduler"], opt["lr"],
                                         100, 20),
        opt.get("weight_decay", 0.0), 1.0)
    loss_fn = build_loss(cfg["loss"])
    batches = [to_device(b, dev) for b in itertools.islice(
        build_dataloader(cfg["data"]["train"], tok),
        FAM_WARMUP + FAM_STEP_TIMED)]
    rows = []
    for b in batches:
        mark("start")
        train_step(state, loss_fn, b, mark=mark)
        _sync(dev)
        rows.append([marks["start"].elapsed_time(marks["forward"]),
                     marks["forward"].elapsed_time(marks["backward"]),
                     marks["backward"].elapsed_time(marks["optimizer"])])
    rows = np.asarray(rows[FAM_WARMUP:])
    step_ms = float(np.median(rows.sum(1)))
    split = dict(zip(("forward", "backward", "optimizer"),
                     np.median(rows, 0).tolist()))
    per_kernel = {}
    busy = device_split(lambda: train_step(state, loss_fn, batches[0]),
                        iters=3, launches=per_kernel)
    idle = 1 - sum(busy.values()) / step_ms
    log(f"30(a) step: median {step_ms:.2f} ms over {FAM_STEP_TIMED} steps "
        f"({bs / step_ms * 1e3:.1f} clips/s): forward (teacher forcing, the "
        f"keywords in) + loss {split['forward']:.2f}, backward (with the "
        f"clip) {split['backward']:.2f}, optimizer "
        f"{split['optimizer']:.2f} ms; device {sum(busy.values()):.2f} ms a "
        f"step in {sum(per_kernel.values()):.0f} kernel launches, idle "
        f"share {idle:.3f}; top kernels {dict(list(busy.items())[:6])}; "
        f"B={bs} x 10 s, float32, TF32 off, on {card}")
    del state, model, batches
    restore(c0)

    # (b) an EventTransformerDecoder on the same events
    cfg_b = copy.deepcopy(base)
    cfg_b["model"]["decoder"]["type"] = "EventTransformerDecoder"
    exp_b, l_b = run("event", cfg_b, "trainer.epochs=1",
                     f"data.train.dataloader_args.num_samples="
                     f"{KW_EVENT_STEPS * bs}")
    curve_b = _epoch_curve(Path(exp_b) / "train.log", "loss", "val_cider")
    cfg, ckpt = read_experiment(exp_b, "last.pth")
    model, tok = experiment_model(cfg, ckpt, dev)
    assert type(model.decoder) is EventTransformerDecoder
    c_dec = counts()
    ids, wav, wav_len, kw = next(val_batches(cfg))
    seq = generate(model, wav, wav_len, sample_method="greedy",
                   max_length=L, cond_kwargs={"event": kw})["seq"]
    l_b["fused_logmel"] += counts()["fused_logmel"] - c_dec["fused_logmel"]
    log(f"30(b): EventTransformerDecoder ({model.decoder.event_classes} "
        f"classes) over {type(model.encoder).__name__}, {KW_EVENT_STEPS} "
        f"Runner.train steps in {times['event_train_s']:.1f} s, epoch loss "
        f"{curve_b[0][0]:.4f}; a greedy decode of {wav.shape[0]} val clips "
        f"with their events: {tok.decode(seq[:2].cpu().numpy())}; launches "
        f"{l_b} on {card}")
    assert len(curve_b) == 1 and math.isfinite(curve_b[0][0]), curve_b
    assert seq.shape == (wav.shape[0], L) and bool(
        ((seq >= 0) & (seq < len(tok))).all()), "30(b): decode"
    del model

    # (c) a StyleCaptionModel: Cnn10 + StyleBahAttnDecoder
    cfg_c = copy.deepcopy(base)
    cfg_c["model"] = dict(family_node(
        dec_type="StyleBahAttnDecoder",
        dec_args={"emb_dim": 512, "d_model": 512}),
        type="captioning.models.style_model.StyleCaptionModel")
    for split in ("train", "val"):
        cfg_c["data"][split]["dataset"]["type"] = {
            "train": "CaptionDataset", "val": "InferenceDataset"}[split]
        cfg_c["data"][split]["dataset"]["args"].pop("keyword_prob")
    exp_c, l_c = run("style", cfg_c, "trainer.epochs=1",
                     f"data.train.dataloader_args.num_samples="
                     f"{KW_STYLE_STEPS * bs}")
    curve_c = _epoch_curve(Path(exp_c) / "train.log", "loss", "val_cider")
    assert len(curve_c) == 1 and math.isfinite(curve_c[0][0]), curve_c
    cfg, ckpt = read_experiment(exp_c, "last.pth")
    model, tok = experiment_model(cfg, ckpt, dev)
    c0 = counts()
    state = create_train_state(
        model, 5e-4, build_schedule(cfg["lr_scheduler"], 5e-4, 100, 0),
        1e-6, 1.0)
    batch = to_device(next(iter(build_dataloader(cfg["data"]["train"],
                                                 tok))), dev)
    loss_fn = build_loss(cfg["loss"])

    def batch_loss():
        """The batch's teacher-forced loss in ``eval()`` (no dropout), the
        style inferred from each caption."""
        model.eval()
        with torch.no_grad():
            out = model(batch["wav"], batch["wav_len"], batch["cap"],
                        batch["cap_len"])
            out.update(tgt=batch["cap"][:, 1:], tgt_len=batch["cap_len"] - 1)
            return float(loss_fn(out))
    losses = [batch_loss()]
    for _ in range(KW_STYLE_BATCH_STEPS):
        train_step(state, loss_fn, batch)
    losses.append(batch_loss())
    restore(c0)
    model.eval()
    n_styles = model.style_bank.n_styles
    c_dec = counts()
    ids, wav, wav_len, _ = next(val_batches(cfg_b))
    with torch.no_grad():
        enc = model.encode(wav, wav_len)
        styles = []
        for s in range(n_styles):
            w = torch.zeros(wav.shape[0], n_styles, device=dev)
            w[:, s] = 1.0
            styles.append(generate(model, enc=enc, sample_method="greedy",
                                   max_length=L, cond_kwargs={
                                       "style": model.style_of_weight(w)}
                                   )["seq"])
    l_c["fused_logmel"] += counts()["fused_logmel"] - c_dec["fused_logmel"]
    log(f"30(c): StyleCaptionModel (Cnn10, StyleBahAttnDecoder emb and "
        f"d_model 512, {n_styles} styles, a {model.ref_encoder.nlayers}-"
        f"layer {model.ref_encoder.d_model}-wide reference encoder), "
        f"{KW_STYLE_STEPS} Runner.train steps in "
        f"{times['style_train_s']:.1f} s (epoch loss {curve_c[0][0]:.4f}); "
        f"then {KW_STYLE_BATCH_STEPS} steps on one batch: its loss in eval() "
        f"{losses[0]:.4f} -> {losses[1]:.4f}; greedy with each one-hot "
        f"style_weight: first captions "
        f"{[tok.decode(s[:1].cpu().numpy())[0] for s in styles]}, "
        f"{sum(int((s != styles[0]).any()) for s in styles[1:])} of "
        f"{n_styles - 1} other styles moved the batch; launches {l_c} on "
        f"{card}")
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0], \
        "30(c): the style captioner's loss did not fall"
    assert all(s.shape == (wav.shape[0], L) and bool(
        ((s >= 0) & (s < len(tok))).all()) for s in styles), "30(c)"
    del state, model

    launches = counts()
    rounded = {k_: round(v, 1) for k_, v in times.items()}
    log(f"30: launches on the path {launches} (the checks' and timings' "
        f"taken out); times {json.dumps(rounded)} on {card}")
    if dev.type == "cuda":
        # no kernel decodes a conditioned decoder; every encode through
        # the log-mel kernel
        assert launches["fused_greedy"] == launches["fused_beam"] == 0
        assert launches["fused_logmel"] == l_a["fused_logmel"] + \
            l_dec["fused_logmel"] + l_b["fused_logmel"] + \
            l_c["fused_logmel"] > 0, launches
    # the quality bars last
    assert curve[-1][0] < curve[0][0], "30(a): the loss did not fall"
    assert cider["keyword"] > constant, \
        "30(a): the keyword decode is no better than a constant caption"
    return {"launches": launches, "logmel_err": err64, "cider": cider,
            "constant": constant, "runner_val": [c[1] for c in curve],
            "xe": {"step_ms": step_ms, "split": split, "idle": idle},
            "style_losses": losses, "times": times}


# -- phase 31: the host tools, word2vec, profiling, the demo, the DFT input
# -- type, data and tensor parallelism, dataset preparation ---------------

def queue_m_logmel(dev, card):
    """Phase 31(a): the batches of ROADMAP Queue 3 M.  Corpus v2 (seed 0,
    phase 24's) cut to its first QM_SIZES[0] train clips, their
    speed-perturbed copy (``speed_perturb --compute``, 0.9 and 1.1), and
    the first QM_BATCHES batches of the aug loader of
    ``cli/recipes.py::aug_train`` (shuffled from ``torch.manual_seed(SEED)``;
    batches of 32, each padded to its longest clip).  Each batch is held
    by Queue 3 C's rule, unchanged: the log-mel kernel within
    LOGMEL_DB_ATOL of ``fused_logmel_plain``, or no further from the
    float64 log-mel than the float32 plain version.  Printed per batch and
    per clip: how many clips the kernel lies further from float64 than
    plain.  -> {"launches", "err": kernel vs plain, worst batch}."""
    import shutil
    import tempfile
    import torch
    from audiocaption_tpu_torch.cli import recipes
    from audiocaption_tpu_torch.cli.data_tools import speed_perturb
    from audiocaption_tpu_torch.cli.run import build_dataloader, to_device
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    from audiocaption_tpu_torch.ops import frontend as TF
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    data, _ = shared_corpus("v2", QM_SIZES)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_qm_"))
    try:
        t0 = time.perf_counter()
        out = speed_perturb(str(data), str(root), compute=True,
                            wav_csv=str(data / "train_wav.csv"),
                            text_json=str(data / "train_text.json"))
        Path(out["wav_csv"]).replace(root / "train_wav.csv")
        Path(out["text_json"]).replace(root / "train_text.json")
        t_sp = time.perf_counter() - t0
        cfg = recipes.aug_train(str(data), str(root))
        tokenizer = DictTokenizer(str(data / "vocab.pkl"))
        front = TF.LogMelFrontend(TF.CNN14_MEL_32K).to(dev)
        torch.manual_seed(SEED)
        FL.fused_logmel.launches = 0
        worst, further, clips = (0.0, 0.0, 0.0), 0, 0
        loader = build_dataloader(cfg["data"]["train_aug"], tokenizer)
        for i, batch in zip(range(QM_BATCHES), loader):
            wav = to_device(batch, dev)["wav"]
            with torch.no_grad():
                kernel = front(wav)
                plain = FL.fused_logmel_plain(wav, front.basis, front.mel_fb,
                                              front.config)
                f64 = float64_logmel(wav, front)
            err = float((kernel - plain).abs().max())
            k64 = (kernel.double() - f64).abs().amax((1, 2))
            p64 = (plain.double() - f64).abs().amax((1, 2))
            err64, plain64 = float(k64.max()), float(p64.max())
            n_far = int((k64 > p64).sum())
            further, clips = further + n_far, clips + len(k64)
            log(f"31(a) aug batch {i} {tuple(wav.shape)}: log-mel kernel vs "
                f"fused_logmel_plain max |diff| {err:.3g} dB (limit "
                f"{LOGMEL_DB_ATOL}); vs float64 {err64:.3g} dB, plain vs "
                f"float64 {plain64:.3g} dB; clips where the kernel lies "
                f"further from float64 than plain: {n_far}/{len(k64)}")
            assert bool(torch.isfinite(kernel).all())
            assert err <= LOGMEL_DB_ATOL or err64 <= plain64, \
                f"31(a): log-mel kernel disagrees on aug batch {i}"
            worst = max(worst, (err, err64, plain64))
        launches = FL.fused_logmel.launches
        log(f"31(a): corpus v2's first {QM_SIZES[0]} train clips perturbed "
            f"in {t_sp:.1f} s; {i + 1} aug batches, {launches} log-mel "
            f"launches; worst batch: kernel vs plain {worst[0]:.3g} dB, vs "
            f"float64 {worst[1]:.3g} (plain {worst[2]:.3g}); the kernel "
            f"further from float64 than plain on {further}/{clips} clips on "
            f"{card}")
        assert launches == i + 1, launches
        return {"launches": launches, "err": worst[0]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def logmel_compute_dtype(dev, card):
    """Phase 31(b), item 9: the DFT input type.  The flagship's 16 kHz
    log-mel (``EFFB2_MEL_16K``, the plain path) at B=64 x 10 s with
    ``compute_dtype=torch.bfloat16``: held against its CPU copy within
    LOGMEL_DB_ATOL, and its distance from the float64 log-mel printed
    beside float32's; the 32 kHz frontend given bfloat16 takes the kernel,
    which ignores the option: equal to the float32 frontend's, bit for
    bit.  -> {"launches"}."""
    import torch
    from audiocaption_tpu_torch.ops import frontend as TF
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    gen = torch.Generator().manual_seed(SEED + 31)
    out = {}
    for name in ("EFFB2_MEL_16K", "CNN14_MEL_32K"):
        cfg = getattr(TF, name)
        wav = (torch.randn(B_LOGMEL, 10 * cfg.sample_rate, generator=gen)
               * 0.1)
        f32 = TF.LogMelFrontend(cfg).to(dev)
        bf16 = TF.LogMelFrontend(cfg, compute_dtype=torch.bfloat16).to(dev)
        n0 = FL.fused_logmel.launches
        with torch.no_grad():
            got = bf16(wav.to(dev))
            ref32 = f32(wav.to(dev))
            f64 = float64_logmel(wav.to(dev), f32)
        launched = FL.fused_logmel.launches - n0
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        if cfg.sample_rate == 32000:
            log(f"31(b) {name}, B={B_LOGMEL} x 10 s: compute_dtype=bfloat16 "
                f"on the kernel path equals float32 bit for bit: "
                f"{bool(torch.equal(got, ref32))}; {launched} kernel "
                f"launches")
            assert launched == 2 and torch.equal(got, ref32), name
            out["launches"] = launched
            continue
        cpu = TF.LogMelFrontend(cfg, compute_dtype=torch.bfloat16)(wav)
        err = float((got.cpu() - cpu).abs().max())
        e16 = float((got.double() - f64).abs().max())
        e32 = float((ref32.double() - f64).abs().max())
        log(f"31(b) {name}, B={B_LOGMEL} x 10 s, compute_dtype=bfloat16 "
            f"(plain path): card vs CPU copy max |diff| {err:.3g} dB (limit "
            f"{LOGMEL_DB_ATOL}); from the float64 log-mel: bfloat16 "
            f"{e16:.4g} dB, float32 {e32:.4g} dB; {launched} kernel launches "
            f"on {card}")
        assert launched == 0 and err <= LOGMEL_DB_ATOL, name
    return out


# experiments of the training phases that phase 31(d) serves through the
# demo: name -> the directory of their config.yaml and checkpoint, under
# the corpora's temporary directory
_KEPT = {}


def keep_experiment(exp, name: str, ckpt: str) -> None:
    """Copy experiment ``exp``'s ``config.yaml`` and checkpoint ``ckpt``
    under the run's temporary directory, as ``name`` (phase 31(d))."""
    import shutil
    dst = _corpus_dir("kept", (0,)) / name
    dst.mkdir(parents=True, exist_ok=True)
    for f in ("config.yaml", ckpt):
        shutil.copy(Path(exp) / f, dst / f)
    _KEPT[name] = dst / ckpt


def word2vec_path(dev, card):
    """Phase 31(c): ``create_word_embedding`` by word2vec on the card over
    the shared corpus v2's train captions (W2V_EPOCHS epochs, embedding
    256, the flagship decoder's width), its negatives drawn on the card
    (``train_word2vec``'s generator, recorded by ``draw_negatives``); the
    same call on the CPU copy with those draws: the ``.npy`` within
    W2V_RTOL_OF_MAX of the largest |w| (test_torch_word_embedding.py's
    bound); the card's own draws give the same vectors as the recorded
    ones; the matrix installed into a full-width transformer decoder on
    the card.  -> seconds of the card's training."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli import data_tools as DT
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    from audiocaption_tpu_torch.models.transformer_decoder import (
        TransformerDecoder)
    from audiocaption_tpu_torch.utils import word_embedding as WE
    data, _ = shared_corpus("v2", SYN_V2_SIZES)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_w2v_"))
    try:
        caps = str(data / "train_text.json")
        sents = [c["tokens"].split() for a in json.loads(
            Path(caps).read_text())["audios"] for c in a["captions"]]
        kw = dict(caption_file=caps, epochs=W2V_EPOCHS, seed=SEED)
        neg = WE.draw_negatives(sents, epochs=W2V_EPOCHS, seed=SEED,
                                device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        own = DT.create_word_embedding(str(data / "vocab.pkl"), W2V_EMB,
                                       str(root / "own.npy"), **kw,
                                       device=dev.type)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        got = DT.create_word_embedding(
            str(data / "vocab.pkl"), W2V_EMB, str(root / "card.npy"), **kw,
            device=dev.type, negative_ids=[n.cpu().numpy() for n in neg])
        t0 = time.perf_counter()
        cpu = DT.create_word_embedding(
            str(data / "vocab.pkl"), W2V_EMB, str(root / "cpu.npy"), **kw,
            device="cpu", negative_ids=[n.cpu().numpy() for n in neg])
        t_cpu = time.perf_counter() - t0
        bound = W2V_RTOL_OF_MAX * float(np.abs(cpu).max())
        err = float(np.abs(got - cpu).max())
        err_own = float(np.abs(own - got).max())
        tok = DictTokenizer(str(data / "vocab.pkl"))
        dec = TransformerDecoder(emb_dim=W2V_EMB, vocab_size=len(tok),
                                 attn_emb_dim=512).to(dev)
        WE.install_word_embedding(dec, got)
        installed = bool(torch.equal(dec.word_embedding.weight.detach().cpu(),
                                     torch.from_numpy(got)))
        log(f"31(c) word2vec: {len(sents)} captions, vocabulary {len(tok)}, "
            f"{len(neg)} steps of {neg[0].shape[0]} pairs, embedding "
            f"{W2V_EMB}, {W2V_EPOCHS} epochs: card {t_card:.2f} s, CPU copy "
            f"{t_cpu:.2f} s; card vs CPU copy on the card's draws max |diff| "
            f"{err:.3g} (bound {bound:.3g}); the card's own draws vs the "
            f"recorded ones {err_own:.3g}; installed into a {W2V_EMB}-wide "
            f"decoder: {installed} on {card}")
        assert np.isfinite(got).all() and err <= bound and err_own <= bound
        assert installed
        return t_card
    finally:
        shutil.rmtree(root, ignore_errors=True)


def demo_path(dev, card):
    """Phase 31(d): the demo's model path (``cli/demo.py``'s ``main``, its
    stdin REPL fed DEMO_CLIPS wav paths of corpus v2's test split) on the
    kept 32 kHz ``cnn14rnn_trm`` of phase 26 (its log-mel through the
    kernel) and phase 24's flagship (16 kHz); each printed caption equals
    the port's ``generate`` (beam 3) on the same clip.  -> the log-mel
    launches of the two demo runs."""
    import contextlib
    import io
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli import demo as DEMO
    from audiocaption_tpu_torch.cli.run import Runner
    from audiocaption_tpu_torch.data.dataset import read_wav
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    data, _ = shared_corpus("v2", SYN_V2_SIZES)
    rows = (data / "test_wav.csv").read_text().splitlines()[1:1 + DEMO_CLIPS]
    paths = [r.split("\t")[1] for r in rows]
    launches = 0
    for name in ("cnn14rnn_trm_aug", "flagship"):
        ckpt = _KEPT[name]
        stdin = io.StringIO("\n".join(paths) + "\n")
        out = io.StringIO()
        n0 = FL.fused_logmel.launches
        old_stdin = sys.stdin
        sys.stdin = stdin
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                DEMO.main(["--checkpoint", str(ckpt), "--device", dev.type])
            t_demo = time.perf_counter() - t0
        finally:
            sys.stdin = old_stdin
        n = FL.fused_logmel.launches - n0
        launches += n
        lines = out.getvalue().splitlines()
        _, model, tok = Runner()._load_experiment(str(ckpt.parent),
                                                  ckpt.name, dev)
        want = []
        for path in paths:
            sr, x = read_wav(path)
            wav = DEMO.normalize_audio(sr, x, model.mel.sample_rate)
            with torch.no_grad():
                seq = generate(model, torch.from_numpy(wav[None]).to(dev),
                               torch.tensor([len(wav)], device=dev),
                               sample_method="beam", beam_size=3)["seq"]
            want.append(tok.decode(seq.cpu().numpy())[0])
        log(f"31(d) demo on {name} ({model.mel.sample_rate} Hz): "
            f"{len(paths)} paths in {t_demo:.1f} s, log-mel kernel launches "
            f"{n}; captions {lines[1:]}; equal to generate's: "
            f"{lines[1:] == want} on {card}")
        assert lines[0].startswith("gradio not installed")
        assert lines[1:] == want, (lines, want)
        if model.mel.sample_rate == 32000:
            assert n == len(paths), n
    return launches


def flops_path(api, dev, card):
    """Phase 31(e): ``flops_estimate`` of the flagship's eval forward (the
    teacher-forced forward of ``bench.py``'s FLOP count: the frontend,
    EffB2 and the decoder over the 20 inputs of 21-token captions) at
    B=32 x 10 s, against an
    analytic count of its products (every ``Conv2d`` and ``Linear`` module
    by its shapes, plus the frontend's DFT and mel products, the
    attentions' q / k / v projections, scores and contexts, and the tied
    classifier): within FLOPS_RTOL; ``mfu`` over the forward's median time
    (CUDA events) against the card's dense bf16 rate; ``host_rss_gb``.
    -> (FLOPs, ms)."""
    import statistics
    import torch
    from audiocaption_tpu_torch.utils import profiling as P
    model = api.model
    B, T = FLOPS_B, FLOPS_SECONDS * SR
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    wav = torch.randn(B, T, generator=gen, device=dev) * 0.1
    wav_len = torch.full((B,), T, dtype=torch.long, device=dev)
    Lc = L + 1
    cap = torch.randint(4, V, (B, Lc), generator=gen, device=dev)
    cap[:, 0] = 1
    cap_len = torch.full((B,), Lc, dtype=torch.long, device=dev)

    def forward():
        with torch.no_grad():
            return model(wav, wav_len, cap, cap_len)

    model.eval()
    est = P.flops_estimate(forward)
    count = {"modules": 0}

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
            count["modules"] += 2 * out.numel() * k
        else:
            count["modules"] += 2 * out.numel() * mod.in_features
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        forward()
    finally:
        for h in handles:
            h.remove()
    cfg, dec = model.mel, model.decoder
    frames, F_ = T // cfg.hop + 1, cfg.n_fft // 2 + 1
    S = int(model.encode(wav[:1], wav_len[:1])["attn_emb"].shape[1])
    E, T_ = dec.emb_dim, int(forward()["logit"].shape[1])   # Lc - 1 inputs
    front = 2 * B * frames * cfg.n_fft * 2 * F_ + 2 * B * frames * F_ * \
        cfg.n_mels
    per_layer = (2 * B * T_ * E * 3 * E + 2 * 2 * B * T_ * T_ * E
                 + 2 * B * T_ * E * E + 2 * 2 * B * S * E * E
                 + 2 * 2 * B * T_ * S * E)
    tied = 2 * B * T_ * E * dec.vocab_size if dec.tie_weights else 0
    analytic = count["modules"] + front + dec.nlayers * per_layer + tied
    times = []
    for _ in range(FLOPS_TIMED + 2):
        times.append(cuda_ms(forward, 1, warmup=0))
    ms = statistics.median(times[2:])
    util = P.mfu(est["flops"], ms / 1e3, dev)
    log(f"31(e) flops_estimate of the flagship's eval forward, B={B} x "
        f"{FLOPS_SECONDS} s, {T_} tokens: {est['flops']:.6g} FLOPs ({est['flops'] / B:.4g} a "
        f"clip), bytes_accessed {est['bytes_accessed']:.4g}; analytic "
        f"{analytic:.6g} ({est['flops'] / analytic - 1:+.2e}); median "
        f"{ms:.3f} ms of {FLOPS_TIMED}: {est['flops'] / ms / 1e9:.4g} "
        f"TFLOP/s, mfu {util} against "
        f"{P.device_peak_flops(dev)} bf16 FLOP/s; host rss "
        f"{P.host_rss_gb():.2f} GB on {card}")
    assert abs(est["flops"] / analytic - 1) <= FLOPS_RTOL
    assert util is not None and 0 < util < 1 and P.host_rss_gb() > 0
    return est["flops"], ms


def _dp_config(data, root) -> dict:
    """``configs/synthetic_v2/cnn14rnn_trm.yaml`` on the corpus ``data``:
    DP_SAMPLES train samples an epoch (a fixed number, so the step count
    is), one epoch, no loader workers, no SWA, no device-resident banks
    (which data parallelism turns off)."""
    from audiocaption_tpu_torch.cli import recipes
    cfg = recipes.recipe("synthetic_v2/cnn14rnn_trm.yaml", str(data))
    cfg["experiment_path"] = str(root)
    cfg["trainer"]["epochs"] = 1
    cfg["swa"] = {"use": False}
    cfg["data"]["train"]["dataloader_args"].update(
        num_samples=DP_SAMPLES, num_workers=0)
    cfg["data"]["val"]["dataloader_args"]["num_workers"] = 0
    for split in ("train", "val"):
        cfg["data"][split]["device_resident"] = False
    return cfg


def _largest_diff(a: dict, b: dict):
    """(the largest |a - b| / max(1, max |a|) over the tensors, its name)."""
    import numpy as np
    return max((float(np.abs(a[k] - b[k]).max())
                / max(1.0, float(np.abs(a[k]).max())), k) for k in a)


def dp_worker(rank: int, world: int, port: int, case: str,
              device: str = "cuda") -> None:
    """Phase 31(f)(ii)'s rank: gloo on the card (NCCL refuses two ranks on
    one card), the seeded full-width ``cnn14rnn_trm``, its slice of the
    saved global batch, one ``train_step`` with a ``ParallelContext``;
    rank 0 writes the loss and the raw gradient norm."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from audiocaption_tpu_torch.device import set_parity_precision
    from audiocaption_tpu_torch.parallel import (
        ParallelContext, init_distributed, shard_batch, sync_batch_norm)
    set_parity_precision()
    d = Path(case)
    dev = torch.device(device)
    init_distributed(f"tcp://localhost:{port}", world, rank, dev,
                     backend="gloo")
    model = _dp_model(dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in np.load(d / "batch.npz").items()}
    sync_batch_norm(model)
    out = _dp_step(model, shard_batch(batch, rank, world), ParallelContext())
    if rank == 0:
        (d / "result.json").write_text(json.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _dp_model(dev):
    """The seeded full-width ``cnn14rnn_trm`` (random weights), its
    dropouts off."""
    import torch
    from audiocaption_tpu_torch.models import zoo
    model = zoo.cnn14rnn_trm(vocab_size=DP_VOCAB, rnn_dropout=0.0,
                             decoder_dropout=0.0)
    zoo.random_init(model, torch.Generator().manual_seed(SEED + 31))
    return model.to(dev)


def _dp_step(model, batch, parallel=None) -> dict:
    """One ``train_step`` with scheduled sampling at DP_SS and SpecAugment,
    each from its own seeded generator (the per-row stripes drawn for the
    global batch), the Cnn14's functional dropout the identity -> loss,
    raw gradient norm."""
    import torch
    import torch.nn.functional as F
    from audiocaption_tpu_torch.losses.loss import masked_token_loss
    from audiocaption_tpu_torch.optim.schedules import (
        exponential_decay_with_warmup)
    from audiocaption_tpu_torch.training.trainer import (
        create_train_state, train_step)
    state = create_train_state(
        model, 5e-4, exponential_decay_with_warmup(5e-4, 5e-7, 100, 10))
    dropout = F.dropout
    F.dropout = lambda t, p=0.5, training=True, inplace=False: t
    try:
        m = train_step(state, masked_token_loss("label_smoothing", 0.1),
                       batch, ss_ratio=torch.tensor(DP_SS),
                       generator=torch.Generator().manual_seed(SEED + 33),
                       specaug=True, specaug_generator=torch.Generator(
                           device=batch["wav"].device).manual_seed(SEED + 34),
                       parallel=parallel)
    finally:
        F.dropout = dropout
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def start_parallel(dev) -> dict:
    """Phase 31(f)'s subprocesses, started before the other parts so that
    they run beside them: (i) ``Runner.train`` under ``torchrun
    --standalone --nproc_per_node=1`` (NCCL, a world of one) of
    :func:`_dp_config`; (ii) two ranks of :func:`dp_worker` on the one
    card over gloo (NCCL refuses two ranks on one card), each with half
    of a global batch of DP_B clips.  -> what :func:`finish_parallel`
    reads."""
    import socket
    import subprocess
    import tempfile
    import numpy as np
    import torch
    import yaml
    data, _ = shared_corpus("v2", QM_SIZES)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    gen = torch.Generator().manual_seed(SEED + 32)
    Lc = 9
    batch = {"wav": (torch.randn(DP_B, DP_SECONDS * SR_32K, generator=gen)
                     * 0.1).numpy(),
             "wav_len": np.asarray([DP_SECONDS * SR_32K - 3000 * i
                                    for i in range(DP_B)], np.int64),
             "cap": torch.randint(4, DP_VOCAB, (DP_B, Lc),
                                  generator=gen).numpy(),
             "cap_len": np.asarray([Lc - i % 3 for i in range(DP_B)],
                                   np.int64)}
    batch["cap"][:, 0] = 1
    for i, n in enumerate(batch["cap_len"]):
        batch["cap"][i, n - 1] = 2
    case = root / "dp2"
    case.mkdir()
    np.savez(case / "batch.npz", **batch)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    cfg_path = root / "dp.yaml"
    cfg_path.write_text(yaml.safe_dump(_dp_config(data, root / "tr")))
    procs = {f"rank {r}": subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker", str(r),
         "2", str(port), str(case), dev.type], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)}
    procs["torchrun"] = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "audiocaption_tpu_torch.cli.run",
         "train", str(cfg_path), f"device={dev.type}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT))
    return {"root": root, "data": data, "batch": batch, "case": case,
            "procs": procs, "t0": time.perf_counter()}


def finish_parallel(jobs: dict, dev, card) -> int:
    """Phase 31(f): data parallelism on the card.  (i) ``Runner.train`` of a
    full-width ``cnn14rnn_trm`` (corpus v2's first QM_SIZES[0] train clips,
    DP_SAMPLES samples: a few steps) under ``torchrun`` against the same
    run in this process: the epoch loss within DP_RTOL, and every
    parameter of ``last.pth`` within DP_ATOL * max(1, max |p|), or within
    DP_FLOOR_FACTOR times the gap between two runs in this process
    (cuDNN's backward sums in no fixed order, and Adam's first steps move
    a parameter whose gradient is near zero by the rate whatever its
    size); (ii) the two gloo ranks' step (dropout off): loss within rtol
    1e-5 and raw gradient norm within rtol 1e-4 of the single-process step
    on the global batch (``tests/test_torch_parallel.py``'s bounds).  The
    subprocesses are stopped and the files removed whatever happens.  ->
    the log-mel launches of (i)'s runs in this process."""
    import shutil
    import subprocess
    import numpy as np
    import torch
    from audiocaption_tpu_torch.cli.run import Runner
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    from audiocaption_tpu_torch.training.checkpoint import load_checkpoint
    root, data, procs = jobs["root"], jobs["data"], jobs["procs"]
    try:
        # (i) Runner.train here twice (the second run gives the floor)
        runs, t_here = [], []
        n0 = FL.fused_logmel.launches
        for name in ("here", "again"):
            t0 = time.perf_counter()
            runs.append(Path(Runner().train(_dp_config(data, root / name),
                                            f"device={dev.type}")))
            t_here.append(time.perf_counter() - t0)
        launches = FL.fused_logmel.launches - n0
        outs = {}
        for name, p in procs.items():
            try:
                outs[name] = p.communicate(timeout=DP_TIMEOUT)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                outs[name] = p.communicate()[0]
            assert p.returncode == 0, f"{name} failed:\n{outs[name][-3000:]}"
        t_sub = time.perf_counter() - jobs["t0"]
        here, again = runs
        tr = root / "tr" / here.name
        log_tr = (tr / "train.log").read_text()
        for line in log_tr.splitlines():
            log(f"31(f)(i) under torchrun: {line}")
        engaged = ("data parallel: 1 rank(s), "
                   f"{'nccl' if dev.type == 'cuda' else 'gloo'}") in log_tr
        curve_here = _epoch_curve(here / "train.log", "loss", "val_cider")
        curve_tr = _epoch_curve(tr / "train.log", "loss", "val_cider")
        p_here, p_again, p_tr = (
            load_checkpoint(str(d / "last.pth"))["variables"]
            for d in (here, again, tr))
        worst = _largest_diff(p_here, p_tr)
        floor = _largest_diff(p_here, p_again)
        log(f"31(f)(i) Runner.train of cnn14rnn_trm ({DP_SAMPLES} samples): "
            f"here {t_here[0]:.1f} / {t_here[1]:.1f} s, the subprocesses "
            f"{t_sub:.1f} s from their start (data parallel engaged under "
            f"torchrun: {engaged}); epoch loss {curve_here[0][0]:.6f} / "
            f"{curve_tr[0][0]:.6f}, val CIDEr-D {curve_here[0][1]:.4f} / "
            f"{curve_tr[0][1]:.4f}; parameters' largest |diff| / max(1, max "
            f"|p|) {worst[0]:.3g} at {worst[1]} (two runs here: "
            f"{floor[0]:.3g} at {floor[1]}); log-mel launches here "
            f"{launches} on {card}")
        assert engaged
        assert abs(curve_tr[0][0] / curve_here[0][0] - 1) <= DP_RTOL
        assert worst[0] <= max(DP_ATOL, DP_FLOOR_FACTOR * floor[0])
        assert launches > 0

        # (ii) the two ranks against the single-process step
        got = json.loads((jobs["case"] / "result.json").read_text())
        single = _dp_step(_dp_model(dev), {
            k: torch.from_numpy(v).to(dev) for k, v in jobs["batch"].items()})
        log(f"31(f)(ii) two ranks on one card (gloo, CUDA tensors), "
            f"global batch {DP_B} x {DP_SECONDS} s, scheduled sampling "
            f"{DP_SS} and SpecAugment: loss {got['loss']:.7f} "
            f"/ single {single['loss']:.7f}, raw grad norm "
            f"{got['grad_norm']:.7f} / {single['grad_norm']:.7f} on {card}")
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], single["grad_norm"],
                                   rtol=1e-4)
        return launches
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


def prepare_path(card):
    """Phase 31(g): ``prepare_dataset clotho --no_pack`` (its command line,
    in a subprocess) from a Clotho-style csv of corpus v2's val split (file
    names of its wav files, the five captions), then ``build_vocab``:
    ``text.json`` and ``vocab.pkl`` equal to those ``prepare_clotho`` and
    ``build_vocab`` write in this process; the audio ids the md5 of the
    file names, the captions the corpus's."""
    import csv
    import hashlib
    import shutil
    import subprocess
    import tempfile
    from audiocaption_tpu_torch.cli.prepare_dataset import prepare_clotho
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    data, _ = shared_corpus("v2", SYN_V2_SIZES)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_prep_"))
    try:
        audios = json.loads((data / "val_text.json").read_text())["audios"]
        files = dict(r.split("\t") for r in (data / "val_wav.csv")
                     .read_text().splitlines()[1:])
        with open(root / "captions.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["file_name"] + [f"caption_{i}" for i in range(1, 6)])
            for a in audios:
                caps = [c["caption"] for c in a["captions"][:5]]
                w.writerow([Path(files[a["audio_id"]]).name] + caps
                           + [""] * (5 - len(caps)))
        audio_dir = str(Path(files[audios[0]["audio_id"]]).parent)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "audiocaption_tpu_torch.cli."
             "prepare_dataset", "clotho", "--audio_dir", audio_dir,
             "--caption_csv", str(root / "captions.csv"), "--output_dir",
             str(root / "cli"), "--no_pack"], capture_output=True, text=True,
            timeout=300, cwd=str(ROOT))
        t_cli = time.perf_counter() - t0
        assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
        prepare_clotho(audio_dir, str(root / "captions.csv"),
                       str(root / "here"), pack=False)
        same = all((root / "cli" / n).read_bytes()
                   == (root / "here" / n).read_bytes()
                   for n in ("text.json", "vocab.pkl"))
        text = json.loads((root / "cli" / "text.json").read_text())["audios"]
        ids = all(t["audio_id"] == hashlib.md5(Path(
            files[a["audio_id"]]).name.encode()).hexdigest()
            and [c["caption"] for c in t["captions"]]
            == [c["caption"] for c in a["captions"][:5]]
            for t, a in zip(text, audios))
        tok = DictTokenizer(str(root / "cli" / "vocab.pkl"))
        log(f"31(g) prepare_dataset clotho --no_pack: {len(text)} clips, "
            f"vocabulary {len(tok)}, in {t_cli:.1f} s; text.json and "
            f"vocab.pkl equal to this process's: {same}; ids and captions "
            f"the corpus's: {ids} on {card}")
        assert same and ids and len(text) == len(audios) and tok.loaded
    finally:
        shutil.rmtree(root, ignore_errors=True)


def port_tools_path(api, dev, card):
    """Phase 31: (f)'s subprocesses start first and run beside (a)-(d) and
    (g) (``start_parallel``); (f) is read after them, and (e), which
    times the card, runs last, alone.  -> the log-mel launches of the
    phase and its parts' seconds."""
    launches, times = 0, {}
    t0 = time.perf_counter()
    jobs = start_parallel(dev)
    try:
        times["f start"] = time.perf_counter() - t0
        for key, fn in (("a", lambda: queue_m_logmel(dev, card)["launches"]),
                        ("b", lambda: logmel_compute_dtype(dev, card)[
                            "launches"]),
                        ("c", lambda: word2vec_path(dev, card) and 0),
                        ("d", lambda: demo_path(dev, card)),
                        ("g", lambda: prepare_path(card) or 0)):
            t0 = time.perf_counter()
            launches += fn()
            times[key] = time.perf_counter() - t0
    except BaseException:
        import shutil
        for p in jobs["procs"].values():
            p.kill()
            p.wait()
        shutil.rmtree(jobs["root"], ignore_errors=True)
        raise
    t0 = time.perf_counter()
    launches += finish_parallel(jobs, dev, card)
    times["f"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flops_path(api, dev, card)
    times["e"] = time.perf_counter() - t0
    return launches, times


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "audiocaption_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (the "
              "audiocaption_tpu_torch package is not beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from audiocaption_tpu_torch import cuda_build, native
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.device import set_parity_precision
    from audiocaption_tpu_torch.hf_api import (
        Effb2TrmCaptioningModel, Effb2TrmConfig, pad_bucket)
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.serving import MicroBatchServer, wire_decoder

    t_start = time.perf_counter()
    # phases 24-30's corpora, generated beside phases 1-23
    start_corpora()
    dev = torch.device("cuda")
    set_parity_precision()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_count {torch.cuda.device_count()}")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    # registers, shared memory and spills (-Xptxas -v) of every kernel
    cuda_build.build_all(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(cuda_build.KERNELS)}")
    # the native CIDEr-D scorer of the val score and the SCST rewards
    t0 = time.perf_counter()
    lib = native.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s for {lib._name}")

    # -- 3. kernels vs plain versions --------------------------------------
    packed, memkv, valid = jittered_decoder_inputs(dev)
    g_kernel = FG.fused_greedy_decode(packed, memkv, valid, L)
    g_plain = FG.fused_greedy_plain(packed, memkv, valid, L)
    torch.cuda.synchronize()
    g_mis = int((g_kernel != g_plain).sum())
    greedy_err = float((g_kernel - g_plain).abs().max())
    log(f"kernel vs plain, B={B_KERNEL} S={S_KERNEL} L={L} V={V}: greedy "
        f"{g_mis}/{g_kernel.numel()} tokens differ (plan "
        f"{FG.fused_greedy_decode.last_plan})")
    assert g_mis <= MISMATCH_LIMIT * g_kernel.numel(), "greedy kernel disagrees"
    assert len(torch.unique(g_plain)) > 10, "degenerate greedy trajectories"
    beams = {}
    for K in BEAMS:
        b_seq, b_score = FB.fused_beam_decode(packed, memkv, valid, L, K)
        plan = FB.fused_beam_decode.last_plan
        steps = torch.zeros(B_KERNEL, dtype=torch.long, device=dev)
        p_seq, p_score = FB.fused_beam_plain(packed, memkv, valid, L, K,
                                             steps=steps)
        torch.cuda.synchronize()
        b_mis = int((b_seq != p_seq).sum())
        same = (b_seq == p_seq).all(-1)
        err = float((b_score[same] - p_score[same]).abs().max()) \
            if bool(same.any()) else float("inf")
        beams[K] = dict(seq=b_seq, score=b_score, steps=steps, err=err)
        log(f"kernel vs plain, beam {K}: {b_mis}/{b_seq.numel()} tokens "
            f"differ, max |score diff| on matching sequences {err:.3g} "
            f"(plan {plan})")
        assert b_mis <= MISMATCH_LIMIT * b_seq.numel(), \
            f"beam-{K} kernel disagrees"
        if K == 3:
            assert err <= SCORE_ATOL, f"beam-{K} kernel scores disagree"
        else:
            assert float64_floor_check(packed, memkv, valid, K, b_seq, b_score,
                                       p_seq, p_score), \
                f"beam-{K} kernel scores disagree"
    score_err = max(b["err"] for b in beams.values())

    # -- 4. serving path end to end --------------------------------------
    api = Effb2TrmCaptioningModel(Effb2TrmConfig(vocab_size=V), seed=SEED,
                                  device="cuda")
    jitter_model(api, torch.Generator().manual_seed(SEED + 1))
    rng = np.random.RandomState(SEED)
    audio = (rng.randn(8, 10 * SR) * 0.1).astype(np.float32)
    lens = np.asarray([10 * SR, 9 * SR, 7 * SR + 123, 5 * SR, 3 * SR + 7,
                       2 * SR, 16000, 4000])
    FG.reset_launches(FG.fused_greedy_decode)
    FG.reset_launches(FB.fused_beam_decode)
    e2e = {}
    for method in ("greedy", "beam"):
        ids = api(audio, lens, sample_method=method, beam_size=3,
                  max_length=L)
        assert ids.shape == (8, L) and ((ids >= 0) & (ids < V)).all()
        wav = torch.from_numpy(pad_bucket(audio, SR)).to(dev)
        ref = generate(api.model, wav, torch.from_numpy(lens).to(dev),
                       sample_method=method, beam_size=3,
                       max_length=L)["seq"].cpu().numpy()
        mis = int((ids != ref).sum())
        e2e[method] = mis
        log(f"end to end {method}: kernel path vs torch engine on the card: "
            f"{mis}/{ids.size} tokens differ; first caption {ids[0][:8]}")
        assert mis <= MISMATCH_LIMIT * ids.size, f"{method} path disagrees"
    ids = api(audio, lens, sample_method="beam", beam_size=5, max_length=L)
    ref = generate(api.model, wav, torch.from_numpy(lens).to(dev),
                   sample_method="beam", beam_size=5,
                   max_length=L)["seq"].cpu().numpy()
    mis = int((ids != ref).sum())
    log(f"end to end beam 5: kernel path vs torch engine on the card: "
        f"{mis}/{ids.size} tokens differ; first caption {ids[0][:8]}")
    assert ids.shape == (8, L) and mis <= MISMATCH_LIMIT * ids.size, \
        "beam-5 path disagrees"

    # -- 5. micro-batching server ----------------------------------------
    clips = [(rng.randn(n) * 0.1).astype(np.float32)
             for n in rng.randint(SR, 10 * SR + 1, 16)]
    serve_fn = wire_decoder(functools.partial(
        api.decode, sample_method="beam", beam_size=3, max_length=L),
        "f32", device="cuda")
    with MicroBatchServer(serve_fn, max_batch=16, max_wait_ms=5000.0,
                          max_samples=10 * SR) as srv:
        futs = [srv.submit(c) for c in clips]
        served = np.stack([f.result(timeout=300) for f in futs])
        n_batches = srv.dispatched_batches
    batch = np.zeros((16, 10 * SR), np.float32)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    direct = serve_fn(batch, np.asarray([len(c) for c in clips],
                                        np.int32)).cpu().numpy()
    log(f"serving: 16 clips in {n_batches} dispatch(es); "
        f"{int((served != direct).sum())} tokens differ from direct decode")
    assert n_batches == 1 and np.array_equal(served, direct)
    launches = {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_beam": FB.fused_beam_decode.launches}
    log(f"serving-path launches: {launches}")
    assert all(n > 0 for n in launches.values()), "a kernel was not launched"

    # -- 6. times ------------------------------------------------------------
    kernels = decode_times(packed, memkv, valid, g_kernel, beams, launches,
                           greedy_err, score_err, card)

    wav64 = torch.from_numpy((rng.randn(64, 10 * SR) * 0.1).astype(
        np.float32)).to(dev)
    len64 = torch.full((64,), 10 * SR, dtype=torch.long, device=dev)
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: api.model.encode(wav64, len64), 5)
    log(f"encode (log-mel + EffB2, float32): {enc_ms:.2f} ms per batch of "
        f"64 x 10 s on {card}")
    for method in ("greedy", "beam"):
        fn = functools.partial(api.decode, wav64, len64, sample_method=method,
                               beam_size=3, max_length=L)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        log(f"end to end {method}: {64 / dt:.1f} clips/s ({dt * 1e3:.2f} "
            f"ms per batch of 64 x 10 s) on {card}")
        one = cuda_ms(functools.partial(api.decode, wav64[:1], len64[:1],
                                        sample_method=method, beam_size=3,
                                        max_length=L), 5)
        log(f"end to end {method}, one 10 s clip: {one:.2f} ms on {card}")

    # -- 7. log-mel kernel vs its plain version ---------------------------
    logmel_errs = logmel_check(dev, card)

    # -- 8. temporal path end to end ---------------------------------------
    temporal_api, t_launches = temporal_path(dev, card, rng)

    # -- 9. times on the temporal path -------------------------------------
    timing = temporal_times(temporal_api, dev, card)
    kernels.append({
        "name": "fused_logmel", "route": "cuda",
        "source": "audiocaption_tpu_torch/csrc/fused_logmel.cu",
        "replaces": "audiocaption_tpu/ops/pallas_logmel.py:44",
        "launches": t_launches["fused_logmel"],
        "max_abs_err": logmel_errs["CNN14_MEL_32K"], **timing})

    # -- 10. the folded EffB2 encoders through the MBConv kernel -----------
    m_launches, m_err, m_inputs, lms64, feat64 = folded_path(
        api, wav64, len64, audio, lens, dev, card)

    # -- 11. MBConv times --------------------------------------------------
    m_timing = mbconv_times(api, m_inputs, lms64, feat64, card)
    kernels.append({
        "name": "fused_mbconv", "route": "cuda",
        "source": "audiocaption_tpu_torch/csrc/fused_mbconv.cu",
        "replaces": "audiocaption_tpu/ops/pallas_mbconv.py:102",
        "launches": m_launches, "max_abs_err": m_err, **m_timing})

    # -- 12. the decode kernels' bf16 modes vs their plain versions -------
    checks = bf16_kernels(packed, memkv, valid, card)

    # -- 13. the bf16 EffB2 serving path end to end ------------------------
    api16, b_launches = bf16_effb2_path(api, audio, lens, dev, card, rng)

    # -- 14. the bf16 temporal path end to end -----------------------------
    t_api16, _ = bf16_temporal_path(temporal_api, dev, card, rng)

    # -- 15. bf16 times ----------------------------------------------------
    kernels += bf16_times(packed, memkv, valid, checks, kernels, api16, api,
                          t_api16, temporal_api, wav64, len64, b_launches,
                          card)

    # -- 16. train the flagship at full width ------------------------------
    t0 = time.perf_counter()
    trained = train_path(dev, card)
    for k in kernels:
        if k["name"] == "fused_greedy":
            k["train_launches"] = trained["val_launches"]

    t1 = time.perf_counter()
    # -- 17. train step times ----------------------------------------------
    train_times(trained, dev, card)
    log(f"phase 16: {t1 - t0:.1f} s, phase 17: {time.perf_counter() - t1:.1f} "
        f"s")

    # -- 18. SCST of cnn14rnn_trm at full width ---------------------------
    t0 = time.perf_counter()
    scst = scst_path(api, audio, lens, dev, card)
    for k in kernels:
        if k["name"] in scst["launches"]:
            k["scst_launches"] = scst["launches"][k["name"]]
    t1 = time.perf_counter()
    # -- 19. SCST step times -----------------------------------------------
    scst_t = scst_times(scst, api, wav64, len64, card)
    for k in kernels:
        if k["name"] == "fused_greedy":
            k["scst_ms"] = scst_t["greedy_ms"]
            k["scst_bound_ms"] = scst_t["greedy_bound_ms"]
    log(f"phase 18: {t1 - t0:.1f} s, phase 19: {time.perf_counter() - t1:.1f} "
        f"s")

    # -- 20. knowledge distillation of the Cdur5 student ---------------------
    t0 = time.perf_counter()
    kd = kd_path(dev, card)
    for k in kernels:
        if k["name"] in kd["launches"]:
            k["kd_launches"] = kd["launches"][k["name"]]
    t1 = time.perf_counter()
    # -- 21. KD step times ---------------------------------------------------
    kernels.append(kd_times(kd, card)["entry"])
    log(f"phase 20: {t1 - t0:.1f} s, phase 21: {time.perf_counter() - t1:.1f} "
        f"s")

    # -- 22. the evaluation path at full width --------------------------------
    t0 = time.perf_counter()
    ev = eval_path(dev, card)
    for k in kernels:
        if k["name"] in ev["launches"]:
            k["eval_launches"] = ev["launches"][k["name"]]
    t1 = time.perf_counter()
    # -- 23. evaluation times ------------------------------------------------
    kernels += eval_times(ev, dev, card)["entries"]
    log(f"phase 22: {t1 - t0:.1f} s, phase 23: {time.perf_counter() - t1:.1f} "
        f"s")

    # -- 24. the flagship trained on a reduced synthetic corpus v2 ---------
    t0 = time.perf_counter()
    syn = synthetic_flagship_path(dev, card)
    for k in kernels:
        if k["name"] in ("fused_greedy", "fused_beam"):
            k["synthetic_launches"] = syn["launches"][k["name"]]
    t1 = time.perf_counter()
    # -- 25. the SED net and the temporal captioner on a temporal corpus ----
    syn_t = synthetic_temporal_path(dev, card)
    for k in kernels:
        if k["name"] == "fused_logmel":
            k["synthetic_launches"] = syn_t["launches"]["fused_logmel"]
    log(f"phase 24: {t1 - t0:.1f} s, phase 25: {time.perf_counter() - t1:.1f} "
        f"s")

    # -- 26. augmented training of cnn14rnn_trm ------------------------------
    t0 = time.perf_counter()
    syn_a = synthetic_aug_path(dev, card)
    for k in kernels:
        if k["name"] in syn_a["launches"]:
            k["aug_launches"] = syn_a["launches"][k["name"]]
    log(f"phase 26: {time.perf_counter() - t0:.1f} s")

    # -- 27. the rest of the 32 kHz captioner family -----------------------
    t0 = time.perf_counter()
    fam = family_path(dev, card)
    for k in kernels:
        if k["name"] in fam["launches"]:
            k["family_launches"] = fam["launches"][k["name"]]
    kernels += fam["entries"]
    log(f"phase 27: {time.perf_counter() - t0:.1f} s")

    # -- 28. the MBConv kernel's bf16 work dtype; the feature-input path ---
    t0 = time.perf_counter()
    kernels.append(bf16_walk(api, api16, lms64, feat64, audio, lens, dev,
                             card))
    t1 = time.perf_counter()
    feat = feature_path(dev, card)
    for k in kernels:
        if k["name"] in feat["launches"]:
            k["feature_launches"] = feat["launches"][k["name"]]
    log(f"phase 28: {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f} s)")

    # -- 29. the item-8 encoders and PANNs classifiers ---------------------
    t0 = time.perf_counter()
    enc8 = item8_encoders(dev, card)
    t1 = time.perf_counter()
    item8 = item8_path(dev, card)
    for k in kernels:
        if k["name"] in item8["launches"]:
            k["item8_launches"] = item8["launches"][k["name"]]
        if k["name"] == "fused_logmel":
            k["item8_launches"] += enc8["logmel_launches"]
    kernels += item8["entries"]
    log(f"phase 29: {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f} s)")

    # -- 30. item 8b: keyword and event decoders, the style captioner -----
    t0 = time.perf_counter()
    kw = keyword_path(dev, card)
    for k in kernels:
        if k["name"] == "fused_logmel":
            k["keyword_launches"] = kw["launches"]["fused_logmel"]
    log(f"phase 30: {time.perf_counter() - t0:.1f} s")

    # -- 31. Queue 3 M's batches; host tools, word2vec, the demo, profiling,
    # the DFT input type, data parallelism, dataset preparation ----------
    t0 = time.perf_counter()
    n31, t31 = port_tools_path(api, dev, card)
    for k in kernels:
        if k["name"] == "fused_logmel":
            k["phase31_launches"] = n31
    log(f"phase 31: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'({p}) {t:.1f} s' for p, t in t31.items())})")

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(*map(int, sys.argv[2:5]), *sys.argv[5:7])
        sys.exit(0)
    sys.exit(main())
