#!/usr/bin/env python3
"""Drive the PyTorch port (empirical_mvm_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-build OTHER/empirical_mvm_torch/csrc

The second form only compares kernels between this checkout's sources and
another's (for example the parent commit, unpacked with ``git archive``),
on one card, times in turns (``compare_builds``): the forwards whose bf16
runs a tensor-core body (rows 3, 7, 9, 10 and 12 on
csrc/attention_fwd_mma.cuh, row 5 on row 11's forward), fp32 bit for bit
and each build's bf16 held to the bf16 limits; the backwards whose bf16
runs a tensor-core body (rows 4, 8, 9 and 10 on csrc/attention_bwd_mma.cuh,
row 6 on row 11's body) and row 11 (the tiled self-attention) at the
multiple-choice shape, fp32 and bf16 bit for bit; the LayerNorm forward
and backward (rows 1 and 2) at every site of the paths, each build held to
the LayerNorm limits, new / base per site; and the pixel, violet,
2d_feature and swin2d train steps and the multiple-choice step at full
width, each build's steps timed in turns, with each step's kernel time
under torch.profiler, so that a change of kernel time shows in step time
on one card.

Phases, each of which records its failures; the script exits non-zero,
before the final line, if any phase failed:

1. Device: a CUDA card must be present; prints its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
2. Build: compiles csrc/*.cu with nvcc for sm_90a into build/ and prints the
   build time and ptxas' register and shared-memory report.
3. Kernels against plain versions, at every shape the main paths give them:
   fp32 with TF32 off (limits ``FP32_*`` below), and bf16 against the plain
   version on the same bf16 inputs, run in fp32 and run in bf16 (limits
   ``BF16_*``). The backward kernels (LayerNorm, direct window attention,
   lane self-attention, lane window attention) and the lane forward with
   dropout (same Philox seed as its plain version, compared element by
   element) are checked the same way. Each kernel, its plain version and one PyTorch library call
   computing the same function (SDPA with bias + mask as ``attn_mask``, and
   ``dropout_p`` for the dropout rows, its backward through autograd;
   ``F.layer_norm`` and its backward) are timed with CUDA events in the
   main path's dtype. The LayerNorm records also name the body each dtype
   ran (``vectorized`` at the paths' widths, ``scalar`` elsewhere), hold
   the bf16 limits at rows of mean 50 and std 1 (``LARGE_MEAN``), give the
   device time of one kernel call and one ``F.layer_norm`` call under the
   profiler (``device_ms``, ``library_device_ms``), and the backward's
   dgamma and dbeta must be bit-identical over two runs; three copies of
   layer_norm.cu with planted faults (``PLANTED_LN``: a one-pass variance,
   the m2 term dropped from dx, a partial left out of dgamma and dbeta)
   must each fail the LayerNorm limits at the train fusion site. The forward kernels are checked and timed at the
   eval's shapes and at the train step's; ``lane_window_attention`` and the
   LayerNorm at the frozen 2D teacher's shapes of the 2d_feature step, and
   ``lane_window_attention_bwd`` at the trained 2D swin's shapes of the
   swin2d step (the same seven (window, head) shapes);
   ``packed_window_attention`` and its backward at the C = 96 Video Swin's
   stages 0 and 1 of the violet step (N = 196), unshifted and shifted, and
   at stages 0 and 1 of the 2D Swin-tiny (C = 96, 192, N = 49: the
   swin2d-tiny step of phase 45), and the lane window kernels forward and
   backward at its stages 2 and 3 (C = 384, 768);
   ``fused_window_attention`` (q, k, v as three arrays, the same kernel)
   and its backward at the violet stage-0 shifted shape; the direct kernels
   forward and backward at the violet step's stages 2 and 3 (C = 384, 768);
   ``packed_self_attention`` (the tiled self-attention) forward at p = 0 and
   p = 0.1 and its backward at the multiple-choice fusion shape, with the
   dropout keep fraction, at DPT-Large's 384^2 shape (fp32 and bf16) and at
   N = 129, ``fused_self_attention`` (the same kernel on q, k, v apart),
   and two copies of csrc/ with planted faults of the tensor-core bodies
   (``PLANTED_TILED``: two of row 11's, the forward one also held at row
   5, one of the window backward's, one of row 6's, one of the window
   forward's held at rows 3, 7, 9 and 12), each of which must fail the bf16
   limits. The records of rows 3-12 name the body each dtype ran
   (``tensor_core`` for bf16 at the paths' head widths, ``cuda_core`` for
   fp32); the window forwards' bf16 (rows 3, 7, 9, 10, 12) is held to the
   ``window_fwd_tc`` limits, row 5's to row 11's ``sa``, the window
   backwards' to ``window_bwd_tc``. The LayerNorm at
   the 3D teacher's final norm and at the CLIP and DPT teachers' sites (the
   DPT's 15,760 x 1024 in bf16 and fp32), ``lane_self_attention`` at the
   CLIP teacher's shape (80 frames of 50 tokens, p = 0) and the DPT's (80
   frames of 197 tokens, 16 heads of 64, p = 0); ``lane_attention`` (row 12, the
   lanebench tool's kernel) at the tool's three stage shapes with its zero
   mask and a seeded shift-like mask, each beside row 7's time on the same
   inputs; and, marked ``off_path``, what the C % 128 rule costs at the
   violet stages 0-1: rows 12 and 7 on the partitioned windows against
   ``_to_packed`` + row 9 + ``_from_packed``; and the downstream heads'
   shapes (phases 26-31): row 5 with dropout and row 6 at the retrieval
   fusion (64 rows of 275, ``FINETUNE_LANE``), row 11 at the generative
   multiple choice's 8 rows of 350 (forward at p = 0 and 0.1, backward),
   the direct kernels forward and backward at the open-ended QA's 10 clips
   of 5 frames, and the LayerNorm forward and backward at every fine-tune
   site (``FINETUNE_LN``: the fusion, EncVideo, the MLM head, the fp32 text
   embeddings); and the captioning and smtm shapes (phases 32-35): the
   direct forward at the caption step's and the decoders' 8 clips of 5
   frames, the LayerNorm at every captioning site (``CAPTION_LN`` and
   ``SMTM_LN`` forward and backward, ``DECODE_LN`` forward), rows 5
   and 6 under the seq2seq joint mask that the port's ``joint_attn_bias``
   builds, (B, L, L) with rows that differ (``SEQ2SEQ_LANE``: row 5 with
   dropout and row 6 at the caption step's 8 rows of 275 and the smtm
   fusion's 20 rows of 232, row 5 at p = 0 at the greedy and beam decoders'
   8 and 32 rows of 270; the pretrain fusion's 80 rows under the same mask,
   ``off_path``), the caption shape also under a padding mask (``off_path``)
   for the per-row mask's cost, and a copy of the lane self-attention's
   sources with a planted fault (``PLANTED_ROW_STRIDE``: both C entries
   pass a query-row stride of 0), whose rows 5 and 6 must fail the fp32 and
   the bf16 limits under the seq2seq mask; and the loader-fed steps' own
   shapes (phases 37-38): the direct forward and backward at the cc3m
   batch's 20 clips of T = 1 (window (1, 7, 7), N = 49), row 5 with
   dropout and row 6 at its fusion's 80 rows of 82 and at the QA-OE mlm
   rows' 10 of 280 (``LOADER_LANE``), row 11 at the generative MC's 8 rows
   of 353, and the LayerNorm forward and backward at each of their sites
   (``LOADER_LN``); and the MERLOT encoder's trained ViT (phase 47): rows 5
   and 6 at its 80 frames of 50 tokens (12 heads of 64, p = 0, the zero
   mask) and the LayerNorm forward and backward at its sites
   (``MERLOT_LN``); and the shapes and masks of phases 49-50: row 5 with
   dropout and row 6 at the text stack's 20 captions of 32 tokens
   (``TEXT_STACK_LANE``), the LayerNorm forward and backward at its 640
   rows (``TEXT_STACK_LN``), rows 5 and 6 under the SwinBERT masks, a hole
   at each frame's first video key (``SWINBERT_LANE``: the caption step's 8
   rows of 275 under the seq2seq mask and, ``off_path``, the full one, the
   greedy decoder's 8 rows of 270), and a copy of the lane self-attention's
   sources whose tensor-core body reads each row's mask as suffix padding
   (``PLANTED_SUFFIX_MASK``), whose rows 5 and 6 must pass the bf16 limits
   under a padding and the seq2seq mask and fail them under both SwinBERT
   masks. Prints one ``kernel_shapes``
   line with the per-shape numbers and, at the end, one ``kernels`` JSON
   line.
4. The retrieval eval at full width: VioletRetrieval at
   configs/msrvtt-retrieval.json (Swin-base, 5 frames of 224^2, 25 text
   tokens, 12-layer BERT-base fusion), seeded random weights, bf16, runs
   retrieval_two_stage_eval on 16 captions x 16 videos of 2 clips (seeded
   uint8 clips). Launch counts are zeroed just before the first timed eval
   and read just after it; every eval kernel must have launched. The stage
   throughputs are the median and range over ``EVAL_REPEATS`` evals after
   one warm-up eval.
5. Whole retrieval model: encode + score_pairs on 2 videos x 1 clip, 4
   pairs, on the card in fp32 (kernels) against the CPU in fp32 (plain
   versions), atol and rtol 1e-3; the bf16 run's difference is printed.
6. The pretrain train step at full width: VioletPretrain at
   configs/pretrain.json (Video-Swin-base student, 4 frames of 224^2, 32
   text tokens, 12-layer BERT-base fusion, MTM + VTM + MVM-pixel, bm/rm
   masking, 4-group AdamW), ``size_batch`` = 20 seeded uint8 clips and
   padded captions, seeded random weights, bf16 compute. One warm-up step,
   then ``TRAIN_STEPS`` timed steps (host clock ending in a synchronise):
   clips/s median and range, peak device memory, every loss of every step.
   Launch counts are zeroed just before the first timed step and read just
   after it: every kernel of the step, backward kernels included, must
   have launched as often as its sites in the model. Every loss must be
   finite and every parameter that gets a gradient must have changed (the
   VTM score head's output bias may instead have an all-zero gradient).
7. Whole train step: one step of a depth-cut copy (swin depths (2,2,2,2),
   2 fusion layers, full widths) on the card in fp32 against the same step
   on the CPU in fp32 (plain versions), with the same injected masks and
   negatives and every dropout and drop-path rate at 0, the CPU's L1 losses
   taking the card's sign where an error lies within roundoff of 0
   (``L1_FLIP_SHARE``); losses and every parameter's gradient held to
   ``WHOLE_STEP_TOL``, the differences printed.
8. The pretrain train step for the 2d_feature MVM target, as phase 6 with
   ``train.mvm_target`` replaced by ("2d_feature",) (as bench.py builds
   it): the frozen 2D Swin-base teacher runs forward on the unmasked clip
   (the ``lane_window_attention`` kernel, bf16 on the tensor-core window
   body, in its 24 blocks, kernel
   LayerNorms at its 52 sites), and 4-group AdamW leaves it out. Launches of
   one step held to ``TRAIN_2D_LAUNCHES``; the teacher gets no gradient and
   stays bit-unchanged; every other parameter with a gradient changes.
9. Whole 2d_feature train step: phase 7 for the run of phase 8 (the
   student cut, the teacher at full depth).
10. The pretrain train step on the trained 2D Swin-base backbone, as phase 6
   with ``model.vis_backbone`` = "swin2d" and ``model.temporal_fusion`` =
   "concat" replaced in code (pixel MVM): the per-frame 2D swin runs the
   lane window kernel forward and backward in its 24 blocks, then
   ``swin2bert`` and the ``EncImgSwin`` embeddings. Launches of one step
   held to ``TRAIN_SWIN2D_LAUNCHES``.
11. Whole swin2d train step: phase 7 for the run of phase 10 (swin depths
   (2, 2, 2, 2) at the 2D geometry).
12. The pretrain train step on the C = 96 Video Swin, as phase 6 with
   ``model.vis_backbone_size`` = "violet" replaced in code (the reference's
   ``swin_violet.py``: embed 96, depths 2/2/18/2, heads 3/6/12/24): its
   stage-0 and stage-1 blocks (C = 96, 192) run the packed window kernel
   forward and backward, stages 2 and 3 the direct kernels. Launches of one
   step held to ``TRAIN_VIOLET_LAUNCHES``.
13. Whole violet train step: phase 7 for the run of phase 12 (swin depths
   (2, 2, 2, 2) at the violet widths).
14. The multiple-choice QA fine-tune step at full width: VioletQAMC at
   configs/msrvtt-mc.json (Swin-base on 5 frames of 224^2, 8 questions of 5
   options of 100 text tokens, so the 12-layer BERT-base fusion runs 40 rows
   of 350 tokens on the tiled self-attention), seeded random weights, bf16,
   the ``ce`` step of ``make_supervised_train_step`` with the package's
   ``build_optimizer`` (``finetune_phase``). One warm-up step, then
   ``TRAIN_STEPS`` timed steps: questions/s (batch / step seconds) median
   and range, peak device memory, every loss finite, one step's kernel time
   under the profiler; the launches of the first timed step held to
   ``TRAIN_QAMC_LAUNCHES`` (12 + 12 tiled launches, no lane
   self-attention); every parameter with a gradient changed (the score
   head's output bias may instead have an all-zero gradient).
15. Whole multiple-choice step (``finetune_whole_step_phase``): a depth-cut
   copy (swin depths (2, 2, 2, 2), 2 fusion layers, batch 2, every rate 0)
   at full widths and L = 350, card fp32 against CPU fp32, as phase 7; the
   score head's output bias, whose gradient is zero in exact arithmetic, is
   held to ``ZERO_GRAD_ATOL`` on each side.
16. The multiple-choice eval (``finetune_eval_phase``): ``make_eval_step``
   on the trained model of phase 14 over ``QAMC_EVAL_BATCHES`` seeded
   batches, ``qamc_accuracy``; each batch launches the step's forwards.
17. The lanebench tool, ``empirical_mvm_torch.tools.lanebench.main(
   ["--stage", "-1", "--grad"])`` in this process: its lines; each path's
   error against the tool's fp32 oracle within phase 3's bf16 limit against
   plain fp32 (``BF16_VS_FP32["attention"]``, which the ``window_fwd_tc``
   kind of the tool's bodies shares); ``lane_attention`` launched (its counts are the kernels line's
   ``launches_lanebench``).
18-20. The pretrain train step at full width for the 3d_feature (the
   frozen Video Swin-base teacher: the direct kernel in its 24 blocks, the
   kernel LayerNorm at its 53 sites), 2d_clip (the frozen CLIP ViT-B/32 on
   each frame: lane_self_attention in its 12 layers, 25 LayerNorm sites)
   and hog targets, each as phase 6 with ``train.mvm_target`` replaced;
   launches held to ``TRAIN_3D_LAUNCHES``, ``TRAIN_CLIP_LAUNCHES`` and
   ``TRAIN_HOG_LAUNCHES``; the teachers get no gradient and stay
   bit-unchanged; the device time of one no-grad call of each teacher and
   of ``hog_image`` printed.
21. Whole train step for ("hog", "3d_feature", "2d_clip"): phase 7 for that
   run (the student cut, both teachers at full depth), both sides fed one
   hog target computed on the CPU; ``hog_image`` itself held card against
   CPU apart (``HOG_FLIP_SHARE``, ``HOG_CELL_SCALE``).
22-24. The pretrain train step at full width for the depth target (the
   frozen DPT-Large on each frame: lane_self_attention in its 24 blocks,
   the kernel LayerNorm at their 48 sites), vq on the fly (the frozen dVAE,
   n_hid 256 and 8192 tokens, on each frame), pre-extracted vq (seeded
   tokens in the batch) and optical_flow (the frozen RAFT-large, 12
   updates, on each pair of adjacent frames), each as phase 6; launches
   held to ``TRAIN_DEPTH_LAUNCHES`` (the pixel step's, 48 LayerNorm and 24
   lane self-attention launches more), ``TRAIN_VQ_LAUNCHES`` and
   ``TRAIN_FLOW_LAUNCHES`` (the pixel step's); the teachers get no
   gradient and stay bit-unchanged; each step's kernel time under the
   profiler, the device time of one no-grad teacher call, and for the flow
   step the share of frame pairs the 50-pixel filter keeps, printed.
25. Whole train step for ("depth", "optical_flow", "vq" on the fly): phase 7
   for that run with 2 clips, the DPT cut to ``DPT_CUT`` (4 blocks, each
   captured) so that the CPU side stays short, RAFT and the dVAE at full
   size; the DPT's depth and RAFT's flow held card against CPU apart
   (``TEACHER_FP32_SCALE``), so that the teachers are held even where the
   loss reads them weakly, and the dVAE's tokens (``VQ_FLIP_SHARE``); both
   steps fed the CPU's tokens.
26. The retrieval fine-tune step at full width: VioletRetrieval at
   configs/msrvtt-retrieval.json (8 clips of 5 frames of 224^2 and 8
   captions of 25 tokens; all 64 pairs fused, 64 rows of 275 tokens on
   row 5 with dropout and row 6), the ``nce`` step at the run's ``temp``,
   as phase 14 (clips/s; launches held to ``TRAIN_RET_LAUNCHES``; the score
   head's output bias may end with an all-zero gradient); then
   ``in_batch_retrieval_accuracy`` of the eval forward's (8, 8) scores.
27. Whole nce step: phase 15 for the retrieval model (4 fusion rows of
   275), the score head's output bias held to ``NCE_ZERO_GRAD_ATOL``.
28. Open-ended QA at full width (configs/msrvtt-qa.json, 10 questions of
   25 tokens, 10 fusion rows of 275 on row 5): VioletQAOE (the 1500-way
   answer head) on ``ce`` and VioletQAOEMLMHead on ``mlm``, each as phase
   14 (``TRAIN_QAOE_LAUNCHES``, ``TRAIN_QAOE_MLM_LAUNCHES``: the MLM head's
   LayerNorm more), and each eval: the answer head's accuracy
   (``masked_accuracy`` of the argmax), ``qaoe_mlm_topk`` at k = 1 and 5.
29. Whole mlm steps of VioletQAOEMLMHead: with its task token
   (``emb_task``, L = 276), then with a prompt of ``PROMPT_LEN`` tokens (L =
   286; both still row 5), as phase 15.
30. Multiple choice at full width (configs/tgif-action.json, on the tiled
   self-attention as phase 14): VioletQAMCGen (8 rows of 350) and
   VioletQAMCMLMHead (40 rows of 350) on ``mlm`` (``TRAIN_QAMC_MLM_LAUNCHES``),
   VioletQAMC with the gumbel video-token selection (``GUMBEL_TOKENS``
   heads) on ``ce`` (``TRAIN_QAMC_GUMBEL_LAUNCHES``; its projections get no
   gradient, as in JAX), each as phase 14, and each eval:
   ``qamc_gen_accuracy``, ``qamc_mlm_head_accuracy``, ``qamc_accuracy``.
31. Whole gumbel ce step: phase 15 for VioletQAMC(num_video_tokens=12), the
   same Gumbel noise injected on both sides.
32. The caption fine-tune step at full width: VioletCaptioning at
   configs/caption.json (Swin-base on 8 clips of 5 frames of 224^2,
   captions of 25 tokens corrupted as the JAX CaptionDataset corrupts them,
   the fusion over 8 rows of 275 under the seq2seq mask on row 5 with
   dropout and row 6), the ``caption`` step (``label_smoothed_nll``), as
   phase 14: captions/s, kernel time under the profiler, the device's idle
   share, peak memory; launches held to ``CAPTION_LAUNCHES``.
33. Whole caption step: phase 15 for VioletCaptioning (2 fusion rows of
   275 under the seq2seq mask).
34. Generation on the trained model of phase 32, through the capbench
   tool's ``bench`` (``generation_phase``): at batch 8 and max_len 20, the
   re-encoding greedy decoder (8 rows of 270 on row 5 a position), the K/V-
   cached one, beam search with 4 beams (32 rows of 270) and top-k sampling
   on the re-encoding decoder, each in captions/s, launches held to
   ``generate_launches``, none waiting on the card
   (``torch.cuda.set_sync_debug_mode``); in fp32 the two greedy decoders
   agree (or first differ within ``GREEDY_TIE_MARGIN``;
   the bf16 share of agreeing tokens is printed); ``caption_scores`` of the
   greedy captions range-checked.
35. The smtm pretrain step: phase 6 with the smtm task added (a second
   fusion of the 20 masked captions under the seq2seq mask, 20 rows of 232
   on rows 5 and 6; ``TRAIN_SMTM_LAUNCHES``), then its whole step as phase
   7.
36. The data layer's decode (``decode_phase``): nvJPEG (``data/jpeg.py``,
   built by nvcc into build/ apart from the kernels) on the committed
   fixture (``tools/jpeg_fixture.py``: 8 frames of 256 x 340) against
   cv2's decode of it, the largest and the mean absolute difference held to
   the fixture's limits; its time a frame and a batch; the transform
   executor on the card against itself on the CPU on the same decoded
   frames (crops and pads exact, resizes within one uint8 step); a frame
   whose header parses but whose decode fails marks its item corrupt.
37. The pixel step at full width fed by the loader (``loader_pretrain_phase``):
   ``MetaLoader`` over the webvid2.5m shards (4 frames) and cc3m (1 frame,
   the T = 1 Video Swin), written by ``tools/loaderbench.py`` from the
   fixture with shards that hold every timed batch within one epoch,
   through ``DevicePrefetcher``; the loader alone in clips/s, then
   ``LOADER_STEPS`` steps after warm-up steps that start every loader:
   wall ms by dataset against phase 6's, kernel time, the device's idle
   share, launches of a 4-frame step held to ``TRAIN_LAUNCHES``; then a
   4-frame and a 1-frame batch, each with a corrupt row, card fp32 against
   CPU fp32 on a depth-cut copy, as phase 7.
38. The retrieval ``nce``, open-ended QA ``mlm`` and generative
   multiple-choice ``mlm`` steps fed by their datasets at their real text
   lengths (25, 30 and 103 tokens), as phase 14, with their fusion routes
   and launches (``loader_finetune_phases``).
39. Checkpoints at full width (``checkpoint_phase``): the pretrain model
   through ``save_params`` / ``load_params`` as ``.msgpack`` and ``.npz``,
   bit-equal on the card; a reference-layout ``.pt`` through
   ``load_torch_violet_ckpt``; ``save_train_state`` then
   ``load_train_state``, the resumed step's losses against the
   uninterrupted one's; each file's size and seconds.
40. The user flow through each CLI's ``main`` at full width in bf16
   (``cli_phase``): ``cli.pretrain`` (one epoch from a seeded-bias
   checkpoint, val losses, ``restore.state``, the final checkpoint) ->
   ``cli.retrieval``, ``cli.qa`` (``qamc-gen``, ``qaoe-mlm``) and
   ``cli.caption`` (every trunk leaf loaded) -> ``cli.retrieval_eval`` and
   ``cli.parity_eval``; ``cli.convert_ckpt`` on phase 39's ``.pt``;
   ``cli.extract_vq`` read back by ``PretrainTsvDataset``. Each training
   CLI's steps probed (``StepProbe``): wall median beside the hand-wired
   loop's, kernel ms and idle share, 0 host waits on a non-logging step,
   launches held to the hand-wired step's.
41. Data parallelism at W = 1 (``nccl_w1_phase``): the process group that
    ``torch.distributed.run`` sets up for one process (NCCL, cuda:0); two
    pixel steps at full width in bf16 through the data-parallel path and
    through the plain one, losses and every parameter bit-equal, each step's
    ms beside the other's.
42. Two ranks on the one card (``gloo_w2_phase``): ``chip_smoke.py
    --dp-worker`` processes over gloo (NCCL refuses two ranks on one
    device) against one process, fp32 with TF32 off, dropout off, full
    width with the Video Swin at depths (2, 2, 2, 2) and a 2-layer fusion:
    the pixel step (10 rows a rank, the one-process draws) and the
    retrieval ``nce`` step (4 rows a rank), two steps each, held to
    ``DP_*``; the two-stage eval's metrics equal on every rank; each rank's
    ms and peak memory.
43. Rematerialisation (``remat_phase``): the pixel model's training pass
    with dropout on, without and with ``remat``, bf16 at full width and
    fp32 depth-cut: losses, the generator's state and every gradient
    bit-equal (or within the spread of two passes without remat, said per
    dtype), peak GiB and ms of each.
44. The pretrain CLI across ranks (``cli_dp_phase``): ``python -m
    torch.distributed.run --standalone --nproc_per_node=1`` on phase 40's
    shards with ``fsdp``, ``remat`` and ``grad_accum`` 2; every block
    sharded; its final checkpoint loads into the one-process port.
45. The swin2d-tiny pixel step at full width (``vis_backbone`` "swin2d",
    ``vis_backbone_size`` "tiny", concat; ``backbone_phases``): its stages
    0-1 run row 9 at N = 49, forward and backward, stages 2-3 rows 7-8;
    launches held to ``TRAIN_SWIN2D_TINY_LAUNCHES``, clips/s, kernel ms and
    the device's idle share; then its whole step as phase 7.
46. The r50 pixel step (concat, ``r50_train_bn``: batch statistics in its
    53 BatchNorms; ``TRAIN_R50_LAUNCHES``); its running statistics after two
    steps against the torch rule recomputed on the host, and the stem's
    batch statistics against its input (``bn_fold_check``); its whole step
    at ``R50_WHOLE_B`` clips (BatchNorm biases shifted by
    ``R50_BN_SHIFT``); the r50 ``nce`` retrieval step with mean fusion
    (``TRAIN_RET_R50_LAUNCHES``).
47. The merlot pixel step (the R50 and a trained ViT-base on each frame's
    50 tokens: rows 5-6 and the LayerNorm kernels; ``TRAIN_MERLOT_LAUNCHES``)
    and its whole step with the ViT cut to ``MERLOT_CUT``.
48. The pixel step with ``pretrain_masks`` ``AM_MASKS`` (the rollout, a
    no-grad pass over the unmasked batch; ``TRAIN_AM_LAUNCHES``), its wall
    and kernels beside phase 6's, the rollout's ms, and its draw
    (``am_draw_phase``): every am row masks exactly k slots, none special,
    and over ``AM_DRAWS`` seeded draws the slots' selection frequency ranks
    as their scores (Spearman, ``AM_SPEARMAN``).
49. The text encoder stack (``text_stack_phase``): the pixel step with
    ``txt_backbone_embed_only`` false (BERT-base over the 20 captions of 32
    tokens before the fusion: rows 5-6 and the LayerNorm kernels in its 12
    layers; ``TRAIN_STACK_LAUNCHES``) beside phase 6's, its whole step as
    phase 7 (the stack cut to 2 layers); ``cli.pretrain`` with the stack on
    phase 40's shards, then ``cli.retrieval_eval`` on its final checkpoint,
    adopting ``txt_backbone_embed_only`` from ``args.json`` and loading
    every leaf of the stack.
50. SwinBERT's layout (``swinbert_phase``): the caption step at
    configs/caption.json with ``swinbert`` (each frame's first video token a
    zero fake CLS with mask 0: rows 5-6 under a seq2seq mask with a hole in
    each frame's first key; ``CAPTION_SWINBERT_LAUNCHES``), its greedy
    re-encoding decoder at max_len 20 (fp32 tokens against the cached
    decoder's), ``cli.caption`` from a ``*SwinBERT*.pt`` written in
    SwinBERT's key names (every leaf loaded, ``img_embedding`` among them),
    and its whole step as phase 33.
51. The Video Swin's in-block dropouts (``swin_dropout_phase``): the pixel
    step with ``drop_rate`` ``SWIN_DROP`` (the direct kernels stay on), then
    with ``attn_drop_rate`` too (every window attention on
    ``window_attention_xla``, rows 3-4 not launched), each beside phase 6's
    with the route each block took, the sites' keep fraction, and each
    whole step with the same dropout masks on card and CPU.
52. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import pickle
import random
import shutil
import socket
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from empirical_mvm_torch.cli import caption as caption_cli
from empirical_mvm_torch.cli import convert_ckpt as convert_cli
from empirical_mvm_torch.cli import extract_vq as extract_vq_cli
from empirical_mvm_torch.cli import parity_eval as parity_eval_cli
from empirical_mvm_torch.cli import pretrain as pretrain_cli
from empirical_mvm_torch.cli import qa as qa_cli
from empirical_mvm_torch.cli import retrieval as retrieval_cli
from empirical_mvm_torch.cli import retrieval_eval as retrieval_eval_cli
from empirical_mvm_torch.core.config import SwinConfig, load_run_config
from empirical_mvm_torch.data.jpeg import NvJpegDecoder, jpeg_size, nvjpeg_libraries
from empirical_mvm_torch.data.jpeg import decode_counts as jpeg_decode_counts
from empirical_mvm_torch.data.datasets import PretrainTsvDataset
from empirical_mvm_torch.data.loader import (DevicePrefetcher, MetaLoader, ShardedBatchLoader,
                                             materialize)
from empirical_mvm_torch.data.masking import am_special, draw_masks, special_tokens
from empirical_mvm_torch.data.tokenizer import load_tokenizer
from empirical_mvm_torch.data.transforms import (TRANSFORMS, ClipPlan, FramePlan, plan_clip,
                                                 run_plans)
from empirical_mvm_torch.models import pretrain as pretrain_module
from empirical_mvm_torch.models.bert import BertLayer
from empirical_mvm_torch.models.captioning import VioletCaptioning
from empirical_mvm_torch.models import violet as violet_module
from empirical_mvm_torch.models.common import BatchNorm2d
from empirical_mvm_torch.models.encoders2d import EncImgMerlot, swin2d_config
from empirical_mvm_torch.models.pretrain import VioletPretrain, draw_negatives
from empirical_mvm_torch.models.tasks import (VioletQAMC, VioletQAMCGen, VioletQAMCMLMHead,
                                              VioletQAOE, VioletQAOEMLMHead, VioletRetrieval,
                                              draw_gumbel, qamc_mlm_head_accuracy)
from empirical_mvm_torch.models import video_swin as video_swin_module
from empirical_mvm_torch.models.video_swin import (SwinTransformer3D, SwinTransformerBlock3D,
                                                  _from_packed, _shift_attn_mask, _to_packed,
                                                  get_window_size)
from empirical_mvm_torch.models.violet import joint_attn_bias
from empirical_mvm_torch.ops import _build
from empirical_mvm_torch.ops import layernorm as ln
from empirical_mvm_torch.ops import window_attention as wa
from empirical_mvm_torch.ops.hog import hog_bins, hog_image
from empirical_mvm_torch.ops.preprocess import maybe_normalize
from empirical_mvm_torch.parallel import mesh
from empirical_mvm_torch.parallel.mesh import shard_model
from empirical_mvm_torch.teachers.clip import renormalize_imagenet_to_clip
from empirical_mvm_torch.teachers.dvae import DvaeEncoder, map_pixels, unnormalize_imagenet
from empirical_mvm_torch.tools import capbench, lanebench
from empirical_mvm_torch.tools.jpeg_fixture import load_fixture
from empirical_mvm_torch.tools.loaderbench import (build_downstream, build_pretrain,
                                                   downstream_dataset, loader_clips_per_s,
                                                   pretrain_meta_loader, shard_rows, with_data)
from empirical_mvm_torch.train import agent as agent_module
from empirical_mvm_torch.train.caption_metrics import caption_scores
from empirical_mvm_torch.train.checkpoint import (load_params, load_torch_violet_ckpt,
                                                  load_train_state, save_params,
                                                  save_train_state)
from empirical_mvm_torch.train.evaluators import (in_batch_retrieval_accuracy, qamc_accuracy,
                                                  qamc_gen_accuracy, qaoe_mlm_topk,
                                                  retrieval_two_stage_eval)
from empirical_mvm_torch.train.losses import masked_accuracy
from empirical_mvm_torch.train.optimizer import build_optimizer
from empirical_mvm_torch.train.train_step import (create_train_state, make_eval_step,
                                                  make_pretrain_train_step,
                                                  make_supervised_train_step, step_generators)

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "msrvtt-retrieval.json"
PRETRAIN_CONFIG = REPO / "configs" / "pretrain.json"
QAMC_CONFIG = REPO / "configs" / "msrvtt-mc.json"

# Main-path sizes of phase 4: one stage-1 encode batch of ITEMS captions with
# CLIPS clips each, and stage-2 chunks of CHUNK (text, video) pairs.
ITEMS, CLIPS, CHUNK = 16, 2, 64
EVAL_REPEATS = 7

# The train step: TRAIN_STEPS timed steps after one warm-up, the schedule of
# a run of TRAIN_MAX_ITER steps (warmup over its first 10%). The train-path
# kernel shapes of phase 3 follow from configs/pretrain.json at size_batch 20:
# swin (20, 4, 56>>s, 56>>s, 3*128<<s), N = 4*7*7 = 196; fusion rows 20 + 60
# negatives of L = 4 * (1 + 49) + 32 = 232.
TRAIN_STEPS, TRAIN_MAX_ITER, TRAIN_SEED = 10, 1000, 0
TRAIN_B, TRAIN_T, TRAIN_L, P_ATTN = 20, 4, 232, 0.1
# LayerNorm sites (label, rows, C, eps, dtype). Eval: fusion layers (CHUNK
# x 275 rows), EncVideo.norm (32 clips x 250), text embeddings (ITEMS x 25,
# fp32: the embedding sum stays fp32). Train step: fusion (80 x 232),
# EncVideo (20 x 4 x 50), text embeddings and MLM head (20 x 32). The frozen
# 2D teacher of the 2d_feature step (20 clips x 4 frames at 224^2, its
# grid 56 >> stage): the patch norm and the stage blocks' norm1/norm2, and
# the merge norms over 4C.
EVAL_LN = (("fusion", CHUNK * 275, 768, 1e-12, torch.bfloat16),
           ("enc_video", ITEMS * CLIPS * 250, 768, 1e-5, torch.bfloat16),
           ("embeddings", ITEMS * 25, 768, 1e-12, torch.float32))
TRAIN_LN = (("fusion", 80 * 232, 768, 1e-12, torch.bfloat16),
            ("enc_video", 20 * 4 * 50, 768, 1e-5, torch.bfloat16),
            ("embeddings", 20 * 32, 768, 1e-12, torch.float32),
            ("mlm_head", 20 * 32, 768, 1e-12, torch.bfloat16))
TEACHER_LN = tuple((f"teacher stage{s} norms", 80 * (56 >> s) ** 2, 128 << s, 1e-5,
                    torch.bfloat16) for s in range(4)) + tuple(
    (f"teacher merge{s}", 80 * (28 >> s) ** 2, 512 << s, 1e-5, torch.bfloat16)
    for s in range(3))
# the 3d_feature step's frozen Video Swin-base teacher (phase 18) has the 2D
# teacher's sites (the same rows: 20 clips x 4 frames at 56 >> stage) and a
# final norm; the 2d_clip step's CLIP ViT-B/32 (phase 19) normalizes 80
# frames of 50 tokens (pre_ln, then ln1 and ln2 in each of 12 layers)
TEACHER3D_LN = TEACHER_LN + (("teacher final norm", 80 * 49, 1024, 1e-5, torch.bfloat16),)
CLIP_LN = (("clip pre_ln/ln1/ln2", 80 * 50, 768, 1e-5, torch.bfloat16),)
# the depth step's DPT-Large (phase 22) normalizes 80 frames of 197 tokens
# (the class token and 14 x 14 patches) of width 1024, eps 1e-6, at norm1
# and norm2 of its 24 blocks; its fp32 run (phase 25) at the same shape
DPT_LN = (("dpt norm1/norm2", 80 * 197, 1024, 1e-6, torch.bfloat16),
          ("dpt norm1/norm2 fp32", 80 * 197, 1024, 1e-6, torch.float32))
# the MERLOT encoder's trained ViT-base (phase 47): 80 frames of 50 tokens
# (the CLS and 7 x 7 R50 features) through norm1 / norm2 (eps 1e-6) of each
# block and the embeddings' norm (eps 1e-5), forward and backward
MERLOT_LN = (("merlot vit norm1/norm2", 80 * 50, 768, 1e-6, torch.bfloat16),
             ("merlot embeds norm", 80 * 50, 768, 1e-5, torch.bfloat16))
# Each LayerNorm site is also held, in bf16, at rows of mean 50 and std 1
# (LARGE_MEAN), where a one-pass variance, E[x^2] - mean^2, cancels about
# 11 bits and fails the bf16 limits (tests/test_torch_layernorm_body.py). In
# bf16 these values are multiples of 1/4, which the fp32 sums add exactly,
# so the check reads the variance alone; in fp32, sums of 768 values near 50
# round by about 1e-5 in any order, the plain version's too, which is the
# fp32 limit itself.
LARGE_MEAN = (50.0, 1.0)
# launches of one train step: LayerNorm at 24 fusion sites + EncVideo +
# embeddings + MLM head; a swin attention in each of the 24 blocks; one
# fusion attention in each of the 12 layers
TRAIN_LAUNCHES = {"fused_layer_norm": 27, "fused_layer_norm_bwd": 27,
                  "direct_window_attention": 24, "direct_window_attention_bwd": 24,
                  "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
# the 2d_feature step adds the frozen 2D Swin-base teacher, forward only: a
# lane window attention in each of its 24 blocks, and the kernel
# LayerNorm at its 52 sites (patch norm, 2 x 24 block norms, 3 merge norms)
TRAIN_2D_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 52,
                     "lane_window_attention": 24}
# the swin2d step (phase 10): the student's 24 blocks run the lane window
# kernel forward and backward instead of the direct kernels; its LayerNorms
# stay plain, and the kernel LayerNorm keeps its 27 sites (EncImgSwin's
# embeddings norm in place of EncVideo's)
TRAIN_SWIN2D_LAUNCHES = {"fused_layer_norm": 27, "fused_layer_norm_bwd": 27,
                         "lane_window_attention": 24, "lane_window_attention_bwd": 24,
                         "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
# the violet step (phase 12): the C = 96 Video Swin's 4 blocks of stages 0
# and 1 (C = 96, 192: no multiple of 128) run the packed kernel, its 20
# blocks of stages 2 and 3 the direct kernels; the rest as the pixel step
TRAIN_VIOLET_LAUNCHES = {**TRAIN_LAUNCHES, "direct_window_attention": 20,
                         "direct_window_attention_bwd": 20, "packed_window_attention": 4,
                         "packed_window_attention_bwd": 4}
# the 3d_feature step (phase 18) adds the frozen Video Swin-base teacher,
# forward only: a direct window attention in each of its 24 blocks, and the
# kernel LayerNorm at its 53 sites (the 2D teacher's 52 and a final norm)
TRAIN_3D_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 53,
                     "direct_window_attention": 24 + 24}
# the 2d_clip step (phase 19) adds the frozen CLIP ViT-B/32 on 80 frames of
# 50 tokens: lane_self_attention (p = 0, lane_sa_attention_fits) in each of
# its 12 layers, the kernel LayerNorm at pre_ln and 2 x 12 layer sites (the
# post LayerNorm reads the pooled CLS token, which the target does not use)
TRAIN_CLIP_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 1 + 2 * 12,
                       "lane_self_attention": 12}
# the hog step (phase 20): HOG is torch ops; the kernels are the pixel step's
TRAIN_HOG_LAUNCHES = dict(TRAIN_LAUNCHES)
# the depth step (phase 22) adds the frozen DPT-Large on 80 frames of 197
# tokens: lane_self_attention (p = 0, lane_sa_attention_fits) in each of its
# 24 blocks and the kernel LayerNorm at norm1 and norm2 of each; its
# reassemble and fusion convolutions are cuDNN's
TRAIN_DEPTH_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 2 * 24,
                        "lane_self_attention": 24}
# the vq (phase 23) and optical_flow (phase 24) steps: the dVAE and RAFT
# teachers are convolutions, products and gathers; the kernels are the
# pixel step's
TRAIN_VQ_LAUNCHES = dict(TRAIN_LAUNCHES)
TRAIN_FLOW_LAUNCHES = dict(TRAIN_LAUNCHES)
# the swin2d-tiny step (phase 45): the 2D Swin-tiny's 4 blocks of stages 0-1
# (C = 96, 192) run the packed kernel forward and backward (row 9 at N =
# 49), its 8 blocks of stages 2-3 (C = 384, 768) the lane window kernels;
# the LayerNorm kernel keeps the swin2d step's 27 sites
TRAIN_SWIN2D_TINY_LAUNCHES = {"fused_layer_norm": 27, "fused_layer_norm_bwd": 27,
                              "packed_window_attention": 4, "packed_window_attention_bwd": 4,
                              "lane_window_attention": 8, "lane_window_attention_bwd": 8,
                              "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
# the r50 step (phase 46): the ResNet-50's convolutions are cuDNN's and its
# BatchNorms torch ops; the kernels are the fusion's and the LayerNorm's at
# its 27 sites (EncImgR50's embeddings norm in place of EncVideo's)
TRAIN_R50_LAUNCHES = {"fused_layer_norm": 27, "fused_layer_norm_bwd": 27,
                      "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
# the r50 nce step (phase 46): mean fusion, so 64 rows of 50 + 25 tokens
TRAIN_RET_R50_LAUNCHES = {"fused_layer_norm": 26, "fused_layer_norm_bwd": 26,
                          "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
# the merlot step (phase 47) adds the trained ViT-base on 80 frames of 50
# tokens: row 5 (p = 0) and row 6 in each of its 12 blocks, the LayerNorm
# kernel at norm1 and norm2 of each, forward and backward
TRAIN_MERLOT_LAUNCHES = {"fused_layer_norm": 27 + 2 * 12, "fused_layer_norm_bwd": 27 + 2 * 12,
                         "lane_self_attention": 12, "lane_self_attention_dropout": 12,
                         "lane_self_attention_bwd": 12 + 12}
# the am step (phase 48) adds the rollout, a no-grad pass over the unmasked
# batch: the Video Swin's 24 blocks on the direct kernel, the LayerNorm at
# EncVideo's, the text embeddings' and the 24 fusion sites; its fusion
# attention is plain (the probabilities leave it, as JAX's XLA branch)
TRAIN_AM_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 26,
                     "direct_window_attention": 24 + 24}
# MVM targets whose model holds a frozen teacher (vq only on the fly)
TEACHER_TARGETS = {"2d_feature", "3d_feature", "2d_clip", "depth", "optical_flow"}
TEACHERS = ("feature_model.", "clip_model.", "dpt.", "raft.", "dvae.")
EVAL_KERNELS = ("fused_layer_norm", "direct_window_attention", "lane_self_attention")
# The multiple-choice fine-tune step of configs/msrvtt-mc.json (phase 14):
# batch 8 questions of 5 options over 5 frames of 224^2, so the fusion runs
# 40 rows of L = 5 * 50 + 100 = 350 tokens, which lane_sa_attention_fits
# refuses: its 12 layers take the tiled self-attention (row 11) forward with
# dropout and backward, and no lane_self_attention. LayerNorm: 24 fusion
# sites, EncVideo and the text embeddings; the swin's 24 blocks the direct
# kernels (N = 245). The eval (phase 16) runs the forwards of one step.
QAMC_B, QAMC_O, QAMC_L = 8, 5, 350
TRAIN_QAMC_LAUNCHES = {"fused_layer_norm": 26, "fused_layer_norm_bwd": 26,
                       "direct_window_attention": 24, "direct_window_attention_bwd": 24,
                       "packed_self_attention": 12, "packed_self_attention_bwd": 12}
QAMC_EVAL_BATCHES = 4
# The downstream heads' fine-tune steps (phases 26-31), each at its shipped
# config's batch, Swin-base on 5 frames of 224^2 (250 video tokens):
# * retrieval (msrvtt-retrieval, ``nce``): 8 clips and 8 captions of 25
#   tokens, all 64 pairs fused, 64 rows of L = 275: lane_self_attention
#   (row 5 with dropout, row 6), as the pretrain step's fusion;
# * open-ended QA (msrvtt-qa): 10 rows of L = 275, the 1500-way score head
#   (``ce``) or the MLM head (``mlm``, one LayerNorm site more: its
#   transform);
# * multiple choice (tgif-action): the generative head on 8 rows of L = 350
#   and the MLM head on 40 (``mlm``), and the gumbel video-token selection
#   of VioletQAMC (``ce``, ``GUMBEL_TOKENS`` heads), all on the tiled
#   self-attention (row 11), as phase 14.
# LayerNorm: 24 fusion sites, EncVideo and the text embeddings (+ the MLM
# head's); the swin's 24 blocks the direct kernels. Each eval runs the
# forwards of its step.
RET_CONFIG, QAOE_CONFIG, QAMC_GEN_CONFIG = CONFIG, REPO / "configs" / "msrvtt-qa.json", (
    REPO / "configs" / "tgif-action.json")
TRAIN_RET_LAUNCHES = {"fused_layer_norm": 26, "fused_layer_norm_bwd": 26,
                      "direct_window_attention": 24, "direct_window_attention_bwd": 24,
                      "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
TRAIN_QAOE_LAUNCHES = dict(TRAIN_RET_LAUNCHES)
TRAIN_QAOE_MLM_LAUNCHES = {**TRAIN_RET_LAUNCHES, "fused_layer_norm": 27,
                           "fused_layer_norm_bwd": 27}
TRAIN_QAMC_MLM_LAUNCHES = {**TRAIN_QAMC_LAUNCHES, "fused_layer_norm": 27,
                           "fused_layer_norm_bwd": 27}
TRAIN_QAMC_GUMBEL_LAUNCHES = dict(TRAIN_QAMC_LAUNCHES)
GUMBEL_TOKENS = 12                  # num_video_tokens: 12 heads of 64 over 768
FINETUNE_EVAL_BATCHES = 3
# bert-base-uncased's ids of [MASK], of the digits "0" to "4" (the generative
# multiple choice's answers) and of "true" / "false" (the MLM-head multiple
# choice's); the port has no tokenizer yet, the synthetic batches use them
MASK_ID, DIGIT_IDS, TRUE_ID, FALSE_ID = 103, (1014, 1015, 1016, 1017, 1018), 2995, 6270
# the open-ended QA prompt of the whole-step check (phase 29): [CLS], 9
# seeded tokens, [SEP], as the JAX get_prompt encodes "fill in the mask to
# complete the sentence."
PROMPT_LEN = 11
# phase 3's records at the fine-tune steps' shapes: row 5 with dropout and
# row 6 at the retrieval fusion (64 rows of 275, captions of 25); the
# LayerNorm forward and backward at each step's sites (rows, C, eps): the
# fusion, EncVideo, the MLM head (bf16) and the text embeddings (fp32); the
# direct kernels at the open-ended QA's 10 clips (8 are the MC step's)
FINETUNE_LANE = (64, 275, 25)
FINETUNE_LN = (("retrieval fusion", 64 * 275, 768, 1e-12, torch.bfloat16),
               ("qaoe fusion", 10 * 275, 768, 1e-12, torch.bfloat16),
               ("qamc-gen fusion", 8 * 350, 768, 1e-12, torch.bfloat16),
               ("mc fusion", 40 * 350, 768, 1e-12, torch.bfloat16),
               ("enc_video 8 clips", 8 * 250, 768, 1e-5, torch.bfloat16),
               ("enc_video 10 clips", 10 * 250, 768, 1e-5, torch.bfloat16),
               ("qaoe mlm_head", 10 * 25, 768, 1e-12, torch.bfloat16),
               ("qamc-gen mlm_head", 8 * 100, 768, 1e-12, torch.bfloat16),
               ("qamc-mlm mlm_head", 40 * 100, 768, 1e-12, torch.bfloat16),
               ("retrieval embeddings", 8 * 25, 768, 1e-12, torch.float32),
               ("qaoe embeddings", 10 * 25, 768, 1e-12, torch.float32),
               ("qamc-gen embeddings", 8 * 100, 768, 1e-12, torch.float32),
               ("mc embeddings", 40 * 100, 768, 1e-12, torch.float32))
QAOE_B = 10
# phase 3's records at the loader-fed steps' own shapes (phases 37 and 38;
# each step's kernel calls, read off a CPU run of the same batches): the
# pretrain step's cc3m batches run the Video Swin at T = 1 (20 clips, window
# (1, 7, 7), N = 49) and the fusion on 80 rows of L = 50 + 32 = 82; the
# QA-OE mlm rows carry "answer: [MASK] [SEP]" (10 rows of 250 + 30 = 280);
# the generative MC prompt holds the options (8 rows of 250 + 103 = 353,
# row 11). Rows 5-6 (label, rows, L, text tokens) and the LayerNorm sites,
# forward and backward: the fusion, EncVideo, the MLM head (bf16) and the
# text embeddings (fp32).
LOADER_LANE = (("cc3m ", 4 * TRAIN_B, 82, 32), ("qaoe mlm ", QAOE_B, 280, 30))
LOADER_LN = (("cc3m fusion", 80 * 82, 768, 1e-12, torch.bfloat16),
             ("cc3m enc_video", 20 * 50, 768, 1e-5, torch.bfloat16),
             ("qaoe-mlm fusion", QAOE_B * 280, 768, 1e-12, torch.bfloat16),
             ("qaoe-mlm mlm_head", QAOE_B * 30, 768, 1e-12, torch.bfloat16),
             ("qaoe-mlm embeddings", QAOE_B * 30, 768, 1e-12, torch.float32),
             ("tgif-action fusion", 8 * 353, 768, 1e-12, torch.bfloat16),
             ("tgif-action mlm_head", 8 * 103, 768, 1e-12, torch.bfloat16),
             ("tgif-action embeddings", 8 * 103, 768, 1e-12, torch.float32))
# Captioning (phases 32-34) at configs/caption.json: 8 clips of 5 frames of
# 224^2 and captions of 25 tokens, so the caption step's fusion runs 8 rows of
# L = 250 + 25 = 275 under the seq2seq joint mask: row 5 with dropout and
# row 6. Its launches are the QA-OE mlm step's (24 fusion LayerNorm sites,
# EncVideo, the text embeddings and the MLM head's transform). The synthetic
# captions are corrupted as the JAX CaptionDataset corrupts them: each token
# between [CLS] and [SEP] becomes [MASK] with probability CAPTION_MASK_PROB
# (at least one a caption), its id the answer.
CAPTION_CONFIG = REPO / "configs" / "caption.json"
CAPTION_B = 8                                   # caption.json's size_batch
CAPTION_MASK_PROB = 0.15
CAPTION_LAUNCHES = {"fused_layer_norm": 27, "fused_layer_norm_bwd": 27,
                    "direct_window_attention": 24, "direct_window_attention_bwd": 24,
                    "lane_self_attention_dropout": 12, "lane_self_attention_bwd": 12}
# Generation (phase 34), as the JAX caption CLI runs it (max_len 20): at each
# of the 19 positions the re-encoding decoder fuses the batch's 8 rows (beam
# search: 8 x GEN_BEAM) of L = 250 + 20 = 270 under the seq2seq mask (row 5,
# p = 0; LayerNorm at the text embeddings, 24 fusion sites and the MLM
# head), after one video encoding (the swin's 24 direct attentions and
# EncVideo's norm); the K/V-cached decoder runs its fusion as torch ops and
# launches the MLM head's LayerNorm alone a position. Sampling (top-k
# GEN_TOP_K) runs the re-encoding decoder, ``generate``.
GEN_MAX_LEN, GEN_BEAM, GEN_TOP_K, GEN_ITERS = 20, 4, 5, 3
# phase 3's LayerNorm records at the captioning paths' sites (rows, C, eps,
# dtype): the caption step's fusion (8 x 275) and MLM head (8 x 25),
# forward and backward; the smtm step's second fusion (20 x 232), forward
# and backward (its MLM head and text embeddings are TRAIN_LN's 640 rows);
# the forward at each decoded position: the re-encoding decoder's fusion (8
# x 270), MLM head (8 rows) and fp32 text embeddings (8 x 20), and beam
# search's (GEN_BEAM beams a clip: 32 x 270, 32, 32 x 20); the cached
# decoder's MLM head is the greedy one's 8 rows. The caption step's text
# embeddings (8 x 25) and EncVideo (8 clips) are FINETUNE_LN's sites.
CAPTION_LN = (("caption fusion", CAPTION_B * 275, 768, 1e-12, torch.bfloat16),
              ("caption mlm_head", CAPTION_B * 25, 768, 1e-12, torch.bfloat16))
SMTM_LN = (("smtm fusion", 20 * 232, 768, 1e-12, torch.bfloat16),)
DECODE_LN = tuple(
    row for label, b in (("greedy", CAPTION_B), ("beam", CAPTION_B * GEN_BEAM)) for row in (
        (f"{label} fusion", b * (250 + GEN_MAX_LEN), 768, 1e-12, torch.bfloat16),
        (f"{label} mlm_head", b, 768, 1e-12, torch.bfloat16),
        (f"{label} embeddings", b * GEN_MAX_LEN, 768, 1e-12, torch.float32)))


def generate_launches(cached):
    steps = GEN_MAX_LEN - 1
    if cached:
        return {"direct_window_attention": 24, "fused_layer_norm": 1 + steps}
    return {"direct_window_attention": 24, "fused_layer_norm": 1 + 26 * steps,
            "lane_self_attention": 12 * steps}


# The greedy tokens of the cached decoder (torch ops) and of the re-encoding
# one (the kernels), both in fp32 on the card, must be identical, or differ
# first where the top two logits lie within GREEDY_TIE_MARGIN: fp32 sums in
# two orders through 12 layers move logits of scale 0.5 (random weights) by
# about 1e-5 of it; a margin under 1e-4 is a tie that roundoff may break.
GREEDY_TIE_MARGIN = 1e-4
# The smtm pretrain step (phase 35): configs/pretrain.json with the smtm task
# added, a second fusion of the 20 masked captions under the seq2seq mask
# (20 rows of 232, row 5 with dropout and row 6) and its MLM head: the pixel
# step's launches, 12 + 12 attention and 24 + 1 LayerNorm launches more.
TRAIN_SMTM_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 25,
                       "fused_layer_norm_bwd": 27 + 25, "lane_self_attention_dropout": 24,
                       "lane_self_attention_bwd": 24}
# phase 3's records of rows 5 and 6 under the seq2seq joint mask (label,
# rows, L, text tokens, p, on a path of this script): the caption step, the
# greedy and beam decoders, the smtm fusion, and the pretrain fusion's 80
# rows under the same mask (no path takes it: the smtm fusion is 20 rows)
SEQ2SEQ_LANE = (("caption", CAPTION_B, 275, 25, P_ATTN, True),
                ("greedy decode", CAPTION_B, 270, GEN_MAX_LEN, 0.0, True),
                ("beam decode", CAPTION_B * GEN_BEAM, 270, GEN_MAX_LEN, 0.0, True),
                ("smtm", TRAIN_B, TRAIN_L, 32, P_ATTN, True),
                ("80 pretrain rows", 4 * TRAIN_B, TRAIN_L, 32, P_ATTN, False))
# row 11 (the tiled self-attention, kTiles layout) under the same mask, at a
# length that lane_sa_attention_fits refuses, so BERT routes it to row 11
# (label, rows, L, text tokens, p): no path of this script takes it
SEQ2SEQ_TILED = (("seq2seq 350 tokens", CAPTION_B, 350, 100, P_ATTN),)

# Limits. A tolerance is dict(atol=..., rtol=..., scale=...): an element may
# differ by atol + rtol * |reference| + scale * max|reference|. Gradients
# have no natural unit, so the backward limits are mostly in ``scale``.
#
# fp32 with TF32 off, kernel against the plain version: the same arithmetic
# in another summation order. Forward attention 1e-4 and LayerNorm 1e-5 (as
# in the first slice); the backward outputs sum longer chains (dbias over up
# to 1280 windows, dgamma/dbeta over up to 18,560 rows), 1e-4 of their scale,
# and the LayerNorm dx 1e-5 of its scale.
FP32_LIMITS = {
    "attention": {"out": dict(atol=1e-4)},
    "layer_norm": {"out": dict(atol=1e-5)},
    "attention_bwd": {"dx3": dict(scale=1e-4), "dbias": dict(scale=1e-4)},
    "layer_norm_bwd": {"dx": dict(scale=1e-5), "dgamma": dict(scale=1e-4),
                       "dbeta": dict(scale=1e-4)},
}
# bf16. Against the plain version in fp32 on the same bf16 inputs (first
# slice): attention within about 3.5x its largest reading (1.4e-3, see
# PERF.md), and LayerNorm within half a bf16 step of its output, the one
# rounding it adds. Against the plain version run in bf16, which repeats the
# kernels' roundings (q * scale and the probabilities rounded to bf16): one
# bf16 step of the output, and for attention at most BF16_MISMATCH of the
# elements may differ at all (a dropped inner rounding shows there first;
# LayerNorm rounds only its output, which the one-step limit covers).
BF16_VS_FP32 = {"attention": dict(atol=5e-3, rtol=0.0),
                "layer_norm": dict(atol=1e-5, rtol=2.0 ** -8)}
BF16_SAME_ROUNDING = dict(atol=1e-5, rtol=2.0 ** -7)
BF16_MISMATCH = 1e-3
# bf16 backward, per output.
# * attention dx3 against plain fp32: the kernel rounds p and ds to bf16
#   before their products, as the JAX kernels do, and the fp32 plain version
#   does not; ds sums to zero along each row, so dq and dk are cancelling
#   sums whose rounding noise is a few bf16 steps of the terms: 2e-2 of the
#   output's scale. Against plain bf16 (the same roundings): one bf16 step
#   of the element plus 1e-3 of the scale for an inner rounding of ds that
#   falls the other way after a different fp32 summation order, and at most
#   BF16_BWD_MISMATCH of the elements may differ at all: 33x the largest
#   share read on the H100 (3.05e-5, PERF.md). A dropped rounding of ds or p
#   moves far more elements.
# * attention dbias is fp32 from fp32 ds, but ds comes from scores of
#   q * scale rounded to bf16 (the scale too), which plain fp32 does not
#   round: 2e-2 of its scale, as dx3. Against plain bf16 (the same
#   roundings) only the summation order differs: 1e-4 of its scale.
# * LayerNorm dx rounds once, at its output: half a bf16 step against plain
#   fp32, one step against plain bf16, plus 1e-5 of the scale where the
#   subtraction cancels; dgamma and dbeta are fp32 sums: 1e-4 of the scale.
BF16_BWD_MISMATCH = 1e-3
BF16_LIMITS = {
    "attention": {"out": (BF16_VS_FP32["attention"], BF16_SAME_ROUNDING, BF16_MISMATCH)},
    "layer_norm": {"out": (BF16_VS_FP32["layer_norm"], BF16_SAME_ROUNDING, None)},
    "attention_bwd": {"dx3": (dict(scale=2e-2), dict(rtol=2.0 ** -7, scale=1e-3),
                              BF16_BWD_MISMATCH),
                      "dbias": (dict(scale=2e-2), dict(scale=1e-4), None)},
    "layer_norm_bwd": {"dx": (dict(rtol=2.0 ** -8, scale=1e-5),
                              dict(rtol=2.0 ** -7, scale=1e-5), None),
                       "dgamma": (dict(scale=1e-4), dict(scale=1e-4), None),
                       "dbeta": (dict(scale=1e-4), dict(scale=1e-4), None)},
}
# the backward of fused_window_attention returns dq, dk and dv apart: each
# is held as the backward's dx3
for _lim in (FP32_LIMITS, BF16_LIMITS):
    _lim["attention_bwd_qkv"] = {**{g: _lim["attention_bwd"]["dx3"] for g in ("dq", "dk", "dv")},
                                 "dbias": _lim["attention_bwd"]["dbias"]}
    # the tiled self-attention's backward: dqkv (packed) or dq, dk, dv
    # (split), no bias, each held as the backward's dx3
    _lim["sa_bwd"] = {"dqkv": _lim["attention_bwd"]["dx3"]}
    _lim["sa_bwd_qkv"] = {g: _lim["attention_bwd"]["dx3"] for g in ("dq", "dk", "dv")}
# the tiled self-attention's forward ("sa"): as attention, but against plain
# bf16 one bf16 step plus 1e-3 of the output's scale, the backward's term for
# an inner rounding that falls the other way. Some fp32 probabilities of
# the plain softmax and of the kernel's exp(s - max) / sum differ in their
# last bit (the exp and the division are not torch's); a
# p that then rounds the other way in bf16 moves an output that cancels to
# near 0 by ulp(p) |v|, above one bf16 step of that output (at N = 577,
# tests/test_torch_self_attention.py holds the kernel's arithmetic, emulated,
# to this limit). A dropped rounding still moves far more than
# BF16_MISMATCH of the elements.
# Row 11's mismatch share: its bf16 body (hd 32, 64, 128) sums the scores
# on the tensor cores, in another order than the plain version's fp32 chain,
# so some fp32 scores differ in their last bit and a p near a bf16 rounding
# boundary rounds the other way; each such p moves outputs by a step. On
# the H100 that moves 1.12e-3 of the forward's outputs and 1.38e-3 of dq,
# dk and dv at N = 577, 6.6e-4 and 7.6e-4 at the multiple-choice shape,
# where the CUDA-core body reads 3.4e-4 and 3.0e-4 (PERF.md); the CPU
# emulation of the new order reads the same (tests/test_torch_self_attention.py).
# SA_MISMATCH is about twice the largest reading; the planted faults of row
# 11 move 13-51 % of the elements.
SA_MISMATCH = 3e-3
FP32_LIMITS["sa"] = FP32_LIMITS["attention"]
BF16_LIMITS["sa"] = {"out": (BF16_VS_FP32["attention"],
                             dict(atol=1e-5, rtol=2.0 ** -7, scale=1e-3), SA_MISMATCH)}
BF16_LIMITS["sa_bwd"] = {"dqkv": BF16_LIMITS["attention_bwd"]["dx3"][:2] + (SA_MISMATCH,)}
BF16_LIMITS["sa_bwd_qkv"] = {g: BF16_LIMITS["sa_bwd"]["dqkv"] for g in ("dq", "dk", "dv")}
# The window-attention backward's tensor-core body (rows 4, 8, 9, 10 in
# bf16 at hd 32, csrc/attention_bwd_mma.cuh; kind "window_bwd_tc"): against
# plain bf16 one bf16 step plus WINDOW_TC_STEP_SCALE of the output's scale.
# Its scores and dp sum on the tensor cores, in another order than the plain
# version's fp32 chains (and with the tensor cores' own alignment of the
# products, which torch's CPU sums do not reproduce: the CPU emulation in
# tests/test_torch_bwd_mma.py reads no element over one step at N = 196), so
# a p near a bf16 rounding boundary may round the other way and move a dv
# element by ulp(p) |do|: with N = 49 and a shift mask, p reaches 1/2 and
# |do| 4. On the H100 the largest reading is 1.03e-3 of dx3's scale (2D swin
# stage 1, shifted; 1.6e-5 of the elements above one step, PERF.md), above
# the CUDA-core body's 1e-3; the limit is about three times that. The
# mismatch share (BF16_BWD_MISMATCH) and the dbias limits are the CUDA-core
# body's: the planted fault of the body (ds rounded before dbias) moves
# dbias far past 1e-4 of its scale.
WINDOW_TC_STEP_SCALE = 3e-3
FP32_LIMITS["window_bwd_tc"] = FP32_LIMITS["attention_bwd"]
FP32_LIMITS["window_bwd_tc_qkv"] = FP32_LIMITS["attention_bwd_qkv"]
BF16_LIMITS["window_bwd_tc"] = {
    "dx3": (dict(scale=2e-2), dict(rtol=2.0 ** -7, scale=WINDOW_TC_STEP_SCALE),
            BF16_BWD_MISMATCH),
    "dbias": BF16_LIMITS["attention_bwd"]["dbias"]}
BF16_LIMITS["window_bwd_tc_qkv"] = {
    **{g: BF16_LIMITS["window_bwd_tc"]["dx3"] for g in ("dq", "dk", "dv")},
    "dbias": BF16_LIMITS["attention_bwd"]["dbias"]}
# The window forwards' tensor-core body (rows 3, 7, 9, 10, 12 in bf16 at hd
# 32, csrc/attention_fwd_mma.cuh; kind "window_fwd_tc"): row 11's forward
# limits (``sa``) with a wider scale term, for row 11's reason. Its scores sum on the tensor cores, in
# another order than the plain version's fp32 chain, and its row sums over
# the lanes and a warp butterfly, so a p near a bf16 rounding boundary may
# round the other way and move an output that cancels to near 0 by ulp(p)
# |v|, above one bf16 step of that output. The CPU emulation
# (tests/test_torch_fwd_mma.py) exceeds the CUDA-core one-step limit by up
# to 1.5e-5 (1.6e-4 of the elements over a step) and differs from plain
# bf16 in up to 8.3e-4 of the elements, near BF16_MISMATCH. On the H100 the
# body exceeds one step by up to 2.5e-4 at the N = 196 and 245 shapes, 5.0e-4
# at N = 49 with the shift mask (rows 7 and 9), at under 3e-5 of the
# elements, and up to 3.8e-4 of its elements differ. The planted fault of
# the body moves 55 % of the elements.
# The scale term is derived from the body's arithmetic at N = 49 with the
# shift mask, its tightest case: a query of a shifted 7 x 7 window sees at
# least the 9 keys of the 3 x 3 corner region, and with the paths' scores
# (bias 0.02, q.k of bf16 values of std 0.5 at hd 32) no p reaches 1/4, so
# the bf16 step of a p that rounds the other way is at most ulp(1/8) =
# 2^-10; an output averages 9 or more values of v, so its scale is about
# 1/sqrt(9) of the largest |v|, and the flipped p moves it by at most ulp(p)
# |v| = 3 * 2^-10 = 2.9e-3 of that scale. On the H100 the largest reading is
# 7.27e-4 over one step at an output scale of 0.71, 1.03e-3 of the scale
# (row 9 at the 2D Swin-tiny stage-0 shifted shape, in two builds of the
# body alike; PERF.md), which the 1e-3 of ``sa`` missed by 2.0e-5. The
# term stays under the backward's WINDOW_TC_STEP_SCALE; the mismatch share
# stays SA_MISMATCH, and the planted fault of the body (52-55 % of the
# outputs) fails it still.
WINDOW_FWD_TC_STEP_SCALE = 3 * 2.0 ** -10
FP32_LIMITS["window_fwd_tc"] = FP32_LIMITS["attention"]
BF16_LIMITS["window_fwd_tc"] = {"out": (
    BF16_VS_FP32["attention"],
    dict(atol=1e-5, rtol=2.0 ** -7, scale=WINDOW_FWD_TC_STEP_SCALE), SA_MISMATCH)}
OUTPUTS = {kind: tuple(lim) for kind, lim in FP32_LIMITS.items()}
# dropout keep fraction: 1 - p within 5 binomial standard deviations
KEEP_SIGMAS = 5.0
# the whole train step, card fp32 against CPU fp32: losses at rtol 1e-4;
# each gradient within 2e-3 of its own largest value plus 1e-6 of the
# largest gradient anywhere (summation orders through 8 swin blocks, 2
# fusion layers and the heads; the floor covers gradients that are zero in
# exact arithmetic, such as the key biases under the shift-invariant softmax)
WHOLE_STEP_TOL = dict(loss_rtol=1e-4, grad_scale=2e-3, grad_global=1e-6)
# The multiple-choice score head's output bias adds the same value to every
# option, so the cross entropy over the options gives it a gradient of 0 in
# exact arithmetic; each side's reads as fp32 roundoff of sums of 10 rows of
# O(1) (about 1e-7 on an H100), held to this bound rather than to the
# other side's roundoff, which the floor of WHOLE_STEP_TOL (1e-6 of a largest
# gradient of 0.12) does not cover.
ZERO_GRAD_ATOL = 1e-6
# The retrieval score head's output bias shifts all B^2 scores alike, which
# the bidirectional InfoNCE does not see: its gradient, the sum of the
# scores' gradients, is zero in exact arithmetic. Each score's gradient is
# up to 2 / (B temp) = 20 at the whole-step check's B = 2 and temp 0.05,
# and fp32 sums of four of them round by a few ulp(20) = 1.9e-6: the bound
# is ZERO_GRAD_ATOL scaled by 1 / temp.
NCE_ZERO_GRAD_ATOL = ZERO_GRAD_ATOL / 0.05

# hog_image, card against CPU on the same normalized clips (phase 21): a
# pixel falls in another orientation bin only where its angle lies within
# the last bit of atan2 and of the division of a bin edge: at most
# HOG_FLIP_SHARE of the pixels may. In the cells where no pixel changed bin,
# the rendering may differ by HOG_CELL_SCALE of its largest value (hypot and
# atan2 to the last bit, 64-term fp32 sums in another order).
HOG_FLIP_SHARE = 1e-4
HOG_CELL_SCALE = 1e-5
# The DPT, RAFT and dVAE teachers, card fp32 against CPU fp32 on the same
# weights and clips (phase 25). Depth and flow: within TEACHER_FP32_SCALE of
# the output's largest value: the convolutions' fp32 sums in cuDNN's order
# and oneDNN's (TF32 off), the kernels against the plain versions (within
# 1e-4 and 1e-5, phase 3), through 4 ViT-L blocks and the fusion stack, or
# through RAFT's 12 updates, whose lookups feed each update's error back
# into the next. The dVAE tokens: at most VQ_FLIP_SHARE of the cells may
# take another token, where the top two of a cell's 8192 logits lie within
# the two sums' fp32 difference (about 1e-6 of the logits' scale); the
# step is fed the CPU's tokens on both sides, as the hog step its target.
TEACHER_FP32_SCALE = 1e-4
VQ_FLIP_SHARE = 1e-3
# The L1 losses (``masked_l1``: the pixel, hog, depth, flow and feature
# targets) take each masked element's sign of pred - target. Where that
# difference lies within the two sides' roundoff of 0, the card and the CPU
# take opposite signs, and one such element moves its decoder's bias
# gradient by 2 / (sum(mask) channel_div): 8.8e-6 at a 4-clip step's cover
# of 75776 pixels, 2.3 times WHOLE_STEP_TOL's bound on the pixel decoder's
# bias there. So the CPU's step takes the card's sign where the two differ
# (``SameL1Signs``; its loss value unchanged), as the vq step takes one
# side's tokens: at most L1_FLIP_SHARE of the masked elements may differ,
# each where the two sides' errors lie within L1_FLIP_SCALE of the largest
# masked error (the teachers' fp32 limit, TEACHER_FP32_SCALE).
L1_FLIP_SHARE = 1e-4
L1_FLIP_SCALE = TEACHER_FP32_SCALE
# the depth step's whole-step check (phase 25) runs the DPT cut to 4 blocks,
# each captured, so that the CPU side stays short
DPT_CUT = dict(vit_depth=4, hooks=(0, 1, 2, 3))

# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16_tensor": 989e12, "fp32": 67e12}

KERNELS = {
    "direct_window_attention": dict(
        source="empirical_mvm_torch/csrc/window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1306"),
    "lane_self_attention": dict(
        source="empirical_mvm_torch/csrc/self_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1089"),
    "fused_layer_norm": dict(
        source="empirical_mvm_torch/csrc/layer_norm.cu",
        replaces="empirical_mvm_tpu/ops/layernorm.py:55"),
    "fused_layer_norm_bwd": dict(
        source="empirical_mvm_torch/csrc/layer_norm.cu",
        replaces="empirical_mvm_tpu/ops/layernorm.py:66"),
    "direct_window_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1443"),
    "lane_self_attention_dropout": dict(
        source="empirical_mvm_torch/csrc/self_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1089"),
    "lane_self_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/self_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1129"),
    "lane_window_attention": dict(
        source="empirical_mvm_torch/csrc/lane_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:810"),
    "lane_window_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/lane_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:853"),
    # rows 9 and 10 run one pair of kernel bodies (`_attn_kernel` :69,
    # `_attn_bwd_kernel` :109); named here by their pallas_call sites
    "packed_window_attention": dict(
        source="empirical_mvm_torch/csrc/packed_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:383"),
    "packed_window_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/packed_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:411"),
    "fused_window_attention": dict(
        source="empirical_mvm_torch/csrc/packed_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:232"),
    "fused_window_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/packed_window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:259"),
    # row 11: both entries run `_sa_call`'s two pallas_calls (`_sa_kernel`
    # :460, `_sa_bwd_kernel` :483)
    "packed_self_attention": dict(
        source="empirical_mvm_torch/csrc/self_attention_tiled.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:593"),
    "packed_self_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/self_attention_tiled.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:607"),
    "fused_self_attention": dict(
        source="empirical_mvm_torch/csrc/self_attention_tiled.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:593"),
    "fused_self_attention_bwd": dict(
        source="empirical_mvm_torch/csrc/self_attention_tiled.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:607"),
    # row 12: the lanebench tool's `_lane_kernel` (its pallas_call at :80)
    "lane_attention": dict(
        source="empirical_mvm_torch/csrc/lane_window_attention.cu",
        replaces="tools/lanebench.py:38"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, window_ms: float = 20.0) -> float:
    """Mean device time of fn() over back-to-back calls filling about
    ``window_ms`` (5 to 500 calls), after one timed warm-up call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(iters):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    iters = min(500, max(5, int(window_ms / max(run(1), 1e-3))))
    return run(iters)


# ---------------------------------------------------------------------------
# phase 3: one record per (kernel, main-path shape)
# ---------------------------------------------------------------------------

def _excess(diff, ref, atol=0.0, rtol=0.0, scale=0.0):
    """Largest amount by which |diff| exceeds atol + rtol*|ref| + scale*max|ref|."""
    bound = atol + scale * ref.abs().max().item()
    return (diff - bound - rtol * ref.abs()).max().item()


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def bf16_check(kernel, plain, act, kind):
    """Run ``kernel`` on ``act`` rounded to bf16 and hold each output against
    ``plain`` on the same bf16 inputs, run in fp32 and run in bf16, with the
    limits of ``BF16_LIMITS[kind]``. Returns the readings (for a kind with
    one output, ``max_abs_err_bf16``, ``max_abs_err_bf16_same_rounding`` and
    ``mismatch_bf16``; otherwise the same keys per output, ``[name]``
    appended) and the list of limits exceeded, empty when the kernel
    passes."""
    a16 = act.to(torch.bfloat16)
    outs = _tuple(kernel(a16))
    refs32, refs16 = _tuple(plain(a16.float())), _tuple(plain(a16))
    readings, failures = {}, []
    single = len(outs) == 1
    for name, out, r32, r16 in zip(OUTPUTS[kind], outs, refs32, refs16):
        out, r16 = out.float(), r16.float()
        d32, d16 = (out - r32).abs(), (out - r16).abs()
        tag = "" if single else f"[{name}]"
        readings.update({f"max_abs_err_bf16{tag}": d32.max().item(),
                         f"max_abs_err_bf16_same_rounding{tag}": d16.max().item(),
                         f"mismatch_bf16{tag}": (d16 > 0).float().mean().item()})
        vs32, same, mismatch = BF16_LIMITS[kind][name]
        over = _excess(d32, r32, **vs32)
        if over > 0:
            failures.append(f"{name} bf16 vs plain fp32 exceeds {vs32} by {over:.3g}")
        over = _excess(d16, r16, **same)
        if over > 0:
            failures.append(f"{name} bf16 vs plain bf16 exceeds {same} by {over:.3g}")
        if mismatch is not None and readings[f"mismatch_bf16{tag}"] > mismatch:
            failures.append(f"{name} bf16: {readings[f'mismatch_bf16{tag}']:.3g} of the "
                            f"elements differ from plain bf16, above {mismatch}")
        if "scale" in same:
            # how much of the limit's scale term is used: the largest excess
            # over one bf16 step of the element, and the share of elements
            # above that step
            over_step = d16 - BF16_SAME_ROUNDING["atol"] - BF16_SAME_ROUNDING["rtol"] * r16.abs()
            readings.update({f"over_one_step_bf16{tag}": over_step.max().item(),
                             f"share_over_one_step_bf16{tag}": (over_step > 0).float()
                             .mean().item()})
            del over_step
        del d32, d16
    return readings, failures


def fp32_check(kernel, plain, act, kind):
    """Hold each output of ``kernel(act)`` against ``plain(act)`` (fp32) with
    the limits of ``FP32_LIMITS[kind]``. Returns the largest error of each
    output and the list of limits exceeded."""
    errs, failures = {}, []
    for out_name, out, ref in zip(OUTPUTS[kind], _tuple(kernel(act)), _tuple(plain(act))):
        errs[out_name] = (out - ref).abs().max().item()
        over = _excess((out - ref).abs(), ref, **FP32_LIMITS[kind][out_name])
        if over > 0:
            failures.append(f"{out_name} fp32 max err {errs[out_name]} exceeds "
                            f"{FP32_LIMITS[kind][out_name]} by {over:.3g}")
    return errs, failures


def full_check(kernel, plain, act, kind):
    """``fp32_check`` and ``bf16_check`` together: (readings, failures)."""
    errs, failures = fp32_check(kernel, plain, act, kind)
    readings, bf16_failures = bf16_check(kernel, plain, act, kind)
    return {"max_abs_err_fp32": errs, **readings}, failures + bf16_failures


def measure(name, label, act, kernel, plain, library, work_dtype, kind, ops, ops_peak,
            nbytes):
    """Check ``kernel(act)`` against ``plain(act)`` in fp32 and bf16, then
    time kernel, plain and library in ``work_dtype``. ``library(a)`` returns
    a zero-argument callable, its inputs prepared outside the timed call.
    The record's ``failures`` lists the limits exceeded."""
    errs, failures = fp32_check(kernel, plain, act, kind)
    readings, bf16_failures = bf16_check(kernel, plain, act, kind)
    failures += bf16_failures
    a = act.to(work_dtype)
    lib_call = library(a)
    rec = dict(kernel=name, shape=label, dtype=str(work_dtype).replace("torch.", ""),
               max_abs_err=max(errs.values()),
               **({} if len(errs) == 1 else {"max_abs_err_fp32": errs}), **readings,
               ms=time_ms(lambda: kernel(a)), plain_ms=time_ms(lambda: plain(a)),
               library_ms=time_ms(lib_call))
    t_ops = ops / PEAK_OPS_S[ops_peak] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    rec.update(bound_ms=max(t_ops, t_bytes),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               failures=[f"{name} [{label}] {f}" for f in failures])
    del lib_call
    torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    return rec


def _grad_call(out, inputs, grad):
    """Backward of an autograd graph already built: the library yardstick
    of a backward kernel."""
    return lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True)


def _window_bwd_kind(hd, split=False):
    """The limits of a window-attention backward record: those of its bf16
    body (``window_bwd_tc`` for the tensor cores), dq, dk, dv apart when
    ``split``."""
    tc = wa._window_bwd_body(torch.bfloat16, hd) == "tensor_core"
    return ("window_bwd_tc" if tc else "attention_bwd") + ("_qkv" if split else "")


def _window_fwd_kind(hd, n):
    """The limits of a window forward record (rows 3, 7, 9, 10, 12):
    ``window_fwd_tc`` where its bf16 runs the tensor-core body."""
    tc = wa._window_fwd_body(torch.bfloat16, hd, n) == "tensor_core"
    return "window_fwd_tc" if tc else "attention"


def _lane_fwd_kind(hd):
    """The limits of a lane self-attention forward record (row 5): row 11's
    ``sa`` where its bf16 runs row 11's tensor-core forward."""
    return "sa" if wa._sa_body(torch.bfloat16, hd) == "tensor_core" else "attention"


def _bodies(rule, *shape):
    """The body each dtype of a record ran (fp32 in the check against
    plain, bf16 in the bf16 check and the timing), by the C entries' rule
    (``rule(dtype, *shape)``)."""
    return {str(dt)[6:]: rule(dt, *shape) for dt in (torch.float32, torch.bfloat16)}


def _direct_sdpa(a, win, b, nw, nh):
    """q, k, v of SDPA on (B, nW * nH, N, hd) from the 5D x3 map: a clip's
    windows and heads on one axis (4D, which SDPA's fused kernels take)."""
    xw = wa.window_partition(a, win)                            # (B * nW, N, 3C)
    n, hd = xw.shape[1], xw.shape[2] // (3 * nh)
    qkv = xw.reshape(b, nw, n, 3, nh, hd).permute(3, 0, 1, 4, 2, 5)
    return qkv.reshape(3, b, nw * nh, n, hd).contiguous().unbind(0)


def direct_cases(dev, gen, b, t, path, swin=SwinConfig.base(), stages=range(4)):
    """The student's swin stages ``stages`` (of ``swin``'s widths), ``b``
    clips of ``t`` frames at 224^2: the eval at msrvtt-retrieval (32 clips,
    T = 5: the window clamps to (5, 7, 7), N = 245), the train step (20
    clips, T = 4: N = 196) and the violet step's stages 2 and 3 (the C = 96
    swin's C = 384 and 768, the direct kernel's stages there); hd = 32."""
    recs = []
    for stage in stages:
        hw, c, nh = 56 >> stage, swin.embed_dim << stage, swin.num_heads[stage]
        win, shift = get_window_size((t, hw, hw), (8, 7, 7), (4, 3, 3))
        n = win[0] * win[1] * win[2]
        hp = -(-hw // win[1]) * win[1]
        x3 = torch.randn(b, t, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        masks = [None]
        if any(shift):
            masks.append(torch.from_numpy(_shift_attn_mask((t, hp, hp), win, shift)).to(dev))
        scale = (c // nh) ** -0.5
        for mask in masks:
            nw = (hp // win[1]) * (hp // win[2])

            def kernel(a, mask=mask):
                return wa.direct_window_attention(a, bias, mask, win, nh, scale)

            def plain(a, mask=mask):
                return wa.direct_window_attention_plain(a, bias, mask, win, nh, scale)

            def library(a, mask=mask, nw=nw):
                q, k, v = _direct_sdpa(a, win, b, nw, nh)
                m = _window_sdpa_mask(bias, mask, nw, a.dtype)
                return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                              scale=scale)

            label = f"{path} stage{stage} x3=({b},{t},{hp},{hp},{3 * c}) nH={nh} " + (
                "shifted" if mask is not None else "unshifted")
            ops = 4 * b * nw * nh * n * n * (c // nh)
            nbytes = x3.numel() * 2 + b * t * hp * hp * c * 2 + bias.numel() * 4 + (
                0 if mask is None else mask.numel() * 4)
            recs.append(measure("direct_window_attention", label, x3, kernel, plain,
                                library, torch.bfloat16, _window_fwd_kind(c // nh, n), ops,
                                "bf16_tensor", nbytes))
            recs[-1]["body"] = _bodies(wa._window_fwd_body, c // nh, n)
    return recs


def lane_case(dev, gen):
    """Fusion attention of stage 2: CHUNK pairs of 275 tokens (5 x 50 video
    + 25 text), BERT-base heads; padding mask on the text tokens."""
    p, l, d, nh = CHUNK, 275, 768, 12
    x3 = torch.randn(p, l, 3 * d, device=dev, generator=gen) * 0.5
    keep = torch.ones(p, l, device=dev)
    lens = torch.randint(3, 26, (p,), device=dev, generator=gen)
    keep[:, 250:] = (torch.arange(25, device=dev)[None] < lens[:, None]).float()
    bias = (1.0 - keep) * torch.finfo(torch.float32).min
    mask = bias[:, None, :].expand(p, l, l)       # the view BertEncoder passes
    scale = (d // nh) ** -0.5

    def kernel(a):
        return wa.lane_self_attention(a, mask, nh, scale)

    def plain(a):
        return wa.lane_self_attention_plain(a, mask, nh, scale)

    def library(a):
        q, k, v = a.reshape(p, l, 3, nh, d // nh).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        m = bias[:, None, None, :].to(a.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

    ops = 4 * p * nh * l * l * (d // nh)
    nbytes = x3.numel() * 2 + p * l * d * 2 + p * l * 4
    rec = measure("lane_self_attention", f"eval x3=({p},{l},{3 * d}) nH={nh}", x3, kernel,
                  plain, library, torch.bfloat16, _lane_fwd_kind(d // nh), ops, "bf16_tensor",
                  nbytes)
    rec["body"] = _bodies(wa._sa_body, d // nh)
    return [rec]


def _ln_record(rec, kind, calls, x, large, c, work):
    """Complete a LayerNorm record: the body each dtype ran, the bf16 check
    at the ``LARGE_MEAN`` rows ``large``, and the device time of one call of
    the kernel and of the library call under the profiler (``device_ms``,
    ``library_device_ms``: the phase's ``ms`` is host-bound at the small
    sites)."""
    kernel, plain, library = calls
    readings, failures = bf16_check(kernel, plain, large, kind)
    rec["large_mean"] = readings
    rec["failures"] += [f"{rec['kernel']} [{rec['shape']}] large mean: {f}" for f in failures]
    rec["body"] = _bodies(functools.partial(ln._ln_body, backward=kind == "layer_norm_bwd"), c)
    a = x.to(work)
    lib_call = library(a)
    rec["device_ms"] = _device_ms(lambda: kernel(a))
    rec["library_device_ms"] = _device_ms(lib_call)
    del lib_call
    return rec


def _device_ms(fn, calls=20):
    """Device time of one call of ``fn``: its CUDA kernels' time under
    torch.profiler over ``calls`` calls, after one warm-up call."""
    fn()

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    return _kernel_ms(run) / calls


def _ln_inputs(dev, gen, rows, c):
    """x (rows, C) of mean 0.5 and std 2, the same at ``LARGE_MEAN``, gamma,
    beta."""
    x = torch.randn(rows, c, device=dev, generator=gen) * 2.0 + 0.5
    large = torch.randn(rows, c, device=dev, generator=gen) * LARGE_MEAN[1] + LARGE_MEAN[0]
    g = 1.0 + 0.1 * torch.randn(c, device=dev, generator=gen)
    bt = 0.1 * torch.randn(c, device=dev, generator=gen)
    return x, large, g, bt


def _ln_fwd_calls(g, bt, eps, c):
    """(kernel, plain, library) of the LayerNorm forward with gamma, beta."""

    def kernel(a):
        return ln.fused_layer_norm(a, g, bt, eps)

    def plain(a):
        return ln.layer_norm_reference(a, g, bt, eps)

    def library(a):
        gw, bw = g.to(a.dtype), bt.to(a.dtype)
        return lambda: F.layer_norm(a, (c,), gw, bw, eps)

    return kernel, plain, library


def _ln_bwd_calls(g, dy, eps, c):
    """(kernel, plain, library) of the LayerNorm backward with gamma and
    the cotangent dy (bf16 values); dy is cast to each dtype once, outside
    the timed calls."""
    dys = {}

    def kernel(a):
        if a.dtype not in dys:
            dys[a.dtype] = dy.to(a.dtype)
        return ln._ln_bwd(a, g, dys[a.dtype], eps)

    def plain(a):
        return ln.layer_norm_backward_reference(a, g, dy.to(a.dtype), eps)

    def library(a):
        xl = a.detach().requires_grad_(True)
        gw = g.to(a.dtype).requires_grad_(True)
        bw = torch.zeros_like(gw, requires_grad=True)
        y = F.layer_norm(xl, (c,), gw, bw, eps)
        return _grad_call(y, (xl, gw, bw), dy.to(a.dtype))

    return kernel, plain, library


def ln_cases(dev, gen, sites, path):
    """The LayerNorm sites of a path: ``EVAL_LN``, ``TRAIN_LN`` or
    ``TEACHER_LN``; each also at ``LARGE_MEAN``."""
    recs = []
    for label, rows, c, eps, work in sites:
        x, large, g, bt = _ln_inputs(dev, gen, rows, c)
        calls = _ln_fwd_calls(g, bt, eps, c)
        item = torch.finfo(work).bits // 8
        rec = measure("fused_layer_norm", f"{path} {label} rows={rows} C={c} eps={eps}", x,
                      *calls, work, "layer_norm", 8 * rows * c, "fp32",
                      2 * rows * c * item + 2 * c * 4)
        recs.append(_ln_record(rec, "layer_norm", calls, x, large, c, work))
    return recs


def _bf16_values(t):
    """t rounded to bf16 and held in fp32: a cotangent both dtypes share."""
    return t.to(torch.bfloat16).float()


def _direct_bwd_inputs(dev, gen, swin=SwinConfig.base(), stages=range(4), b=TRAIN_B,
                       t=TRAIN_T):
    """The direct backward's inputs at the swin stages ``stages`` (of
    ``swin``'s widths) of the train step: B = 20 clips of T = 4 frames at
    224^2, window (4, 7, 7), N = 196, hd = 32 (the multiple-choice step: 8
    clips of 5 frames, window (5, 7, 7), N = 245); x3, do and bias drawn once
    a stage, for its unshifted and shifted block. Yields (stage, window, nH,
    x3, do, bias, mask or None)."""
    for stage in stages:
        hw, c, nh = 56 >> stage, swin.embed_dim << stage, swin.num_heads[stage]
        win, shift = get_window_size((t, hw, hw), (8, 7, 7), (4, 3, 3))
        n = win[0] * win[1] * win[2]
        hp = -(-hw // win[1]) * win[1]
        x3 = torch.randn(b, t, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, t, hp, hp, c, device=dev, generator=gen))
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        masks = [None]
        if any(shift):
            masks.append(torch.from_numpy(_shift_attn_mask((t, hp, hp), win, shift)).to(dev))
        for mask in masks:
            yield stage, win, nh, x3, do, bias, mask


def direct_bwd_cases(dev, gen, path="", swin=SwinConfig.base(), stages=range(4), b=TRAIN_B,
                     t=TRAIN_T):
    """The direct backward at the train step's swin stages
    (``_direct_bwd_inputs``): every stage of Swin-base, the violet swin's
    stages 2 and 3, or every stage of the multiple-choice step's Swin-base
    (b = 8 clips of t = 5 frames)."""
    recs = []
    for stage, win, nh, x3, do, bias, mask in _direct_bwd_inputs(dev, gen, swin, stages, b, t):
        b, t, hp, _, c3 = x3.shape
        c, n = c3 // 3, bias.shape[-1]
        hd, nw = c // nh, (hp // win[1]) * (hp // win[2])
        scale = hd ** -0.5

        def kernel(a):
            return wa._direct_bwd(a, bias, mask, do.to(a.dtype), win, nh, scale)

        def plain(a):
            return wa.direct_window_attention_backward_plain(a, bias, mask, do.to(a.dtype),
                                                             win, nh, scale)

        def library(a):
            q, k, v = (u.detach().requires_grad_(True)
                       for u in _direct_sdpa(a, win, b, nw, nh))
            m = _window_sdpa_mask(bias, mask, nw, a.dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
            dop = wa.window_partition(do.to(a.dtype), win).reshape(b, nw, n, nh, hd)
            return _grad_call(out, (q, k, v),
                              dop.transpose(2, 3).reshape(b, nw * nh, n, hd).contiguous())

        label = f"{path}stage{stage} x3=({b},{t},{hp},{hp},{3 * c}) nH={nh} " + (
            "shifted" if mask is not None else "unshifted")
        ops = 2.5 * 4 * b * nw * nh * n * n * hd
        nbytes = (2 * x3.numel() + do.numel()) * 2 + 2 * bias.numel() * 4 + (
            0 if mask is None else mask.numel() * 4)
        recs.append(measure("direct_window_attention_bwd", label, x3, kernel, plain,
                            library, torch.bfloat16, _window_bwd_kind(hd), ops,
                            "bf16_tensor", nbytes))
        recs[-1]["body"] = _bodies(wa._window_bwd_body, hd)
    return recs


def lane_train_cases(dev, gen, p=4 * TRAIN_B, l=TRAIN_L, text=32, path=""):
    """The fusion attention of a train step with dropout, forward and
    backward: by default the pretrain step's 20 positive + 60 negative pairs
    of L = 232 tokens (4 x 50 video + 32 text); the retrieval fine-tune's 8 x
    8 pairs of L = 275 (5 x 50 video + 25 text) at ``FINETUNE_LANE``.
    BERT-base heads, p = 0.1, a padding mask on the last ``text`` tokens
    (captions of 6 tokens or more)."""
    d, nh = 768, 12
    hd = d // nh
    x3 = torch.randn(p, l, 3 * d, device=dev, generator=gen) * 0.5
    do = _bf16_values(torch.randn(p, l, d, device=dev, generator=gen))
    mask = _padding_mask(dev, gen, p, l, text, 6)    # the view BertEncoder passes
    seed = torch.tensor([20261016, 7], dtype=torch.int32, device=dev)
    drop_keep = wa.dropout_keep(seed, (p, nh, l, l), P_ATTN)
    frac = drop_keep.float().mean().item()
    sigma = (P_ATTN * (1 - P_ATTN) / drop_keep.numel()) ** 0.5
    del drop_keep
    label = f"{path}x3=({p},{l},{3 * d}) nH={nh} p_drop={P_ATTN}"
    fwd_calls, bwd_calls = _lane_calls(mask, nh, hd ** -0.5, P_ATTN, seed, do)
    ops = 4 * p * nh * l * l * hd
    fwd = measure("lane_self_attention_dropout", label, x3, *fwd_calls, torch.bfloat16,
                  _lane_fwd_kind(hd), ops, "bf16_tensor",
                  x3.numel() * 2 + p * l * d * 2 + p * l * 4)
    fwd.update(keep_fraction=frac, body=_bodies(wa._sa_body, hd))
    if abs(frac - (1 - P_ATTN)) > KEEP_SIGMAS * sigma:
        fwd["failures"].append(f"dropout keep fraction {frac} is not {1 - P_ATTN} "
                               f"+- {KEEP_SIGMAS} sigma ({sigma:.3g})")
    print(json.dumps({"dropout_keep_fraction": frac, "expected": 1 - P_ATTN,
                      "sigma": sigma}), flush=True)
    bwd = measure("lane_self_attention_bwd", label, x3, *bwd_calls, torch.bfloat16,
                  "attention_bwd", 2.5 * ops, "bf16_tensor",
                  (2 * x3.numel() + do.numel()) * 2 + p * l * 4)
    bwd["body"] = _bodies(wa._sa_body, hd)
    return [fwd, bwd]


def _lane_calls(mask, nh, scale, p_drop, seed, do):
    """Row 5 (forward) and row 6 (backward) on x3 (B, L, 3D) under ``mask``
    (B, L, L), their plain versions, and their SDPA yardsticks (``attn_mask``
    the same bias in the work dtype, (B, 1, 1, L) for a padding mask's
    stride-0 view, else (B, 1, L, L); ``dropout_p``; the backward through
    autograd)."""
    def heads(a, grad):
        b, l, c3 = a.shape
        return tuple(u.detach().requires_grad_(grad) for u in a.reshape(
            b, l, 3, nh, c3 // 3 // nh).permute(2, 0, 3, 1, 4).contiguous().unbind(0))

    bias = mask[:, None, :1] if mask.stride(1) == 0 else mask[:, None]

    def sdpa(a, q, k, v):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(a.dtype),
                                              dropout_p=p_drop, scale=scale)

    def fwd_library(a):
        q, k, v = heads(a, False)
        return lambda: sdpa(a, q, k, v)

    def bwd_library(a):
        q, k, v = heads(a, True)
        dop = do.to(a.dtype).reshape(*a.shape[:2], nh, -1).transpose(1, 2).contiguous()
        return _grad_call(sdpa(a, q, k, v), (q, k, v), dop)

    return ((lambda a: wa._lane_fwd(a, mask, nh, scale, p_drop, seed),
             lambda a: wa.lane_self_attention_plain(a, mask, nh, scale, p_drop, seed),
             fwd_library),
            (lambda a: wa._lane_bwd(a, mask, do.to(a.dtype), nh, scale, p_drop, seed),
             lambda a: wa.lane_self_attention_backward_plain(a, mask, do.to(a.dtype), nh, scale,
                                                             p_drop, seed),
             bwd_library))


def _window_shapes(size="base", stages=range(4)):
    """(stage, windows of one clip, C, nH, mask or None, blocks of the shape)
    of a 2D Swin of ``size`` on TRAIN_T frames of 224^2: window (1, 7, 7), n
    = 49, hd = 32; blocks alternate unshifted and shifted, and stage 3
    clamps to one unshifted 7 x 7 window. The mask is the per-frame shift
    mask over all TRAIN_T frames' windows, as BasicLayer builds it."""
    swin = swin2d_config(size)
    for stage in stages:
        depth = swin.depths[stage]
        hw, c, nh = 56 >> stage, swin.embed_dim << stage, swin.num_heads[stage]
        win, shift = get_window_size((TRAIN_T, hw, hw), (1, 7, 7), (0, 3, 3))
        nw = TRAIN_T * (hw // 7) ** 2
        if any(shift):
            yield stage, nw, c, nh, None, (depth + 1) // 2
            yield stage, nw, c, nh, _shift_attn_mask((TRAIN_T, hw, hw), win, shift), depth // 2
        else:
            yield stage, nw, c, nh, None, depth


def _window_sdpa_mask(bias, mk, nw, dtype):
    """bias + mask as a (1, nW * nH, N, N) ``attn_mask`` that broadcasts
    over the clips, for SDPA on (clips, nW * nH, N, hd)."""
    nh, n, _ = bias.shape
    m = bias[None] if mk is None else bias[None] + mk[:, None]
    return m.expand(nw, nh, n, n).reshape(1, nw * nh, n, n).to(dtype)


def lane_window_cases(dev, gen, size="base", stages=range(4), path="2d swin"):
    """The 2D swin's window attention (the frozen teacher of the 2d_feature
    step; the student of the swin2d step; with ``size`` "tiny", stages 2-3
    of the swin2d-tiny step, whose stages 0-1 take row 9): 20 clips of 4
    frames at 224^2, window (1, 7, 7) (n = 49, hd = 32: each frame's windows
    on their own), at each stage, unshifted and shifted with the 4-frame
    mask (``_window_shapes``). SDPA, the yardstick, runs on (clips, nW * nH, 49,
    32), a clip's windows and heads on one axis, with the broadcast
    ``_window_sdpa_mask``. Each record carries its shape's launches in one
    step's 24 blocks (``launches_per_step``) and the body each dtype ran; its
    bf16 is held to the limits of that body (``_window_fwd_kind``)."""
    b, n, hd = TRAIN_B, 49, 32
    recs = []
    for stage, nw, c, nh, mk, blocks in _window_shapes(size, stages):
        x3 = torch.randn(b * nw, n, 3 * c, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mk = None if mk is None else torch.from_numpy(mk).to(dev)
        n_w = nw if mk is not None else 1
        scale = hd ** -0.5

        def kernel(a, bias=bias, mk=mk, n_w=n_w, nh=nh):
            return wa.lane_window_attention(a, bias, mk, n_w, nh, scale)

        def plain(a, bias=bias, mk=mk, n_w=n_w, nh=nh):
            return wa.lane_window_attention_reference(a, bias, mk, n_w, nh, scale)

        def library(a, bias=bias, mk=mk, nh=nh, nw=nw):
            qkv = a.reshape(b, nw, n, 3, nh, hd).permute(3, 0, 1, 4, 2, 5)
            q, k, v = qkv.reshape(3, b, nw * nh, n, hd).unbind(0)
            m = _window_sdpa_mask(bias, mk, nw, a.dtype)
            return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

        label = f"{path} stage{stage} x3=({b * nw},{n},{3 * c}) nH={nh} " + (
            "unshifted" if mk is None else f"shifted nW={n_w}")
        ops = 4 * b * nw * nh * n * n * hd
        nbytes = x3.numel() * 2 + b * nw * n * c * 2 + bias.numel() * 4 + (
            0 if mk is None else mk.numel() * 4)
        recs.append(measure("lane_window_attention", label, x3, kernel, plain, library,
                            torch.bfloat16, _window_fwd_kind(hd, n), ops, "bf16_tensor",
                            nbytes))
        recs[-1].update(launches_per_step=blocks, body=_bodies(wa._window_fwd_body, hd, n))
    return recs


def _window_bwd_inputs(dev, gen, size="base", stages=range(4)):
    """The lane window backward's inputs at ``_window_shapes``: x3, do and
    bias drawn once a shape. Yields (stage, nW of one clip, nH, x3, do,
    bias, mask or None, blocks of the shape)."""
    b, n = TRAIN_B, 49
    for stage, nw, c, nh, mk, blocks in _window_shapes(size, stages):
        x3 = torch.randn(b * nw, n, 3 * c, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b * nw, n, c, device=dev, generator=gen))
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        yield stage, nw, nh, x3, do, bias, None if mk is None else torch.from_numpy(mk).to(dev), \
            blocks


def lane_window_bwd_cases(dev, gen, size="base", stages=range(4), path="2d swin"):
    """The trained 2D swin's window attention backward in the swin2d step
    (and the swin2d-tiny step's stages 2-3): the shapes of
    ``lane_window_cases`` (``_window_bwd_inputs``). SDPA's backward, the
    yardstick, runs on the layout and broadcast mask of the forward's
    yardstick."""
    recs = []
    for stage, nw, nh, x3, do, bias, mk, blocks in _window_bwd_inputs(dev, gen, size, stages):
        b, n, hd = TRAIN_B, 49, 32
        c = x3.shape[-1] // 3
        n_w = nw if mk is not None else 1
        scale = hd ** -0.5

        def kernel(a):
            return wa._lane_window_bwd(a, bias, mk, do.to(a.dtype), n_w, nh, scale)

        def plain(a):
            return wa.lane_window_attention_backward_plain(a, bias, mk, do.to(a.dtype), n_w,
                                                           nh, scale)

        def library(a):
            qkv = a.reshape(b, nw, n, 3, nh, hd).permute(3, 0, 1, 4, 2, 5)
            q, k, v = (u.detach().requires_grad_(True) for u in
                       qkv.reshape(3, b, nw * nh, n, hd).contiguous().unbind(0))
            m = _window_sdpa_mask(bias, mk, nw, a.dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
            dop = do.to(a.dtype).reshape(b, nw, n, nh, hd).permute(0, 1, 3, 2, 4)
            return _grad_call(out, (q, k, v), dop.reshape(b, nw * nh, n, hd).contiguous())

        label = f"{path} stage{stage} x3=({b * nw},{n},{3 * c}) nH={nh} " + (
            "unshifted" if mk is None else f"shifted nW={n_w}")
        ops = 2.5 * 4 * b * nw * nh * n * n * hd
        nbytes = (2 * x3.numel() + do.numel()) * 2 + 2 * bias.numel() * 4 + (
            0 if mk is None else mk.numel() * 4)
        recs.append(measure("lane_window_attention_bwd", label, x3, kernel, plain, library,
                            torch.bfloat16, _window_bwd_kind(hd), ops, "bf16_tensor", nbytes))
        recs[-1].update(launches_per_step=blocks, body=_bodies(wa._window_bwd_body, hd))
    return recs


def _packed_shapes():
    """(label, windows of one clip, C, nH, N, mask or None, launches in one
    violet step) of ``packed_window_attention``: stages 0 and 1 of the C =
    96 Video Swin (``swin_violet.py``) on TRAIN_T frames of 224^2, window
    clamped to (4, 7, 7) (N = 196, hd = 32), each stage one unshifted and one
    shifted block; and stages 0 and 1 of the 2D Swin-tiny (C = 96, 192) on
    the same clips, window (1, 7, 7) (N = 49) with the 4-frame mask, one
    unshifted and one shifted block each in the swin2d-tiny step (phase
    45)."""
    violet = SwinConfig.violet()
    for stage in (0, 1):
        hw, c, nh = 56 >> stage, violet.embed_dim << stage, violet.num_heads[stage]
        win, shift = get_window_size((TRAIN_T, hw, hw), violet.window_size, (4, 3, 3))
        nw, n = (hw // 7) ** 2, win[0] * win[1] * win[2]
        yield f"violet stage{stage}", nw, c, nh, n, None, 1
        yield f"violet stage{stage}", nw, c, nh, n, _shift_attn_mask((TRAIN_T, hw, hw), win,
                                                                     shift), 1
    tiny = swin2d_config("tiny")
    for stage in (0, 1):
        hw, c, nh = 56 >> stage, tiny.embed_dim << stage, tiny.num_heads[stage]
        win, shift = get_window_size((TRAIN_T, hw, hw), (1, 7, 7), (0, 3, 3))
        for mk in (None, _shift_attn_mask((TRAIN_T, hw, hw), win, shift)):
            yield f"2d swin-tiny stage{stage}", TRAIN_T * (hw // 7) ** 2, c, nh, 49, mk, 1


def _packed_sdpa(a, b, nw, nh, n, hd):
    """q, k, v of SDPA on (clips, nW * nH, N, hd) from packed (B_, 3nH, N,
    hd): a clip's windows and heads on one axis."""
    return a.reshape(b, nw, 3, nh, n, hd).transpose(1, 2).reshape(b, 3, nw * nh, n, hd).unbind(1)


def packed_cases(dev, gen):
    """``packed_window_attention`` forward and backward at ``_packed_shapes``,
    and ``fused_window_attention`` (q, k, v as three arrays: the same kernel
    on three base pointers) forward and backward at the violet stage-0
    shifted shape. SDPA, the yardstick, runs on (clips, nW * nH, N, hd) with
    the broadcast ``_window_sdpa_mask``, its backward through autograd. Each
    record carries its shape's launches in one violet or swin2d-tiny step
    (``launches_per_step``)."""
    b, hd = TRAIN_B, 32
    recs = []
    for label, nw, c, nh, n, mk, blocks in _packed_shapes():
        b_ = b * nw
        qkv = torch.randn(b_, 3 * nh, n, hd, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b_, nh, n, hd, device=dev, generator=gen))
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mk = None if mk is None else torch.from_numpy(mk).to(dev)
        n_w = nw if mk is not None else 1
        scale = hd ** -0.5
        label = f"{label} qkv=({b_},{3 * nh},{n},{hd}) " + (
            "unshifted" if mk is None else f"shifted nW={n_w}")

        def fwd_kernel(a, bias=bias, mk=mk, n_w=n_w, nh=nh):
            return wa.packed_window_attention(a, bias, mk, n_w, nh, scale)

        def fwd_plain(a, bias=bias, mk=mk, n_w=n_w, nh=nh):
            return wa.packed_window_attention_plain(a, bias, mk, n_w, nh, scale)

        def fwd_library(a, bias=bias, mk=mk, nh=nh, nw=nw, n=n):
            q, k, v = _packed_sdpa(a, b, nw, nh, n, hd)
            m = _window_sdpa_mask(bias, mk, nw, a.dtype)
            return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

        def bwd_kernel(a, bias=bias, mk=mk, n_w=n_w, nh=nh, do=do):
            return wa._packed_bwd(a, bias, mk, do.to(a.dtype), n_w, nh, scale)

        def bwd_plain(a, bias=bias, mk=mk, n_w=n_w, nh=nh, do=do):
            return wa.packed_window_attention_backward_plain(a, bias, mk, do.to(a.dtype), n_w,
                                                             nh, scale)

        def bwd_library(a, bias=bias, mk=mk, nh=nh, nw=nw, n=n, do=do):
            q, k, v = (u.detach().contiguous().requires_grad_(True)
                       for u in _packed_sdpa(a, b, nw, nh, n, hd))
            m = _window_sdpa_mask(bias, mk, nw, a.dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
            dop = do.to(a.dtype).reshape(b, nw * nh, n, hd)
            return _grad_call(out, (q, k, v), dop)

        ops = 4 * b_ * nh * n * n * hd
        extra = bias.numel() * 4 + (0 if mk is None else mk.numel() * 4)
        fwd = measure("packed_window_attention", label, qkv, fwd_kernel, fwd_plain,
                      fwd_library, torch.bfloat16, _window_fwd_kind(hd, n), ops,
                      "bf16_tensor", (qkv.numel() + do.numel()) * 2 + extra)
        fwd["body"] = _bodies(wa._window_fwd_body, hd, n)
        bwd = measure("packed_window_attention_bwd", label, qkv, bwd_kernel, bwd_plain,
                      bwd_library, torch.bfloat16, _window_bwd_kind(hd), 2.5 * ops,
                      "bf16_tensor", (2 * qkv.numel() + do.numel()) * 2 + extra
                      + bias.numel() * 4)
        bwd["body"] = _bodies(wa._window_bwd_body, hd)
        fwd["launches_per_step"] = bwd["launches_per_step"] = blocks
        recs += [fwd, bwd]
        if label.startswith("violet stage0") and mk is not None:
            recs += fused_cases(qkv, do, bias, mk, nw, nh, label)
    return recs


def fused_cases(qkv, do, bias, mk, nw, nh, label):
    """``fused_window_attention`` and its backward on q, k, v (B_, nH, N,
    hd) held apart (a (3, B_, nH, N, hd) stack unbound) from ``qkv``'s
    values."""
    b_, _, n, hd = qkv.shape
    stack = qkv.reshape(b_, 3, nh, n, hd).transpose(0, 1).contiguous()
    scale = hd ** -0.5

    def fwd_kernel(a):
        return wa.fused_window_attention(*a.unbind(0), bias, mk, nw, scale)

    def fwd_plain(a):
        return wa.fused_window_attention_plain(*a.unbind(0), bias, mk, nw, scale)

    def fwd_library(a):
        q, k, v = (u.reshape(b_ // nw, nw * nh, n, hd) for u in a.unbind(0))
        m = _window_sdpa_mask(bias, mk, nw, a.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

    def bwd_kernel(a):
        return wa._fused_bwd(*a.unbind(0), bias, mk, do.to(a.dtype), nw, scale)

    def bwd_plain(a):
        return wa.fused_window_attention_backward_plain(*a.unbind(0), bias, mk, do.to(a.dtype),
                                                        nw, scale)

    def bwd_library(a):
        q, k, v = (u.reshape(b_ // nw, nw * nh, n, hd).detach().requires_grad_(True)
                   for u in a.unbind(0))
        m = _window_sdpa_mask(bias, mk, nw, a.dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
        return _grad_call(out, (q, k, v), do.to(a.dtype).reshape(b_ // nw, nw * nh, n, hd))

    ops = 4 * b_ * nh * n * n * hd
    extra = bias.numel() * 4 + mk.numel() * 4
    label = label.replace("qkv=", "q,k,v=3x").replace(f",{3 * nh},", f",{nh},")
    fwd = measure("fused_window_attention", label, stack, fwd_kernel, fwd_plain, fwd_library,
                  torch.bfloat16, _window_fwd_kind(hd, n), ops, "bf16_tensor",
                  (stack.numel() + do.numel()) * 2 + extra)
    fwd["body"] = _bodies(wa._window_fwd_body, hd, n)
    bwd = measure("fused_window_attention_bwd", label, stack, bwd_kernel, bwd_plain,
                  bwd_library, torch.bfloat16, _window_bwd_kind(hd, split=True), 2.5 * ops,
                  "bf16_tensor", (2 * stack.numel() + do.numel()) * 2 + extra
                  + bias.numel() * 4)
    bwd["body"] = _bodies(wa._window_bwd_body, hd)
    return [fwd, bwd]


def teacher_lane_case(dev, gen, teacher, l, d, nh):
    """Row 5 at a frozen ViT teacher's shape: 80 frames of L tokens, p = 0,
    the zero mask ``vit_self_attention`` passes (a (1, 1, L) row expanded):
    the 2d_clip step's CLIP (L = 50: the class token and 7 x 7 patches;
    ViT-B/32's 12 heads of 64) and the depth step's DPT-Large (L = 197: 14 x
    14 patches; 16 heads of 64). SDPA without a mask (the same function) is
    the yardstick."""
    p = TRAIN_B * TRAIN_T
    x3 = torch.randn(p, l, 3 * d, device=dev, generator=gen) * 0.5
    mask = torch.zeros(1, 1, l, device=dev).expand(p, l, l)
    scale = (d // nh) ** -0.5

    def kernel(a):
        return wa.lane_self_attention(a, mask, nh, scale)

    def plain(a):
        return wa.lane_self_attention_plain(a, mask, nh, scale)

    def library(a):
        q, k, v = a.reshape(p, l, 3, nh, d // nh).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)

    ops = 4 * p * nh * l * l * (d // nh)
    nbytes = x3.numel() * 2 + p * l * d * 2 + _span_bytes(mask)
    rec = measure("lane_self_attention", f"{teacher} teacher x3=({p},{l},{3 * d}) nH={nh}", x3,
                  kernel, plain, library, torch.bfloat16, _lane_fwd_kind(d // nh), ops,
                  "bf16_tensor", nbytes)
    rec["body"] = _bodies(wa._sa_body, d // nh)
    return [rec]


def merlot_lane_cases(dev, gen):
    """Rows 5 and 6 at the MERLOT encoder's trained ViT (phase 47): 80 frames
    of 50 tokens, ViT-base's 12 heads of 64, p = 0, the zero mask that
    ``vit_self_attention`` passes (a (1, 1, L) row expanded); SDPA with
    that mask, forward and backward, the yardstick."""
    p, l, d, nh = TRAIN_B * TRAIN_T, 50, 768, 12
    hd = d // nh
    x3 = torch.randn(p, l, 3 * d, device=dev, generator=gen) * 0.5
    do = _bf16_values(torch.randn(p, l, d, device=dev, generator=gen))
    mask = torch.zeros(1, 1, l, device=dev).expand(p, l, l)
    seed = torch.zeros(2, dtype=torch.int32, device=dev)
    fwd_calls, bwd_calls = _lane_calls(mask, nh, hd ** -0.5, 0.0, seed, do)
    label = f"merlot vit x3=({p},{l},{3 * d}) nH={nh}"
    ops = 4 * p * nh * l * l * hd
    fwd = measure("lane_self_attention", label, x3, *fwd_calls, torch.bfloat16,
                  _lane_fwd_kind(hd), ops, "bf16_tensor",
                  x3.numel() * 2 + p * l * d * 2 + _span_bytes(mask))
    bwd = measure("lane_self_attention_bwd", label, x3, *bwd_calls, torch.bfloat16,
                  "attention_bwd", 2.5 * ops, "bf16_tensor",
                  (2 * x3.numel() + do.numel()) * 2 + _span_bytes(mask))
    for rec in (fwd, bwd):
        rec["body"] = _bodies(wa._sa_body, hd)
    return [fwd, bwd]


def _shift_like_mask(dev, gen, nw, n):
    """(nW, N, N) of 0 or -100 with the structure of a swin shift mask: the
    tokens of each window in up to 4 seeded regions, a pair of tokens in two
    regions masked."""
    region = torch.randint(0, 4, (nw, n), device=dev, generator=gen)
    return torch.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)


def _lane_attention_record(label, x3, bias, mask, nh):
    """Row 12 (``lane_attention``) on (B_, N, 3C) ``x3`` against its plain
    version and SDPA (4D: (B_ / nW, nW * nH, N, hd) with the broadcast
    ``_window_sdpa_mask``), and row 7 (``lane_window_attention``, the scale
    on q) timed on the same bf16 x3, bias and mask (``lane_window_ms``). The
    bf16 limits are those of the body bf16 ran (``_window_fwd_kind``), named
    in the record's ``body``."""
    b_, n, c3 = x3.shape
    c = c3 // 3
    hd, nw = c // nh, mask.shape[0]
    scale = hd ** -0.5

    def kernel(a):
        return wa.lane_attention(a, bias, mask, nh, scale)

    def plain(a):
        return wa.lane_attention_reference(a, bias, mask, nh, scale)

    def library(a):
        qkv = a.reshape(b_ // nw, nw, n, 3, nh, hd).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv.reshape(3, b_ // nw, nw * nh, n, hd).contiguous().unbind(0)
        m = _window_sdpa_mask(bias, mask, nw, a.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

    ops = 4 * b_ * n * n * c
    nbytes = x3.numel() * 2 + b_ * n * c * 2 + bias.numel() * 4 + mask.numel() * 4
    rec = measure("lane_attention", label, x3, kernel, plain, library, torch.bfloat16,
                  _window_fwd_kind(hd, n), ops, "bf16_tensor", nbytes)
    rec["body"] = _bodies(wa._window_fwd_body, hd, n)
    a16 = x3.to(torch.bfloat16)
    rec["lane_window_ms"] = time_ms(
        lambda: wa.lane_window_attention(a16, bias, mask, nw, nh, scale))
    return rec


def lane_attention_cases(dev, gen):
    """Row 12, the lanebench tool's kernel, at the tool's three Swin-base
    stage shapes (``lanebench.SHAPES``: N = 196, hd = 32) in bf16, with the
    tool's zero mask (its path: the kernels line sums these) and a seeded
    shift-like mask (``_shift_like_mask``, marked ``off_path``); each record
    with row 7's time on the same inputs (``_lane_attention_record``)."""
    recs = []
    for stage, sh in lanebench.SHAPES.items():
        b_, n, c, nh, nw = (sh[k] for k in ("b_", "n", "c", "nh", "nw"))
        x3 = torch.randn(b_, n, 3 * c, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.1
        masks = {"zero mask": torch.zeros(nw, n, n, device=dev),
                 "shift-like mask": _shift_like_mask(dev, gen, nw, n)}
        for name, mask in masks.items():
            rec = _lane_attention_record(f"lanebench stage{stage} x3=({b_},{n},{3 * c}) "
                                         f"nH={nh} nW={nw} {name}", x3, bias, mask, nh)
            rec["off_path"] = name != "zero mask"
            recs.append(rec)
    return recs


def c128_cases(dev, gen):
    """What the C % 128 rule costs (``off_path``): at the C = 96 Video
    Swin's stages 0 and 1 of the violet step (20 clips of 4 frames, window
    (4, 7, 7): N = 196, hd = 32, the shifted block), row 12 and row 7 on the
    partitioned windows (B_, N, 3C) against the route ``WindowAttention3D``
    takes there, ``_to_packed`` + row 9 + ``_from_packed`` on the (B, D, H,
    W, 3C) map of the same values (``packed_route_ms``; the largest
    difference of its output from row 7's, the same function with the same
    roundings, beside it)."""
    violet = SwinConfig.violet()
    recs = []
    for stage in (0, 1):
        hw, c, nh = 56 >> stage, violet.embed_dim << stage, violet.num_heads[stage]
        win, shift = get_window_size((TRAIN_T, hw, hw), violet.window_size, (4, 3, 3))
        n, nw = win[0] * win[1] * win[2], (hw // win[1]) * (hw // win[2])
        scale = (c // nh) ** -0.5
        x5 = torch.randn(TRAIN_B, TRAIN_T, hw, hw, 3 * c, device=dev, generator=gen) * 0.5
        xw = wa.window_partition(x5, win).contiguous()
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mask = torch.from_numpy(_shift_attn_mask((TRAIN_T, hw, hw), win, shift)).to(dev)
        rec = _lane_attention_record(
            f"C % 128 cost: violet stage{stage} x3=({xw.shape[0]},{n},{3 * c}) nH={nh} "
            f"shifted nW={nw}", xw, bias, mask, nh)
        x16 = x5.to(torch.bfloat16)

        def packed_route(x16=x16, win=win, nh=nh, bias=bias, mask=mask, nw=nw, scale=scale,
                         hw=hw):
            out = wa.packed_window_attention(_to_packed(x16, win, nh), bias, mask, nw, nh,
                                             scale)
            return _from_packed(out, win, TRAIN_B, TRAIN_T, hw, hw)

        lane_window = wa.lane_window_attention(xw.to(torch.bfloat16), bias, mask, nw, nh, scale)
        rec.update(packed_route_ms=time_ms(packed_route), off_path=True,
                   packed_route_vs_lane_window_max_abs=(
                       wa.window_partition(packed_route(), win) - lane_window).abs().max()
                   .float().item())
        print(json.dumps({"c128_cost": {k: rec[k] for k in (
            "shape", "ms", "lane_window_ms", "packed_route_ms",
            "packed_route_vs_lane_window_max_abs")}}), flush=True)
        recs.append(rec)
        del x5, xw, x16, lane_window
    return recs


# Faults planted in copies of csrc/ for phase 3 (file, correct texts,
# planted texts), each a rounding point or term of the JAX kernels that a
# tensor-core body could move (its roundings of p and ds are structural: an
# mma operand is bf16). Row 11's body, forward: the normalisation moved after
# P.V, so the unnormalised p is rounded; row 5 runs the same forward and must
# fail too. Backward: dk from q as stored, the scale applied to the fp32
# product, so q * scale is not rounded before dk (a fault only where the scale
# is inexact in bf16: hd 32, not 64, whose scale 0.125 is a power of two).
# The window backward's body: ds rounded to bf16 before it enters dbias (the
# JAX kernels sum the fp32 ds). Row 6 on row 11's backward: the keep mask
# dropped from dp in the rows kernel (D, ds and dq of every dropped score).
# The window forward's body (rows 3, 7, 9, 10, 12): e = exp(s - max) rounded
# to bf16 before it is normalised (and p rounded again). The first two are planted in
# one copy, the last three in another (the keep-mask fault would also fail
# row 11's backward check, whose own fault it must not hide; each of the
# others moves only its own kernels).
PLANTED_TILED = {
    "forward p rounded before normalising": (
        "self_attention_mma.cuh",
        ("div_rn(expf(__fsub_rn(sc[nt][e], mx[e >> 1])), sum[e >> 1], rcp[e >> 1]);",
         "pack(o[dt][2 * r], o[dt][2 * r + 1]);"),
        ("expf(__fsub_rn(sc[nt][e], mx[e >> 1]));",
         "pack(o[dt][2 * r] / sum[r], o[dt][2 * r + 1] / sum[r]);")),
    "backward q * scale not rounded before dk": (
        "self_attention_mma.cuh",
        ("product_nn<HD, G::kColDTiles>(ak, sa, qs,", "pack(ak[dt][2 * r], ak[dt][2 * r + 1])"),
        ("product_nn<HD, G::kColDTiles>(ak, sa, qb,",
         "pack(ak[dt][2 * r] * scale_t, ak[dt][2 * r + 1] * scale_t)")),
    "window backward ds rounded before dbias": (
        "attention_bwd_mma.cuh",
        "part[size_t(rows[r]) * n + j] = first_window ? ds : __fadd_rn(old[nt][e], ds);",
        "ds = __bfloat162float(__float2bfloat16(ds));\n"
        "part[size_t(rows[r]) * n + j] = first_window ? ds : __fadd_rn(old[nt][e], ds);"),
    "lane backward keep mask dropped from dp in the rows kernel": (
        "self_attention_mma.cuh",
        "const float d = drop.on ? drop_scale(keep[r][e & 1], dp[nt][e], drop.inv_keep)\n"
        "                                  : dp[nt][e];",
        "const float d = dp[nt][e];"),
    "window forward e rounded before normalising": (
        "attention_fwd_mma.cuh",
        "const float p = sa_mma::div_rn(sv[u], sum, rcp);",
        "const float p = __fdiv_rn(__bfloat162float(__float2bfloat16(sv[u])), sum);"),
}
# the faults of each planted copy of csrc/
PLANTED_COPIES = (tuple(PLANTED_TILED)[:2], tuple(PLANTED_TILED)[2:])
# Faults planted in the LayerNorm's vectorized body (csrc/layer_norm.cu),
# each a term of the JAX numerics: the one-pass variance E[x^2] - mean^2
# (held at the LARGE_MEAN rows), the m2 term dropped from dx, and the first
# partial row left out of dgamma and dbeta (the fixed-order sum of the
# partials, which both bodies share). Each is planted in a copy of its own
# that holds layer_norm.cu and its header alone, and builds in seconds.
PLANTED_LN = {
    "one-pass variance": (
        "layer_norm.cu",
        ("const float d = Vec::get(xv[v], e) - mean;", "rsqrtf(group_sum<G>(q) / C + eps)"),
        ("const float d = Vec::get(xv[v], e);",
         "rsqrtf(group_sum<G>(q) / C - mean * mean + eps)")),
    "m2 dropped from dx": (
        "layer_norm.cu", "o[e] = rstd * (gy * ga[u] - m1 - xhat * m2);",
        "o[e] = rstd * (gy * ga[u] - m1);"),
    "first partial left out of dgamma and dbeta": (
        "layer_norm.cu", "for (int b = b0; b < b1; ++b) s += part[size_t(b) * c2 + k];",
        "for (int b = b0 + (warp == 0); b < b1; ++b) s += part[size_t(b) * c2 + k];"),
}
LN_SOURCES = ("common.cuh", "layer_norm.cu")


def plant(src: Path, name: str, good, bad) -> None:
    """Replace, in the csrc copy ``src``, each text of ``good`` (one string
    or a tuple) in file ``name`` with the same item of ``bad``; each must
    occur there exactly once."""
    text = (src / name).read_text()
    for g, b in zip(_tuple(good), _tuple(bad)):
        require(text.count(g) == 1, f"planted fault: {g!r} is not in {name} once")
        text = text.replace(g, b)
    (src / name).write_text(text)


def _span_bytes(t):
    """The bytes of storage that a view spans: a broadcast axis (stride 0),
    such as the padding mask's query axis, reads no more."""
    return (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))) * t.element_size()


def _padding_mask(dev, gen, b, n, text, shortest):
    """The (B, N, N) view of a (B, 1, N) padding bias that BertEncoder
    passes: the last ``text`` keys are a caption of ``shortest`` to ``text``
    tokens, zero-padded."""
    keep = torch.ones(b, n, device=dev)
    lens = torch.randint(shortest, text + 1, (b,), device=dev, generator=gen)
    keep[:, n - text:] = (torch.arange(text, device=dev)[None] < lens[:, None]).float()
    return ((1.0 - keep) * torch.finfo(torch.float32).min)[:, None, :].expand(b, n, n)


def _sa_calls(mask, nh, scale, p_drop, seed, do):
    """The tiled kernel's forward and backward on qkv, its plain versions,
    and their SDPA yardsticks (``attn_mask`` = mask[:, None]); the backward
    kernel runs from the forward's stats, computed once per dtype outside
    the timed calls."""
    stats = {}

    def fwd(a):
        return wa._packed_sa_fwd(a, mask, nh, scale, p_drop, seed)[0]

    def bwd(a):
        if a.dtype not in stats:
            stats[a.dtype] = wa._packed_sa_fwd(a, mask, nh, scale, p_drop, seed)[1]
        return wa._packed_sa_bwd(a, mask, do.to(a.dtype), stats[a.dtype], nh, scale, p_drop,
                                 seed)

    def fwd_plain(a):
        return wa.packed_self_attention_plain(a, mask, nh, scale, p_drop, seed)

    def bwd_plain(a):
        return wa.packed_self_attention_backward_plain(a, mask, do.to(a.dtype), nh, scale,
                                                       p_drop, seed)

    def sdpa(a, grad):
        q, k, v = (u.detach().contiguous().requires_grad_(grad) for u in a.chunk(3, dim=1))
        m = mask[:, None].to(a.dtype)
        return q, k, v, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                               dropout_p=p_drop, scale=scale)

    def fwd_library(a):
        return sdpa(a, False)[-1]

    def bwd_library(a):
        q, k, v, call = sdpa(a, True)
        return _grad_call(call(), (q, k, v), do.to(a.dtype))

    return (fwd, fwd_plain, fwd_library), (bwd, bwd_plain, bwd_library)


def tiled_sa_cases(dev, gen):
    """Row 11, the tiled self-attention (``packed_self_attention`` and its
    backward; ``fused_self_attention``, the same kernel on q, k, v apart):
    (a) the multiple-choice fusion, 40 rows of 350 tokens (250 video + a
    question and option of 8 to 100 tokens), 12 heads of 64: forward at p = 0
    (the eval) and p = 0.1 (the fine-tune step), backward at p = 0.1, and the
    dropout keep fraction; the same at the generative multiple choice's 8
    rows of 350 (tgif-action, one row a question), and the loader-fed one's 8
    rows of 353 (phase 38), backward and forward at p = 0.1; (b) DPT-Large at 384^2,
    8 images of 577 tokens, 16 heads, no mask, forward in fp32 (which row
    5's shared memory cannot hold) and bf16, backward in bf16; (c) the
    split entry at (a)'s shape with dropout; (d) N = 129, one key of the
    last tile. (b)-(d) are on no path of
    this script (``off_path``). SDPA with ``attn_mask`` = mask[:, None] (and
    ``dropout_p``) is the yardstick."""
    recs = []
    shapes = (("mc fusion", QAMC_B * QAMC_O, 12, QAMC_L, 100, (0.0, P_ATTN)),
              ("qamc-gen fusion", QAMC_B, 12, QAMC_L, 100, (0.0, P_ATTN)),
              ("tgif-action loader fusion", QAMC_B, 12, 353, 103, (P_ATTN,)),
              ("dpt 384", 8, 16, 577, 0, (0.0,)),
              ("ragged", 16, 12, 129, 32, (P_ATTN,)))
    for label, b, nh, n, text, rates in shapes:
        hd = 64
        qkv = torch.randn(b, 3 * nh, n, hd, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, nh, n, hd, device=dev, generator=gen))
        mask = (_padding_mask(dev, gen, b, n, text, 8) if text
                else torch.zeros(b, n, n, device=dev))
        scale = hd ** -0.5
        seed = torch.tensor([20261016, 11], dtype=torch.int32, device=dev)
        ops = 4 * b * nh * n * n * hd
        mask_bytes = _span_bytes(mask)
        on_path = label not in ("dpt 384", "ragged")
        mine = []
        for p_drop in rates:
            (fwd, *fwd_rest), (bwd, *bwd_rest) = _sa_calls(mask, nh, scale, p_drop,
                                                           seed if p_drop else None, do)
            name = f"{label} qkv=({b},{3 * nh},{n},{hd}) p_drop={p_drop}"
            works = (torch.float32, torch.bfloat16) if label == "dpt 384" else (torch.bfloat16,)
            for work in works:
                item = torch.finfo(work).bits // 8
                mine.append(measure(
                    "packed_self_attention", f"{name} {str(work)[6:]}", qkv, fwd, *fwd_rest,
                    work, "sa", ops, "bf16_tensor" if item == 2 else "fp32",
                    (qkv.numel() + do.numel()) * item + mask_bytes))
            if on_path and p_drop:
                keep = wa.dropout_keep(seed, (b, nh, n, n), p_drop)
                frac = keep.float().mean().item()
                sigma = (p_drop * (1 - p_drop) / keep.numel()) ** 0.5
                del keep
                mine[-1]["keep_fraction"] = frac
                if abs(frac - (1 - p_drop)) > KEEP_SIGMAS * sigma:
                    mine[-1]["failures"].append(f"dropout keep fraction {frac} is not "
                                                f"{1 - p_drop} +- {KEEP_SIGMAS} sigma")
            if p_drop or not on_path:
                mine.append(measure("packed_self_attention_bwd", name, qkv, bwd, *bwd_rest,
                                    torch.bfloat16, "sa_bwd", 2.5 * ops, "bf16_tensor",
                                    (2 * qkv.numel() + do.numel()) * 2 + mask_bytes))
            if label == "mc fusion" and p_drop:
                mine += split_sa_cases(qkv, do, mask, nh, p_drop, seed, name)
        for rec in mine:
            rec.setdefault("off_path", not on_path)
            dtype = getattr(torch, rec["dtype"])
            rec["body"] = _bodies(wa._sa_body, hd)
            rec["smem_bytes"] = _build.library().emvm_tiled_self_attention_smem_bytes(
                _build.dtype_code(dtype), hd, int(rec["kernel"].endswith("_bwd")))
        recs += mine
    recs[0]["failures"] += planted_tiled_check(dev, gen)
    return recs


def split_sa_cases(qkv, do, mask, nh, p_drop, seed, label):
    """``fused_self_attention`` and its backward on q, k, v (B, nH, N, hd)
    held apart (a (3, B, nH, N, hd) stack unbound) from ``qkv``'s values."""
    b, _, n, hd = qkv.shape
    stack = qkv.reshape(b, 3, nh, n, hd).transpose(0, 1).contiguous()
    scale = hd ** -0.5
    stats = {}

    def fwd(a):
        return wa._fused_sa_fwd(*a.unbind(0), mask, scale, p_drop, seed)[0]

    def bwd(a):
        if a.dtype not in stats:
            stats[a.dtype] = wa._fused_sa_fwd(*a.unbind(0), mask, scale, p_drop, seed)[1]
        return wa._fused_sa_bwd(*a.unbind(0), mask, do.to(a.dtype), stats[a.dtype], scale,
                                p_drop, seed)

    def sdpa(a, grad):
        q, k, v = (u.detach().requires_grad_(grad) for u in a.unbind(0))
        m = mask[:, None].to(a.dtype)
        return q, k, v, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                               dropout_p=p_drop, scale=scale)

    def bwd_library(a):
        q, k, v, call = sdpa(a, True)
        return _grad_call(call(), (q, k, v), do.to(a.dtype))

    ops = 4 * b * nh * n * n * hd
    label = label.replace("qkv=", "q,k,v=3x").replace(f",{3 * nh},", f",{nh},")
    fwd_rec = measure("fused_self_attention", label, stack, fwd,
                      lambda a: wa.fused_self_attention_plain(*a.unbind(0), mask, scale, p_drop,
                                                              seed),
                      lambda a: sdpa(a, False)[-1], torch.bfloat16, "sa", ops,
                      "bf16_tensor", (stack.numel() + do.numel()) * 2 + _span_bytes(mask))
    bwd_rec = measure("fused_self_attention_bwd", label, stack, bwd,
                      lambda a: wa.fused_self_attention_backward_plain(
                          *a.unbind(0), mask, do.to(a.dtype), scale, p_drop, seed),
                      bwd_library, torch.bfloat16, "sa_bwd_qkv", 2.5 * ops, "bf16_tensor",
                      (2 * stack.numel() + do.numel()) * 2 + _span_bytes(mask))
    for rec in (fwd_rec, bwd_rec):
        rec["off_path"] = True
    return [fwd_rec, bwd_rec]


def _planted_library(tag, faults):
    """Build a copy of csrc/ with the ``PLANTED_TILED`` faults named in
    ``faults``; returns the loaded library."""
    src = _build.BUILD_DIR / f"planted_csrc_{tag}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    for fault in faults:
        plant(src, *PLANTED_TILED[fault])
    return _build.load(_build.build(csrc=src))


def planted_tiled_check(dev, gen):
    """Build the ``PLANTED_COPIES`` of csrc/ (at once) and hold each fault's
    kernels to the bf16 limits, each of which must fail: row 11's forward at
    the multiple-choice shape in small (8 rows of 350, 12 heads of 64, p =
    0.1) and row 5 at the fusion's (8 rows of 232, p = 0.1); row 11's
    backward at the multiple-choice rows with 24 heads of 32 (where q * scale
    rounds); the direct window backward at a Video Swin stage-2 shape in
    small (2 clips, N = 196, 16 heads of 32, shifted); row 6 at the fusion's
    shape in small (8 rows of 232, 12 heads of 64, p = 0.1); the direct
    window forward at the eval's stage 2 in small (2 clips, N = 245, 16 heads
    of 32, shifted), the packed forward at the violet stage 0 (2 clips,
    N = 196, 3 heads, shifted), the lane window forward (row 7) at the 2D
    swin's stage 2 in small (2 clips of 4 frames: 32 windows of 49 tokens,
    16 heads of 32, the 4-frame shift mask) and ``lane_attention`` (row 12)
    at the lanebench tool's stage 2 in small (16 windows of 196 tokens, 16
    heads of 32, a shift-like mask over 4 slots). Returns the faults that
    passed a check."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(PLANTED_COPIES)) as pool:
        row11, rest = pool.map(_planted_library, ("row11", "rest"), PLANTED_COPIES)
    build_s = time.perf_counter() - t0
    b, n = 8, QAMC_L
    mask = _padding_mask(dev, gen, b, n, 100, 8)
    seed = torch.tensor([78, 2], dtype=torch.int32, device=dev)
    cases = []
    for nh, hd in ((12, 64), (24, 32)):
        qkv = torch.randn(b, 3 * nh, n, hd, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, nh, n, hd, device=dev, generator=gen))
        cases.append((qkv, _sa_calls(mask, nh, hd ** -0.5, P_ATTN, seed, do)))
    (q64, ((fwd, fwd_plain, _), _)), (q32, (_, (bwd, bwd_plain, _))) = cases
    win, nh, c, hp = (4, 7, 7), 16, 512, 14
    x3 = torch.randn(2, 4, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
    dw = _bf16_values(torch.randn(2, 4, hp, hp, c, device=dev, generator=gen))
    bias = torch.randn(nh, 196, 196, device=dev, generator=gen) * 0.02
    wmask = torch.from_numpy(_shift_attn_mask((4, hp, hp), win, (0, 3, 3))).to(dev)
    lb, ll = 8, TRAIN_L
    xl = torch.randn(lb, ll, 3 * 768, device=dev, generator=gen) * 0.5
    dl = _bf16_values(torch.randn(lb, ll, 768, device=dev, generator=gen))
    lmask = _padding_mask(dev, gen, lb, ll, 32, 6)
    lseed = torch.tensor([77, 1], dtype=torch.int32, device=dev)
    window = (lambda a: wa._direct_bwd(a, bias, wmask, dw.to(a.dtype), win, nh, 32 ** -0.5),
              lambda a: wa.direct_window_attention_backward_plain(
                  a, bias, wmask, dw.to(a.dtype), win, nh, 32 ** -0.5),
              x3, _window_bwd_kind(32))
    lane = (lambda a: wa._lane_bwd(a, lmask, dl.to(a.dtype), 12, 0.125, P_ATTN, lseed),
            lambda a: wa.lane_self_attention_backward_plain(a, lmask, dl.to(a.dtype), 12, 0.125,
                                                            P_ATTN, lseed),
            xl, "attention_bwd")
    row5 = (lambda a: wa._lane_fwd(a, lmask, 12, 0.125, P_ATTN, lseed),
            lambda a: wa.lane_self_attention_plain(a, lmask, 12, 0.125, P_ATTN, lseed),
            xl, _lane_fwd_kind(64))
    ewin = (5, 7, 7)
    xe = torch.randn(2, 5, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
    ebias = torch.randn(nh, 245, 245, device=dev, generator=gen) * 0.02
    emask = torch.from_numpy(_shift_attn_mask((5, hp, hp), ewin, (0, 3, 3))).to(dev)
    direct_fwd = (lambda a: wa._direct_fwd(a, ebias, emask, ewin, nh, 32 ** -0.5),
                  lambda a: wa.direct_window_attention_plain(a, ebias, emask, ewin, nh,
                                                             32 ** -0.5),
                  xe, _window_fwd_kind(32, 245))
    pbias = torch.randn(3, 196, 196, device=dev, generator=gen) * 0.02
    pmask = torch.from_numpy(_shift_attn_mask((4, 56, 56), win, (0, 3, 3))).to(dev)
    xp = torch.randn(128, 9, 196, 32, device=dev, generator=gen) * 0.5
    packed_fwd = (lambda a: wa._packed_fwd(a, pbias, pmask, 64, 3, 32 ** -0.5),
                  lambda a: wa.packed_window_attention_plain(a, pbias, pmask, 64, 3, 32 ** -0.5),
                  xp, _window_fwd_kind(32, 196))
    xw = torch.randn(32, 49, 3 * c, device=dev, generator=gen) * 0.5
    wbias = torch.randn(nh, 49, 49, device=dev, generator=gen) * 0.02
    wmask2d = torch.from_numpy(_shift_attn_mask((4, hp, hp), (1, 7, 7), (0, 3, 3))).to(dev)
    row7 = (lambda a: wa._lane_window_fwd(a, wbias, wmask2d, 16, nh, 32 ** -0.5),
            lambda a: wa.lane_window_attention_reference(a, wbias, wmask2d, 16, nh, 32 ** -0.5),
            xw, _window_fwd_kind(32, 49))
    xr = torch.randn(16, 196, 3 * c, device=dev, generator=gen) * 0.5
    rbias = torch.randn(nh, 196, 196, device=dev, generator=gen) * 0.1
    rmask = _shift_like_mask(dev, gen, 4, 196)
    row12 = (lambda a: wa._lane_attention_fwd(a, rbias, rmask, nh, 32 ** -0.5),
             lambda a: wa.lane_attention_reference(a, rbias, rmask, nh, 32 ** -0.5),
             xr, _window_fwd_kind(32, 196))
    checks = ((row11, {"row 11 forward": (fwd, fwd_plain, q64, "sa"), "row 5": row5},
               {"row 11 backward": (bwd, bwd_plain, q32, "sa_bwd")}),
              (rest, {"direct backward": window}, {"row 6": lane},
               {"direct forward": direct_fwd, "packed forward": packed_fwd, "row 7": row7,
                "row 12": row12}))
    real = _build.library()
    caught = {}
    try:
        for (lib, *per_fault), faults in zip(checks, PLANTED_COPIES):
            _build._lib = lib
            for fault, fault_checks in zip(faults, per_fault):
                caught[fault] = {where: bf16_check(*check)
                                 for where, check in fault_checks.items()}
    finally:
        _build._lib = real
    print(json.dumps({"planted_tiled_faults": {
        k: {where: dict(readings=r, failures=f) for where, (r, f) in v.items()}
        for k, v in caught.items()}, "build_s": build_s}), flush=True)
    return [f"planted fault passes the bf16 limits: {k} [{where}]"
            for k, v in caught.items() for where, (_, f) in v.items() if not f]


def _planted_ln_library(fault):
    """Build ``LN_SOURCES`` with the ``PLANTED_LN`` fault ``fault``; returns
    the loaded library (the LayerNorm entry points alone)."""
    src = _build.BUILD_DIR / f"planted_csrc_ln_{list(PLANTED_LN).index(fault)}"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for name in LN_SOURCES:
        shutil.copy(_build.CSRC / name, src / name)
    plant(src, *PLANTED_LN[fault])
    return _build.load(_build.build(csrc=src), False)


def planted_ln_check(dev, gen):
    """Build the ``PLANTED_LN`` copies (at once) and hold each fault at the
    train fusion site (18,560 rows of 768, bf16), where each must fail: the
    one-pass variance the forward's bf16 limits at the ``LARGE_MEAN`` rows,
    the m2 fault dx's limits and the partial fault dgamma's or dbeta's
    (fp32 and bf16). Returns the faults that passed."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(PLANTED_LN)) as pool:
        libs = dict(zip(PLANTED_LN, pool.map(_planted_ln_library, PLANTED_LN)))
    build_s = time.perf_counter() - t0
    _, rows, c, eps, _ = TRAIN_LN[0]
    x, large, g, bt = _ln_inputs(dev, gen, rows, c)
    dy = _bf16_values(torch.randn(rows, c, device=dev, generator=gen))
    fwd, fwd_plain, _ = _ln_fwd_calls(g, bt, eps, c)
    bwd, bwd_plain, _ = _ln_bwd_calls(g, dy, eps, c)
    checks = {"one-pass variance": lambda: bf16_check(fwd, fwd_plain, large, "layer_norm"),
              "m2 dropped from dx": lambda: full_check(bwd, bwd_plain, x, "layer_norm_bwd"),
              "first partial left out of dgamma and dbeta": lambda: full_check(
                  bwd, bwd_plain, x, "layer_norm_bwd")}
    wants = {"one-pass variance": ("out",), "m2 dropped from dx": ("dx",),
             "first partial left out of dgamma and dbeta": ("dgamma", "dbeta")}
    real = _build.library()
    caught = {}
    try:
        for fault, lib in libs.items():
            _build._lib = lib
            caught[fault] = checks[fault]()
    finally:
        _build._lib = real
    print(json.dumps({"planted_ln_faults": {
        k: dict(readings=r, failures=f) for k, (r, f) in caught.items()}, "build_s": build_s}),
        flush=True)
    return [f"planted fault passes the LayerNorm limits: {k}" for k, (_, f) in caught.items()
            if not any(msg.startswith(wants[k]) for msg in f)]


def ln_bwd_cases(dev, gen, sites=TRAIN_LN, path="", planted=True):
    """The LayerNorm backward at ``sites`` (the four of the pretrain step, or
    ``FINETUNE_LN``), each also at ``LARGE_MEAN``; dgamma and dbeta of two
    runs bit-identical; with ``planted``, the ``PLANTED_LN`` faults at the
    first site."""
    recs = []
    for label, rows, c, eps, work in sites:
        x, large, g, _ = _ln_inputs(dev, gen, rows, c)
        dy = _bf16_values(torch.randn(rows, c, device=dev, generator=gen))
        calls = _ln_bwd_calls(g, dy, eps, c)
        item = torch.finfo(work).bits // 8
        rec = measure("fused_layer_norm_bwd", f"{path}{label} rows={rows} C={c} eps={eps}", x,
                      *calls, work, "layer_norm_bwd", 16 * rows * c, "fp32",
                      3 * rows * c * item + 3 * c * 4)
        rec = _ln_record(rec, "layer_norm_bwd", calls, x, large, c, work)
        a = x.to(work)
        first, second = calls[0](a)[1:], calls[0](a)[1:]
        rec["dgamma_dbeta_bit_identical"] = all(map(torch.equal, first, second))
        if not rec["dgamma_dbeta_bit_identical"]:
            rec["failures"].append(f"fused_layer_norm_bwd [{rec['shape']}] dgamma, dbeta differ "
                                   "between two runs")
        recs.append(rec)
    if planted:
        recs[0]["failures"] += planted_ln_check(dev, gen)
    return recs


# ---------------------------------------------------------------------------
# phase 3: rows 5 and 6 under the seq2seq joint mask
# ---------------------------------------------------------------------------

# The fault a mask whose rows differ guards against, which a padding mask (a
# stride-0 view: every row alike) cannot show: rows 5, 6 and 11 reading each
# query row's mask at row 0. Planted in both C entries of
# csrc/self_attention.cu (rows 5 and 6) and of csrc/self_attention_tiled.cu
# (row 11), so in every body, fp32 and bf16, in a copy of the self-attention
# sources alone (ROW_STRIDE_SOURCES); one (file, texts, planted texts) each.
_ROW_STRIDE_ENTRY = ("  auto s = static_cast<cudaStream_t>(stream);\n"
                     "  if (nh > 0 && dm % nh == 0 && emvm::tensor_core_body(dtype, dm / nh))\n"
                     "    return emvm::lane_self_attention_{}_mma(")
_TILED_ENTRY = ("  auto s = static_cast<cudaStream_t>(stream);\n"
                "  if (emvm::tensor_core_body(dtype, hd)) {{\n"
                "    auto {} = hd == 32")


def _stride_zero(entries):
    return tuple(e.replace("(stream);\n", "(stream);\n  mask_sr = 0;\n", 1) for e in entries)


PLANTED_ROW_STRIDE = tuple(
    (name, entries, _stride_zero(entries)) for name, entries in (
        ("self_attention.cu", tuple(_ROW_STRIDE_ENTRY.format(d) for d in ("fwd", "bwd"))),
        ("self_attention_tiled.cu", tuple(_TILED_ENTRY.format(d) for d in ("fwd", "bwd")))))
ROW_STRIDE_SOURCES = ("common.cuh", "self_attention.cu", "self_attention_tiled.cu",
                      "self_attention_mma.cuh")


def planted_row_stride_library():
    """Build ``ROW_STRIDE_SOURCES`` with the ``PLANTED_ROW_STRIDE`` fault;
    returns the loaded library (the lane self-attention's entry points)."""
    src = _build.BUILD_DIR / "planted_csrc_row_stride"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for name in ROW_STRIDE_SOURCES:
        shutil.copy(_build.CSRC / name, src / name)
    for fault in PLANTED_ROW_STRIDE:
        plant(src, *fault)
    return _build.load(_build.build(csrc=src), False)


def seq2seq_mask(dev, b, l, text):
    """The (B, L, L) view that BertEncoder passes of the port's seq2seq
    joint bias over [video ; the last ``text`` tokens], every video token
    valid: video rows see the video, text rows the video and the text at or
    before them, so the rows differ (query-row stride L)."""
    ones = functools.partial(torch.ones, dtype=torch.int32, device=dev)
    return joint_attn_bias(ones((b, l - text)), ones((b, text)), "seq2seq").reshape(b, l, l)


def seq2seq_lane_cases(dev, gen, planted):
    """Rows 5 and 6 under the seq2seq joint mask, at ``SEQ2SEQ_LANE``'s
    shapes (BERT-base heads): row 5 with dropout and row 6 at the caption
    step's and the smtm fusion's, row 5 at p = 0 at the decoders'; the
    dropout keep fraction. The mask is (B, L, L) fp32 with rows that differ;
    the bound reads it once (B L^2 4 bytes), though each of the 12 heads
    reads it again (``mask_bytes_all_heads``, from L2). At the caption
    step's shape rows 5 and 6 also run under a padding mask of the same
    shape (the stride-0 view of the earlier paths; ``off_path``), so the
    per-row mask's cost reads in one run. The fault ``planted`` (a future
    of :func:`planted_row_stride_library`) must fail the limits."""
    d, nh = 768, 12
    hd, scale = d // nh, (d // nh) ** -0.5
    seed = torch.tensor([20261017, 3], dtype=torch.int32, device=dev)
    recs = []
    for label, b, l, text, p_drop, on_path in SEQ2SEQ_LANE:
        x3 = torch.randn(b, l, 3 * d, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, l, d, device=dev, generator=gen))
        masks = {"seq2seq": seq2seq_mask(dev, b, l, text)}
        if label == "caption":
            masks["padding"] = _padding_mask(dev, gen, b, l, text, 6)
        for kind, mask in masks.items():
            recs += masked_lane_records(label, x3, do, mask, kind, p_drop, seed,
                                        not on_path or kind == "padding")
    for label, b, l, text, p_drop in SEQ2SEQ_TILED:
        require(not wa.lane_sa_attention_fits(b, l, d, nh), f"{label}: row 5 fits")
        qkv = torch.randn(b, 3 * nh, l, hd, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, nh, l, hd, device=dev, generator=gen))
        mask = seq2seq_mask(dev, b, l, text)
        (fwd, *fwd_rest), (bwd, *bwd_rest) = _sa_calls(mask, nh, scale, p_drop, seed, do)
        name = f"{label} qkv=({b},{3 * nh},{l},{hd}) p_drop={p_drop} seq2seq mask"
        info = dict(mask="seq2seq", mask_row_stride=mask.stride(1),
                    mask_bytes=_span_bytes(mask), off_path=True, body=_bodies(wa._sa_body, hd))
        ops = 4 * b * nh * l * l * hd
        recs.append({**measure("packed_self_attention", name, qkv, fwd, *fwd_rest,
                               torch.bfloat16, "sa", ops, "bf16_tensor",
                               (qkv.numel() + do.numel()) * 2 + _span_bytes(mask)), **info})
        recs.append({**measure("packed_self_attention_bwd", name, qkv, bwd, *bwd_rest,
                               torch.bfloat16, "sa_bwd", 2.5 * ops, "bf16_tensor",
                               (2 * qkv.numel() + do.numel()) * 2 + _span_bytes(mask)),
                     **info})
    recs[0]["failures"] += planted_row_stride_check(dev, gen, planted)
    return recs


def masked_lane_records(label, x3, do, mask, kind, p_drop, seed, off_path):
    """Row 5 (with dropout where ``p_drop``) on x3 (B, L, 3D) under ``mask``
    (B, L, L) and, where ``p_drop``, row 6 and the dropout keep fraction:
    BERT-base heads. The bound reads the mask once (the bytes its view
    spans), though each of the 12 heads reads it again
    (``mask_bytes_all_heads``, from L2)."""
    (b, l, d3), nh = x3.shape, 12
    d = d3 // 3
    hd = d // nh
    (fwd, *fwd_rest), (bwd, *bwd_rest) = _lane_calls(mask, nh, hd ** -0.5, p_drop,
                                                     seed if p_drop else None, do)
    name = f"{label} x3=({b},{l},{d3}) nH={nh} p_drop={p_drop} {kind} mask"
    info = dict(mask=kind, mask_row_stride=mask.stride(1), mask_bytes=_span_bytes(mask),
                mask_bytes_all_heads=nh * _span_bytes(mask), off_path=off_path,
                body=_bodies(wa._sa_body, hd))
    ops = 4 * b * nh * l * l * hd
    rec = measure("lane_self_attention_dropout" if p_drop else "lane_self_attention", name, x3,
                  fwd, *fwd_rest, torch.bfloat16, _lane_fwd_kind(hd), ops, "bf16_tensor",
                  x3.numel() * 2 + b * l * d * 2 + _span_bytes(mask))
    recs = [{**rec, **info}]
    if p_drop:
        keep = wa.dropout_keep(seed, (b, nh, l, l), p_drop)
        frac = keep.float().mean().item()
        sigma = (p_drop * (1 - p_drop) / keep.numel()) ** 0.5
        del keep
        recs[-1]["keep_fraction"] = frac
        if abs(frac - (1 - p_drop)) > KEEP_SIGMAS * sigma:
            recs[-1]["failures"].append(f"dropout keep fraction {frac} is not "
                                        f"{1 - p_drop} +- {KEEP_SIGMAS} sigma")
        rec = measure("lane_self_attention_bwd", name, x3, bwd, *bwd_rest, torch.bfloat16,
                      "attention_bwd", 2.5 * ops, "bf16_tensor",
                      (2 * x3.numel() + do.numel()) * 2 + _span_bytes(mask))
        recs.append({**rec, **info})
    return recs


def planted_row_stride_check(dev, gen, planted):
    """Hold rows 5 and 6 of the ``PLANTED_ROW_STRIDE`` build (``planted``, a
    future of the loaded library) under the seq2seq mask at the caption
    step's shape in small (4 rows of 275, p = 0.1), and row 11 at
    ``SEQ2SEQ_TILED``'s length in small (2 rows of 350, p = 0.1): each must
    fail the fp32 limits and the bf16 ones. Returns the checks the fault
    passed."""
    lib = planted.result()
    b, l, text, nh = 4, 275, 25, 12
    x3 = torch.randn(b, l, 3 * 768, device=dev, generator=gen) * 0.5
    do = _bf16_values(torch.randn(b, l, 768, device=dev, generator=gen))
    seed = torch.tensor([79, 4], dtype=torch.int32, device=dev)
    (fwd, fwd_plain, _), (bwd, bwd_plain, _) = _lane_calls(seq2seq_mask(dev, b, l, text), nh,
                                                           0.125, P_ATTN, seed, do)
    _, _, n, t_text, _ = SEQ2SEQ_TILED[0]
    qkv = torch.randn(2, 3 * nh, n, 64, device=dev, generator=gen) * 0.5
    t_do = _bf16_values(torch.randn(2, nh, n, 64, device=dev, generator=gen))
    (t_fwd, t_fwd_plain, _), (t_bwd, t_bwd_plain, _) = _sa_calls(
        seq2seq_mask(dev, 2, n, t_text), nh, 0.125, P_ATTN, seed, t_do)
    real = _build.library()
    try:
        _build._lib = lib
        caught = {"row 5": full_check(fwd, fwd_plain, x3, _lane_fwd_kind(64)),
                  "row 6": full_check(bwd, bwd_plain, x3, "attention_bwd"),
                  "row 11": full_check(t_fwd, t_fwd_plain, qkv, "sa"),
                  "row 11 bwd": full_check(t_bwd, t_bwd_plain, qkv, "sa_bwd")}
    finally:
        _build._lib = real
    print(json.dumps({"planted_row_stride_fault": {
        where: dict(readings=r, failures=f) for where, (r, f) in caught.items()}}), flush=True)
    return [f"planted fault (query-row stride 0) passes the {dt} limits [{where}]"
            for where, (_, f) in caught.items()
            for dt, tag in (("fp32", " fp32 max err"), ("bf16", " bf16")) if not any(
                tag in msg for msg in f)]


# phase 3's records at the shapes and masks that phases 49-50 bring to rows 1,
# 2, 5 and 6: the text stack's 20 captions of 32 tokens (rows 5-6 with
# dropout under their padding mask, below one 64-key tile) and its 640 rows
# of 768 (rows 1-2, bf16, eps 1e-12); the SwinBERT layout's fusion, whose
# video keys have a hole at each frame's first token (the fake CLS, mask 0):
# the caption step's 8 rows of 5 x 50 + 25 under the seq2seq mask (the path)
# and under the full one (a padding mask with holes, off the path), and the
# greedy decoder's 8 rows of 5 x 50 + 20 (p = 0)
TEXT_STACK_LANE = (TRAIN_B, 32, 32)
TEXT_STACK_LN = (("text stack", TRAIN_B * 32, 768, 1e-12, torch.bfloat16),)
SWINBERT_LANE = (("swinbert caption", CAPTION_B, 275, 25, P_ATTN, ("seq2seq", "full")),
                 ("swinbert greedy decode", CAPTION_B, 270, GEN_MAX_LEN, 0.0, ("seq2seq",)))
# A fault that only a mask with holes shows: the tensor-core body (the bf16
# path) reading each row's mask as suffix padding, its allowed keys counted
# and the first that many attended. Padding and seq2seq rows allow a prefix
# of the keys, so the planted build equals the real one under them.
_SUFFIX_HELPER = (
    "// planted: each row's mask read as suffix padding\n"
    "static __device__ __forceinline__ float suffix_mask(const float* row, int j, int n) {\n"
    "  int len = 0;\n"
    "  for (int u = 0; u < n; ++u) len += __ldg(row + u) == 0.f;\n"
    "  return j < len ? 0.f : -CUDART_INF_F;\n"
    "}\n\n")
_SUFFIX_ANCHOR = "// kStatsOnly: pass 1 alone, writing the rows' max and sum and no output"
PLANTED_SUFFIX_MASK = ("self_attention_mma.cuh", (
    _SUFFIX_ANCHOR,
    "rows[r] < n ? __ldg(mrow[r] + j) : 0.f;",
    "valid ? prob(sc[nt][e], __ldg(mrow[r] + j),",
    "p = prob(sc[nt][e], __ldg(mask_b + i * mask_sr + j),"), (
    _SUFFIX_HELPER + _SUFFIX_ANCHOR,
    "rows[r] < n ? suffix_mask(mrow[r], j, n) : 0.f;",
    "valid ? prob(sc[nt][e], suffix_mask(mrow[r], j, n),",
    "p = prob(sc[nt][e], suffix_mask(mask_b + i * mask_sr, j, n),"))


def planted_suffix_library():
    """Build ``ROW_STRIDE_SOURCES`` with the ``PLANTED_SUFFIX_MASK`` fault;
    returns the loaded library."""
    src = _build.BUILD_DIR / "planted_csrc_suffix_mask"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for name in ROW_STRIDE_SOURCES:
        shutil.copy(_build.CSRC / name, src / name)
    plant(src, *PLANTED_SUFFIX_MASK)
    return _build.load(_build.build(csrc=src), False)


def swinbert_mask(dev, gen, b, l, text, kind):
    """The (B, L, L) view that BertEncoder passes of the joint bias over
    [video ; the last ``text`` tokens] in SwinBERT's layout: frames of 50
    video tokens whose first (the fake CLS) has mask 0. ``seq2seq``: video
    rows see the valid video, text rows it and the text at or before them;
    ``full``: every row the valid video and its caption of 6 to ``text``
    tokens (a stride-0 view)."""
    frames = (l - text) // 50
    img = torch.ones((b, frames, 50), dtype=torch.int32, device=dev)
    img[:, :, 0] = 0
    img = img.reshape(b, frames * 50)
    if kind == "seq2seq":
        txt = torch.ones((b, text), dtype=torch.int32, device=dev)
        return joint_attn_bias(img, txt, "seq2seq").reshape(b, l, l)
    lens = torch.randint(6, text + 1, (b,), device=dev, generator=gen)
    txt = (torch.arange(text, device=dev)[None] < lens[:, None]).to(torch.int32)
    return joint_attn_bias(img, txt, "full").reshape(b, 1, l).expand(b, l, l)


def swinbert_lane_cases(dev, gen, planted):
    """Rows 5 and 6 under the SwinBERT masks at ``SWINBERT_LANE``'s shapes
    (``masked_lane_records``), and the ``PLANTED_SUFFIX_MASK`` build
    (``planted``, a future of the loaded library), which must fail there."""
    d = 768
    seed = torch.tensor([20261018, 5], dtype=torch.int32, device=dev)
    recs = []
    for label, b, l, text, p_drop, kinds in SWINBERT_LANE:
        x3 = torch.randn(b, l, 3 * d, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(b, l, d, device=dev, generator=gen))
        for kind in kinds:
            recs += masked_lane_records(label, x3, do, swinbert_mask(dev, gen, b, l, text, kind),
                                        f"swinbert {kind}", p_drop, seed, kind == "full")
    recs[0]["failures"] += planted_suffix_check(dev, gen, planted)
    return recs


def planted_suffix_check(dev, gen, planted):
    """Rows 5 and 6 (p = 0.1) of the ``PLANTED_SUFFIX_MASK`` build at 4 rows
    of 5 x 50 + 25 against their plain versions in bf16 (the body it
    plants): within the limits under a padding mask and the seq2seq one
    (the earlier paths' masks, every row a prefix of allowed keys), beyond
    them under both SwinBERT masks. Returns the checks it passed wrongly."""
    lib = planted.result()
    b, l, text, nh = 4, 275, 25, 12
    x3 = torch.randn(b, l, 3 * 768, device=dev, generator=gen) * 0.5
    do = _bf16_values(torch.randn(b, l, 768, device=dev, generator=gen))
    seed = torch.tensor([81, 6], dtype=torch.int32, device=dev)
    masks = {"padding": _padding_mask(dev, gen, b, l, text, 6),
             "seq2seq": seq2seq_mask(dev, b, l, text),
             "swinbert full": swinbert_mask(dev, gen, b, l, text, "full"),
             "swinbert seq2seq": swinbert_mask(dev, gen, b, l, text, "seq2seq")}
    real = _build.library()
    caught, wrong = {}, []
    try:
        _build._lib = lib
        for kind, mask in masks.items():
            (fwd, fwd_plain, _), (bwd, bwd_plain, _) = _lane_calls(mask, nh, 0.125, P_ATTN,
                                                                   seed, do)
            for row, kernel, plain, limits in (("row 5", fwd, fwd_plain, _lane_fwd_kind(64)),
                                               ("row 6", bwd, bwd_plain, "attention_bwd")):
                readings, failures = bf16_check(kernel, plain, x3, limits)
                caught[f"{row}, {kind} mask"] = dict(readings=readings, failures=failures)
                if bool(failures) != kind.startswith("swinbert"):
                    wrong.append(f"planted fault (mask read as suffix padding) "
                                 f"{'passes' if not failures else 'fails'} the bf16 limits "
                                 f"[{row}, {kind} mask]")
    finally:
        _build._lib = real
    print(json.dumps({"planted_suffix_mask_fault": caught}), flush=True)
    return wrong


# ---------------------------------------------------------------------------
# phase 4: the full-width slice
# ---------------------------------------------------------------------------

class SyntheticRetrievalDataset:
    """``n`` captions over ``n`` videos of ``clips`` seeded uint8 clips, the
    interface of data/datasets.py RetrievalDataset.multi_clip_item."""

    def __init__(self, n, clips, frames, size, size_txt, vocab, seed=0):
        rs = np.random.RandomState(seed)
        self.items, self.gt_txt2vid = [], {}
        for i in range(n):
            txt = np.zeros(size_txt, np.int32)
            length = rs.randint(6, size_txt + 1)
            txt[:length] = rs.randint(1000, vocab, length)
            txt[0], txt[length - 1] = 101, 102            # [CLS] ... [SEP]
            self.items.append({
                "img": rs.randint(0, 256, (clips, frames, size, size, 3)).astype(np.uint8),
                "txt": txt, "mask": (txt > 0).astype(np.int32),
                "vid": f"video{i}", "tid": i})
            self.gt_txt2vid[i] = f"video{i}"

    def __len__(self):
        return len(self.items)

    def multi_clip_item(self, i):
        return self.items[i]


def synthetic_pretrain_batch(b, cfg, seed, device):
    """``b`` seeded uint8 clips and captions of 6 to size_txt tokens
    ([CLS] ... [SEP], zero-padded), with their padding mask."""
    rs = np.random.RandomState(seed)
    txt = np.zeros((b, cfg.size_txt), np.int32)
    for i in range(b):
        n = rs.randint(6, cfg.size_txt + 1)
        txt[i, :n] = rs.randint(1000, cfg.text.vocab_size, n)
        txt[i, 0], txt[i, n - 1] = 101, 102
    img = rs.randint(0, 256, (b, cfg.size_frame, cfg.size_img, cfg.size_img, 3))
    return {"img": torch.from_numpy(img.astype(np.uint8)).to(device),
            "txt": torch.from_numpy(txt).to(device),
            "mask": torch.from_numpy((txt > 0).astype(np.int32)).to(device)}


def synthetic_vq_tokens(b, cfg, size_vq, device):
    """Seeded pre-extracted vq tokens (B, T*(1+h*w)), each frame's CLS slot
    included (the masking gives it no answer)."""
    hw = cfg.size_img // cfg.size_patch
    rs = np.random.RandomState(8)
    tokens = rs.randint(0, size_vq, (b, cfg.size_frame * (1 + hw * hw)))
    return torch.from_numpy(tokens.astype(np.int64)).to(device)


def with_mvm_target(run, target):
    """``run`` with ``train.mvm_target`` replaced, as bench.py builds the
    2d_feature model from configs/pretrain.json."""
    return dataclasses.replace(run, train=dataclasses.replace(run.train, mvm_target=target))


def with_swin2d_backbone(run):
    """``run`` with the trained 2D Swin backbone (``vis_backbone`` "swin2d",
    concat fusion) in place of the Video Swin."""
    return with_2d_backbone(run, "swin2d")


def with_violet_backbone(run):
    """``run`` with the C = 96 Video Swin of the reference's
    ``swin_violet.py`` (``vis_backbone_size`` "violet") in place of
    Swin-base."""
    return dataclasses.replace(run, model=dataclasses.replace(run.model,
                                                              vis_backbone_size="violet"))


def backbone_config(cfg):
    """The SwinConfig the model's image encoder builds."""
    if cfg.vis_backbone in ("swin", "swin2d") and cfg.swin_custom is None:
        return swin2d_config(cfg.vis_backbone_size)
    return cfg.swin


def _teacher(name):
    return name.startswith(TEACHERS)


def with_vq_on_the_fly(run):
    """``run`` with the vq target and ``model.vq_on_the_fly``: the dVAE
    teacher extracts the tokens in the step."""
    run = with_mvm_target(run, ("vq",))
    return dataclasses.replace(run, model=dataclasses.replace(run.model, vq_on_the_fly=True))


def _event_ms(fn) -> float:
    """Device time of one call of fn, from CUDA events around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def target_times(model, img):
    """Device ms of one no-grad call of each MVM teacher of ``model`` on the
    normalized clips ``img`` (``feature_model`` on the clips; ``clip_model``
    on their frames, CLIP-normalized; ``dpt`` on the frames; ``raft`` on the
    adjacent frame pairs; the dVAE's ``extract_vq_tokens`` on the frames)
    and of ``hog_image``, as the step makes its targets; with RAFT, also the
    share of the pairs whose flow stays under the loss's 50 pixels."""
    b, t = img.shape[:2]
    frames = img.reshape(b * t, *img.shape[2:])
    calls, extra = {}, {}
    if hasattr(model, "feature_model"):
        calls["feature_model"] = lambda: model.feature_model(img)
    if hasattr(model, "clip_model"):
        clip_frames = renormalize_imagenet_to_clip(frames)
        calls["clip_model"] = lambda: model.clip_model.features(clip_frames)
    if hasattr(model, "dpt"):
        calls["dpt"] = lambda: model.dpt(frames)
    if hasattr(model, "raft"):
        pairs = (img[:, :-1].reshape(-1, *img.shape[2:]), img[:, 1:].reshape(-1, *img.shape[2:]))
        calls["raft"] = lambda: model.raft(*pairs)
    if hasattr(model, "dvae"):
        calls["dvae"] = lambda: model.dvae.extract_vq_tokens(frames)
    if "hog" in model.mvm_target:
        calls["hog_image"] = lambda: hog_image(img)
    with torch.no_grad():
        times = {name: _event_ms(fn) for name, fn in calls.items()}
        if hasattr(model, "raft"):
            flow = model.raft(*pairs)
            extra["flow_pairs_kept_share"] = (flow.abs().amax(dim=(1, 2, 3)) < 50.0
                                              ).float().mean().item()
            extra["flow_max_abs"] = flow.abs().max().item()
        if hasattr(model, "dvae"):
            extra["vq_distinct_tokens"] = len(model.dvae.extract_vq_tokens(frames).unique())
    return times, extra


VTM_OUT_BIAS = "fc.3.bias"


def train_phase(dev, run, want_launches, record=None):
    """Phases 6, 8, 10, 12, 18-20 and 22-24: the pretrain train step at full
    width for the run's backbone and MVM target (pre-extracted vq: seeded
    tokens in the batch; the dVAE's logits centred on the first clip,
    ``center_dvae_logits``). Returns the launch counts of the first timed step,
    which must equal ``want_launches``. After the timed steps, the device
    time of one more step's kernels under the profiler, and the MVM
    teachers' and HOG's device time of one no-grad call each
    (``target_times``). ``record``, a dict, receives the median step ms and
    the kernel ms."""
    cfg = run.model
    b = run.train.size_batch
    model = VioletPretrain.from_run_config(run, dtype=torch.bfloat16, device=dev,
                                           seed=TRAIN_SEED)
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
    state = create_train_state(model, opt)
    step = make_pretrain_train_step(model, opt)
    batch = synthetic_pretrain_batch(b, cfg, seed=3, device=dev)
    target = run.train.mvm_target
    if "vq" in target and not cfg.vq_on_the_fly:
        batch["vq"] = synthetic_vq_tokens(b, cfg, model.fc_mvm[3].out_features, dev)
    if hasattr(model, "dvae"):
        center_dvae_logits((model,), maybe_normalize(batch["img"][0]))
    before = {n: p.detach().clone() for n, p in state.params.items()}
    t0 = time.perf_counter()
    state, ls = step(state, batch, TRAIN_SEED)             # warm-up: first launches, cuBLAS
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    losses = [{k: v.item() for k, v in ls.items()}]
    torch.cuda.reset_peak_memory_stats(dev)
    secs, launches = [], {}
    for i in range(TRAIN_STEPS):
        if i == 0:
            _build.launch_counts.clear()
        t0 = time.perf_counter()
        state, ls = step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(_build.launch_counts)
        losses.append({k: v.item() for k, v in ls.items()})
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    clips_s = [b / t for t in secs]
    kernel_ms = _kernel_ms(_stepper(step, state, batch))
    if record is not None:
        record.update(step_ms_median=float(np.median(secs)) * 1e3, kernel_ms=kernel_ms)
    targets_ms, targets_info = target_times(model, maybe_normalize(batch["img"]))
    backbone = f"{cfg.vis_backbone}-{cfg.vis_backbone_size}"
    print(f"train-step {backbone} {target} launch counts: {launches}", flush=True)
    print(json.dumps({
        "slice": "pretrain_train_step", "config": PRETRAIN_CONFIG.name,
        "vis_backbone": cfg.vis_backbone, "vis_backbone_size": cfg.vis_backbone_size,
        "mvm_target": list(target), "vq_on_the_fly": cfg.vq_on_the_fly,
        "pretrain_tasks": list(run.train.pretrain_tasks),
        "pretrain_masks": list(run.train.pretrain_masks), "r50_train_bn": cfg.r50_train_bn,
        "dtype": "bfloat16",
        "batch": b, "frames": cfg.size_frame, "size_img": cfg.size_img,
        "size_txt": cfg.size_txt, "steps": TRAIN_STEPS, "warmup_step_s": warm_s,
        "clips_per_s": float(np.median(clips_s)), "clips_per_s_range": [min(clips_s),
                                                                          max(clips_s)],
        "step_ms_median": float(np.median(secs)) * 1e3, "step_s_each": secs,
        "peak_mem_gib": peak, "losses_each_step": losses,
        "kernel_ms_one_step": kernel_ms,
        "device_idle_share": 1.0 - kernel_ms / (float(np.median(secs)) * 1e3),
        "target_ms_one_call": targets_ms, **targets_info}), flush=True)
    require(launches == want_launches,
            f"launches of one {backbone} {target} train step {launches}, "
            f"not {want_launches}")
    for i, step_ls in enumerate(losses):
        require(all(np.isfinite(v) for v in step_ls.values()),
                f"non-finite loss at step {i}: {step_ls}")
    # no gradient: the frame-order embedding, which the pretrain forward does
    # not use, and the frozen teachers, which must also be bit-unchanged
    teacher = {n for n in state.params if _teacher(n)}
    require(bool(teacher) == bool(TEACHER_TARGETS & set(target)
                                  or ("vq" in target and cfg.vq_on_the_fly)),
            f"teacher parameters: {len(teacher)}")
    no_grad = {n for n, p in state.params.items() if p.grad is None}
    odr = {n for n in state.params if n.endswith(".emb_odr")}
    require(len(odr) == 1 and no_grad == teacher | odr,
            f"parameters without a gradient: {sorted(no_grad - teacher)} and "
            f"{len(no_grad & teacher)} of the {len(teacher)} teacher parameters")
    moved = [n for n in teacher if not torch.equal(before[n], state.params[n].detach())]
    require(not moved, f"frozen teacher parameters changed: {moved}")
    # The VTM score head's output bias has a gradient that is zero in exact
    # arithmetic (the softmax over the options is shift-invariant); in bf16
    # it may round to exactly 0 in every step, and Adam then leaves the bias
    # as it was. It alone may end with an all-zero gradient; every other
    # parameter with a gradient must have moved.
    zero = {n for n, p in state.params.items() if n not in no_grad and not p.grad.any()}
    print(f"parameters whose last gradient is exactly 0: {sorted(zero)}", flush=True)
    require(zero <= {VTM_OUT_BIAS}, f"all-zero last gradients: {sorted(zero - {VTM_OUT_BIAS})}")
    unchanged = [n for n, p in state.params.items()
                 if n not in no_grad | zero and torch.equal(before[n], p.detach())]
    require(not unchanged, f"parameters unchanged after {TRAIN_STEPS + 2} steps: {unchanged}")
    return launches


class SameL1Signs:
    """``models/pretrain.masked_l1`` with the card's signs on both sides
    (``L1_FLIP_SHARE``): the card's step records each call's error
    pred - target; the CPU's step after it adds, in the same call, a term of
    value 0 whose gradient turns each masked element's sign into the card's
    where the two differ. ``flips`` holds each CPU call's reading."""

    def __init__(self):
        self.card, self.flips = [], []

    def side(self, name):
        real = pretrain_module.masked_l1

        def l1(pred, target, mask, channel_div=1.0):
            loss = real(pred, target, mask, channel_div)
            err = (pred.float() - target.float()).detach()
            if name == "card":
                self.card.append(err.cpu())
                return loss
            e_c, m = self.card[len(self.flips)], mask.float()
            masked = torch.broadcast_to(m > 0, err.shape)
            flip = masked & (e_c.sign() != err.sign())
            self.flips.append(dict(
                flips=int(flip.sum()), masked=int(masked.sum()),
                apart_max=float((e_c - err).abs()[flip].max()) if flip.any() else 0.0,
                err_max=float(err.abs()[masked].max()) if masked.any() else 0.0))
            same = ((e_c.sign() - err.sign()) * (pred.float() - pred.float().detach()) * m).sum()
            return loss + same / (mesh.global_sum(m.sum()) + 1e-5) / channel_div

        return mock.patch.object(pretrain_module, "masked_l1", l1)


def whole_step_phase(dev, run, b=4, batch=None, biased=False):
    """Phases 7, 9, 11, 13, 21, 25, 37 and 45-47: one train step of a
    depth-cut copy (the student, the MERLOT encoder's ViT cut to
    ``MERLOT_CUT``, BatchNorm biases shifted by ``R50_BN_SHIFT``; the
    teachers keep their full depth but for the DPT, cut to ``DPT_CUT``), ``b`` clips (or ``batch``, CPU tensors from the loader,
    its ``corrupt`` flag included; ``biased``: the biases seeded, as
    ``seeded_biases``), card fp32 (kernels) against CPU fp32 (plain
    versions). With the hog target, both sides are fed the same ``hog``
    target, computed once on the CPU, and ``hog_image`` is held card against
    CPU apart (``hog_check``); with the DPT, RAFT or dVAE teachers, those
    are held card against CPU apart (``teachers_card_vs_cpu``; the dVAE's
    logits centred first, ``center_dvae_logits``) and both sides are fed
    the CPU's dVAE tokens. The CPU's L1 losses take the card's sign of each
    masked error (``SameL1Signs``)."""
    cut = depth_cut(run.model)
    run_cut = dataclasses.replace(run, model=cut)
    if batch is None:
        batch = synthetic_pretrain_batch(b, cut, seed=4, device="cpu")
    b = batch["img"].shape[0]
    gen = torch.Generator().manual_seed(5)
    ps = cut.size_patch
    hw = cut.size_img // ps
    draws = draw_masks(gen, batch["txt"], batch["img"].shape[1], hw, hw,
                       special_token_ids=VioletPretrain.special_token_ids,
                       mask_token_id=VioletPretrain.mask_token_id, p_mask=run.train.p_mask,
                       mask_types=run.train.pretrain_masks)
    batch.update(draws=draws,
                 neg_idx=draw_negatives(gen, b, min(b, VioletPretrain.num_options) - 1))
    if "hog" in run.train.mvm_target:
        hog_check(dev, maybe_normalize(batch["img"]))
        batch["hog"] = hog_image(maybe_normalize(batch["img"]))
    with mock.patch.object(pretrain_module, "DPTDepth",
                           functools.partial(pretrain_module.DPTDepth, **DPT_CUT)), \
            mock.patch.object(violet_module, "EncImgMerlot",
                              functools.partial(EncImgMerlot, **MERLOT_CUT)):
        card = VioletPretrain.from_run_config(run_cut, dtype=torch.float32, device=dev, seed=1)
        cpu = VioletPretrain.from_run_config(run_cut, dtype=torch.float32, device="cpu",
                                             seed=1)
    if biased:
        seeded_biases(card, 1)
    shift_bn_biases(card)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    if hasattr(cpu, "dvae"):
        center_dvae_logits((card, cpu), maybe_normalize(batch["img"][0]))
    if any(hasattr(cpu, name) for name in ("dpt", "raft", "dvae")):
        tokens = teachers_card_vs_cpu(dev, card, cpu, maybe_normalize(batch["img"]))
        if tokens is not None:
            batch["vq"] = tokens
    results, secs, signs = {}, {}, SameL1Signs()
    for name, model, device in (("card", card, dev), ("cpu", cpu, torch.device("cpu"))):
        _no_score_dropout(model)
        opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
        step = make_pretrain_train_step(model, opt)
        on_dev = {k: (type(v)(*(t.to(device) for t in v)) if k == "draws" else v.to(device))
                  for k, v in batch.items()}
        t0 = time.perf_counter()
        with signs.side(name):
            _, ls = step(create_train_state(model, opt), on_dev, 0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t0
        results[name] = _step_results(model, ls)
    for call in signs.flips:
        require(call["flips"] <= L1_FLIP_SHARE * call["masked"]
                and call["apart_max"] <= L1_FLIP_SCALE * call["err_max"],
                f"L1 error signs, card against CPU: {call}")
    # with seeded biases (or an R50's BatchNorm biases shifted) the VTM
    # scores spread, and the VTM score head's output bias, whose gradient is
    # zero in exact arithmetic, reads each side's roundoff of scores divided
    # by temp, as the nce step's does
    hold_card_against_cpu(results, secs, {
        "vis_backbone": cut.vis_backbone, "vis_backbone_size": cut.vis_backbone_size,
        "mvm_target": list(run.train.mvm_target), "swin_depths": list(cut.swin.depths),
        "fusion_layers": cut.fusion.num_hidden_layers, "batch": b,
        "frames": batch["img"].shape[1],
        **({"corrupt_rows": batch["corrupt"].nonzero().flatten().tolist()}
           if "corrupt" in batch else {}),
        **({"dpt_depth": len(cpu.dpt.pretrained.model.blocks)} if hasattr(cpu, "dpt") else {}),
        **({"vit_depth": len(cpu.enc_img.vit)} if hasattr(cpu.enc_img, "vit") else {}),
        **({"bn_bias_shift": R50_BN_SHIFT} if hasattr(cpu.enc_img, "res") else {}),
        "l1_sign_flips": signs.flips},
        zero={VTM_OUT_BIAS: NCE_ZERO_GRAD_ATOL} if biased or hasattr(cpu.enc_img, "res")
        else None)


def center_dvae_logits(models, frames):
    """Set the dVAE output bias of each of ``models`` (the CPU one last) to
    cancel the mean feature of ``frames`` (normalized, on the CPU). Seeded
    random weights give the encoder's ReLU features a large common mean,
    along which one of the 8192 tokens outscores the rest in every cell; so
    centred, the cells' differences pick their tokens, and the card against
    CPU check of the tokens sees many."""
    dvae = models[-1].dvae
    with torch.no_grad():
        x = map_pixels(unnormalize_imagenet(frames.float()).clamp(0.0, 1.0))
        mean = dvae.features(x).float().mean(dim=(0, 1, 2))
        bias = -(dvae.blocks.output.conv.w[:, :, 0, 0] @ mean)
        for m in models:
            m.dvae.blocks.output.conv.b.copy_(bias)


def teachers_card_vs_cpu(dev, card, cpu, img):
    """The DPT (first clip's frames), RAFT (first clip's pairs) and dVAE
    (every frame) of the card model against the CPU model's, fp32, on the
    normalized clips ``img`` (on the CPU): depth and flow within
    ``TEACHER_FP32_SCALE`` of their largest value, the dVAE's tokens
    differing in at most ``VQ_FLIP_SHARE`` of the cells; the readings
    printed. Returns the CPU's tokens (B, T, H/8, W/8), or None without the
    dVAE."""
    b, t = img.shape[:2]
    frames = img.reshape(b * t, *img.shape[2:])
    readings, fails, tokens = {}, [], None
    with torch.no_grad():
        outputs = {}
        if hasattr(cpu, "dpt"):
            outputs["dpt"] = (card.dpt(frames[:t].to(dev)).cpu(), cpu.dpt(frames[:t]))
        if hasattr(cpu, "raft"):
            pair = (img[0, :-1], img[0, 1:])
            outputs["raft"] = (card.raft(*(x.to(dev) for x in pair)).cpu(), cpu.raft(*pair))
        for name, (got, want) in outputs.items():
            diff, scale = (got - want).abs().max().item(), want.abs().max().item()
            readings[name] = {"max_abs_diff": diff, "max_abs": scale,
                              "limit": TEACHER_FP32_SCALE * scale}
            if not diff <= TEACHER_FP32_SCALE * scale:
                fails.append(f"{name}: card and CPU {diff:.3g} apart, above "
                             f"{TEACHER_FP32_SCALE} of {scale:.3g}")
        if hasattr(cpu, "dvae"):
            tokens = cpu.dvae.extract_vq_tokens(frames)
            share = (card.dvae.extract_vq_tokens(frames.to(dev)).cpu() != tokens
                     ).float().mean().item()
            readings["dvae"] = {"cells": tokens.numel(), "share_other_token": share,
                                "distinct_tokens": len(tokens.unique()),
                                "limit": VQ_FLIP_SHARE}
            if share > VQ_FLIP_SHARE:
                fails.append(f"dvae: {share} of the cells take another token on the card")
    print(json.dumps({"teachers_card_vs_cpu": readings}), flush=True)
    require(not fails, "teachers, card against CPU:\n" + "\n".join(fails))
    return None if tokens is None else tokens.reshape(b, t, *tokens.shape[1:])


def hog_check(dev, img):
    """``hog_image`` of the normalized clips ``img`` (on the CPU) on the card
    against the CPU: the share of pixels in another orientation bin held to
    ``HOG_FLIP_SHARE``, the rendering of the cells where none is to
    ``HOG_CELL_SCALE`` of its largest value; both printed."""
    bins_c, _ = hog_bins(img)
    bins_d, _ = hog_bins(img.to(dev))
    flipped = bins_d.cpu() != bins_c                           # (B, T, H, W)
    want, got = hog_image(img), hog_image(img.to(dev)).cpu()
    b, t, h, w = flipped.shape
    cell = flipped.reshape(b, t, h // 8, 8, w // 8, 8).any(5).any(3)
    clean = ~cell.repeat_interleave(8, 2).repeat_interleave(8, 3)
    share = flipped.float().mean().item()
    diff = (got - want).abs()
    clean_max = diff[clean].max().item()
    scale = want.abs().max().item()
    print(json.dumps({"hog_card_vs_cpu": {
        "pixels": flipped.numel(), "share_in_another_bin": share,
        "cells_with_a_changed_bin": int(cell.sum()), "max_abs_diff": diff.max().item(),
        "max_abs_diff_clean_cells": clean_max, "max_abs": scale,
        "limits": {"share": HOG_FLIP_SHARE, "clean_cells": HOG_CELL_SCALE * scale}}}),
          flush=True)
    require(share <= HOG_FLIP_SHARE, f"hog: {share} of the pixels in another bin")
    require(clean_max <= HOG_CELL_SCALE * scale,
            f"hog: {clean_max} apart in cells where no bin changed")


def _step_results(model, ls):
    """A step's losses and every parameter's gradient (zeros where None), on
    the CPU."""
    return ({k: v.item() for k, v in ls.items()},
            {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().cpu()
             for n, p in model.named_parameters()})


def hold_card_against_cpu(results, secs, info, zero=None):
    """Hold the card's step (``results["card"]``: losses, gradients) to the
    CPU's with ``WHOLE_STEP_TOL``; print the differences. The parameters in
    ``zero`` (name -> bound) have gradients that are zero in exact
    arithmetic: each side's is held to its bound instead of to the other's
    roundoff."""
    (ls_c, g_c), (ls_r, g_r) = results["card"], results["cpu"]
    tol = WHOLE_STEP_TOL
    zero = zero or {}
    g_all = max(g.abs().max().item() for g in g_r.values())
    worst, fails = [], []
    for n, bound in zero.items():
        got = max(g_c[n].abs().max().item(), g_r[n].abs().max().item())
        if got > bound:
            fails.append(f"{n}: gradient {got:.3g}, zero in exact arithmetic")
    for n, g in g_r.items():
        if n in zero:
            continue
        d = (g_c[n] - g).abs().max().item()
        bound = tol["grad_scale"] * g.abs().max().item() + tol["grad_global"] * g_all
        worst.append((d / bound, n, d))
        if d > bound:
            fails.append(f"{n}: max diff {d:.3g} > {bound:.3g}")
    loss_diff = {k: abs(ls_c[k] - ls_r[k]) for k in ls_r}
    for k, d in loss_diff.items():
        if d > tol["loss_rtol"] * abs(ls_r[k]):
            fails.append(f"loss {k}: card {ls_c[k]} cpu {ls_r[k]}")
    worst.sort(reverse=True)
    print(json.dumps({"whole_step_vs_cpu": {
        **info, "losses_card": ls_c, "losses_cpu": ls_r, "loss_abs_diff": loss_diff,
        "grad_global_max": g_all, "params": len(g_r), "step_s": secs,
        "worst_grads": [dict(param=n, max_abs_diff=d, fraction_of_limit=r)
                        for r, n, d in worst[:8]]}}), flush=True)
    require(not fails, "whole train step, card against CPU:\n" + "\n".join(fails))


# ---------------------------------------------------------------------------
# phases 14-16 and 26-31: the downstream heads' fine-tune steps and evals
# ---------------------------------------------------------------------------

def synthetic_finetune_batch(kind, b, cfg, seed, device):
    """``b`` seeded uint8 clips with the text and labels of a fine-tune
    batch of ``kind``. Text rows are [CLS] ... [SEP] of 8 to size_txt
    tokens, zero-padded, with their padding mask; ``ans`` is a seeded answer
    per clip (an option, or for ``"oe"`` an answer of the vocabulary).
    ``"mc"`` and ``"mc_mlm"`` give each clip ``size_option`` rows (B, O, X)
    of a question and an option, the others one row (B, X): a caption
    (``"retrieval"``) or a question. In ``"mc_mlm"``, ``"oe_mlm"`` and
    ``"gen"`` the token before [SEP] is [MASK], and ``mask_ans`` holds there
    the label the MLM head must give ("true" for the answer's option and
    "false" for the others; a seeded word; the answer's digit), -1
    elsewhere. ``"caption"`` corrupts each caption as the JAX
    ``CaptionDataset`` does (``CAPTION_MASK_PROB``, at least one [MASK] a
    caption), ``mask_ans`` the original ids there and -1 elsewhere."""
    rs = np.random.RandomState(seed)
    o, x = cfg.size_option, cfg.size_txt
    per_clip = o if kind in ("mc", "mc_mlm") else 1
    txt = np.zeros((b * per_clip, x), np.int32)
    for row in txt:
        n = rs.randint(8, x + 1)
        row[:n] = rs.randint(1000, cfg.text.vocab_size, n)
        row[0], row[n - 1] = 101, 102
    img = rs.randint(0, 256, (b, cfg.size_frame, cfg.size_img, cfg.size_img, 3))
    ans = rs.randint(0, cfg.size_vocab if kind == "oe" else o, b)
    out = {"ans": ans}
    if kind in ("mc_mlm", "oe_mlm", "gen"):
        slot = (txt == 102).argmax(1) - 1
        txt[np.arange(len(txt)), slot] = MASK_ID
        label = (np.where(np.arange(o)[None] == ans[:, None], TRUE_ID, FALSE_ID).reshape(-1)
                 if kind == "mc_mlm" else np.array(DIGIT_IDS)[ans] if kind == "gen"
                 else rs.randint(1000, cfg.text.vocab_size, b))
        out["mask_ans"] = np.where(np.arange(x)[None] == slot[:, None], label[:, None], -1)
    if kind == "caption":
        n = (txt > 0).sum(1)
        inner = (np.arange(x)[None] >= 1) & (np.arange(x)[None] < n[:, None] - 1)
        pick = inner & (rs.rand(*txt.shape) < CAPTION_MASK_PROB)
        pick[np.arange(len(txt)), 1 + rs.randint(0, n - 2)] = True
        out["mask_ans"] = np.where(pick, txt, -1)
        txt[pick] = MASK_ID
    shape = (b, o, x) if per_clip > 1 else (b, x)
    out.update(img=img.astype(np.uint8), txt=txt, mask=(txt > 0).astype(np.int32))
    return {k: torch.from_numpy(v.reshape(shape) if k in ("txt", "mask", "mask_ans") else v)
            .to(device) for k, v in out.items()}


def fusion_shape(cfg, kind, b, prefix=0):
    """(rows, tokens, route) of a fine-tune batch's fusion: route ``lane``
    where ``lane_sa_attention_fits`` sends BERT to row 5, else ``tiled``."""
    rows = {"retrieval": b * b, "mc": b * cfg.size_option,
            "mc_mlm": b * cfg.size_option}.get(kind, b)
    frames = 1 if cfg.temporal_fusion == "mean" else cfg.size_frame
    tokens = frames * cfg.tokens_per_frame + cfg.size_txt + prefix
    fits = wa.lane_sa_attention_fits(rows, tokens, cfg.hidden_size,
                                     cfg.fusion.num_attention_heads)
    return rows, tokens, "lane" if fits else "tiled"


# the score head's output bias of the multiple-choice (ce over the options)
# and retrieval (nce, shift-invariant along rows and columns) steps: the
# same for every option or pair, so its gradient is zero in exact arithmetic
# (as VTM_OUT_BIAS)
SCORE_OUT_BIAS = "fc.3.bias"
# parameters that no step gives a gradient: the frame-order embedding, which
# no fine-tune forward reads, and the gumbel selection's projections, which
# reach the loss only through the comparison that makes the kept-token mask
# (as in JAX)
NO_GRAD = "emb_odr"            # EncVideo's enc_img.emb_odr, EncImgR50's enc_img.embeds.emb_odr
GUMBEL_NO_GRAD = {"vid_key.weight", "vid_query.weight"}


def finetune_phase(dev, name, config, run, model, loss_kind, kind, want_launches,
                   zero_ok=(), batches=None):
    """Phases 14, 26, 28, 30, 32 and 38: the ``loss_kind`` fine-tune step of
    ``model`` (bf16, full width) on a ``kind`` batch of the run's
    ``size_batch`` (or, with ``batches``, on each step's next batch of that
    iterator, the loader's), with the package's ``build_optimizer``. One warm-up
    step, then ``TRAIN_STEPS`` timed steps: items/s (clips for retrieval,
    captions for captioning, questions for QA; batch / step seconds) median
    and range, peak device memory, every loss finite, one more step's kernel
    time under the profiler and the device's idle share (1 - kernel time /
    median step time); the launches of the first timed step held to
    ``want_launches``; every parameter with a gradient changed (those in
    ``zero_ok`` may instead end with an all-zero gradient). Returns the
    launches and the trained model."""
    cfg = run.model
    b = run.train.size_batch
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
    state = create_train_state(model, opt)
    step = make_supervised_train_step(model, opt, loss_kind, run.train.temp)
    batch = synthetic_finetune_batch(kind, b, cfg, seed=6, device=dev)
    if batches is not None:
        batch = next(batches)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    t0 = time.perf_counter()
    state, ls = step(state, batch, TRAIN_SEED)             # warm-up: first launches, cuBLAS
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    losses = [ls["total"].item()]
    torch.cuda.reset_peak_memory_stats(dev)
    secs, launches = [], {}
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        if batches is not None:
            batch = next(batches)
        if i == 0:
            _build.launch_counts.clear()
        state, ls = step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(_build.launch_counts)
        losses.append(ls["total"].item())
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rate = [b / t for t in secs]
    unit = {"retrieval": "clips_per_s", "caption": "captions_per_s"}.get(kind,
                                                                        "questions_per_s")
    rows, tokens, route = fusion_shape(cfg, kind, b, batch["txt"].shape[-1] - cfg.size_txt)
    kernel_ms = _kernel_ms(_stepper(step, state, batch))
    STEP_MS[name] = float(np.median(secs)) * 1e3
    print(f"{name} train-step launch counts: {launches}", flush=True)
    print(json.dumps({
        "slice": f"{name}_train_step", "config": config.name, "model": type(model).__name__,
        "loss": loss_kind, "dtype": "bfloat16", "batch": b, "frames": cfg.size_frame,
        "size_img": cfg.size_img, "size_txt": cfg.size_txt,
        "batches": "loader" if batches is not None else "synthetic",
        "text_tokens": batch["txt"].shape[-1], "fusion_rows": rows,
        "fusion_tokens": tokens, "fusion_route": route, "steps": TRAIN_STEPS,
        "warmup_step_s": warm_s, unit: float(np.median(rate)), f"{unit}_range": [min(rate),
                                                                               max(rate)],
        "step_ms_median": float(np.median(secs)) * 1e3, "step_s_each": secs,
        "peak_mem_gib": peak, "losses_each_step": losses, "kernel_ms_one_step": kernel_ms,
        "device_idle_share": 1.0 - kernel_ms / (float(np.median(secs)) * 1e3)}), flush=True)
    require(launches == want_launches,
            f"launches of one {name} train step {launches}, not {want_launches}")
    require(all(np.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    no_grad = {n for n, p in state.params.items() if p.grad is None}
    want_no_grad = {n for n in state.params if n.endswith(NO_GRAD)} | (
        GUMBEL_NO_GRAD if hasattr(model, "vid_key") else set())
    require(no_grad == want_no_grad, f"parameters without a gradient: {sorted(no_grad)}")
    zero = {n for n, p in state.params.items() if n not in no_grad and not p.grad.any()}
    print(f"parameters whose last gradient is exactly 0: {sorted(zero)}", flush=True)
    require(zero <= set(zero_ok), f"all-zero last gradients: {sorted(zero - set(zero_ok))}")
    unchanged = [n for n, p in state.params.items()
                 if n not in no_grad | zero and torch.equal(before[n], p.detach())]
    require(not unchanged, f"parameters unchanged after {TRAIN_STEPS + 2} steps: {unchanged}")
    return launches, model


def eval_launches(train_launches):
    """The forward launches of a step: its kernels without the backwards,
    the attention without dropout."""
    return {k.replace("_dropout", ""): v for k, v in train_launches.items()
            if not k.endswith("_bwd")}


def finetune_eval_phase(dev, name, config, model, run, kind, metrics, want_shape,
                        train_launches, batches=FINETUNE_EVAL_BATCHES):
    """Phases 16, 26, 28 and 30: ``make_eval_step`` on ``batches`` seeded
    ``kind`` batches (one warm-up batch first), the logits finite and of
    ``want_shape``, and ``metrics(logits on the host, batch)`` (name ->
    value) averaged over them, as the JAX CLIs score a split; each batch
    launches the forwards of the step (``eval_launches(train_launches)``).
    Returns one batch's launches."""
    cfg = run.model
    b = run.train.size_batch
    eval_step = make_eval_step(model)
    data = [synthetic_finetune_batch(kind, b, cfg, seed=20 + i, device=dev)
            for i in range(batches + 1)]
    eval_step(data[0])
    torch.cuda.synchronize(dev)
    _build.launch_counts.clear()
    each, secs = [], []
    for batch in data[1:]:
        t0 = time.perf_counter()
        logits = eval_step(batch)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        require(tuple(logits.shape) == want_shape and bool(torch.isfinite(logits).all()),
                f"{name} eval logits {tuple(logits.shape)}, finite: "
                f"{bool(torch.isfinite(logits).all())}")
        each.append(metrics(logits.float().cpu().numpy(),
                            {k: v.cpu().numpy() for k, v in batch.items()}))
    launches = dict(_build.launch_counts)
    one = {k: v // batches for k, v in launches.items()}
    mean = {k: float(np.mean([e[k] for e in each])) for k in each[0]}
    rate = [b / t for t in secs]
    print(json.dumps({
        "slice": f"{name}_eval", "config": config.name, "dtype": "bfloat16", "batch": b,
        "batches": batches, "metrics": mean, "metrics_each": each,
        "items_per_s": float(np.median(rate)), "items_per_s_range": [min(rate), max(rate)],
        "launches": launches}), flush=True)
    require(launches == {k: v * batches for k, v in one.items()}
            and one == eval_launches(train_launches),
            f"launches of {batches} {name} evals {launches}")
    require(all(0.0 <= v <= 1.0 for v in mean.values()), f"{name} metrics {mean}")
    return one


def cut_finetune_config(cfg):
    """The whole-step checks' depth cut: swin depths (2, 2, 2, 2), 2 fusion
    layers, every dropout and drop-path rate 0, full widths."""
    return dataclasses.replace(
        cfg, swin_custom=dataclasses.replace(cfg.swin, depths=(2, 2, 2, 2), drop_path_rate=0.0),
        fusion=dataclasses.replace(cfg.fusion, num_hidden_layers=2, hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0),
        text=dataclasses.replace(cfg.text, hidden_dropout_prob=0.0))


def finetune_whole_step_phase(dev, name, run, build, loss_kind, kind, b=2, zero=None,
                              prefix=0, extra=None):
    """Phases 15, 27, 29, 31 and 33: one ``loss_kind`` step of a depth-cut copy
    (``cut_finetune_config``) built by ``build(cfg, dtype, device)``, ``b``
    clips of a ``kind`` batch (plus ``extra``, such as injected gumbel
    noise), card fp32 (kernels) against CPU fp32 (plain versions), held to
    ``WHOLE_STEP_TOL``; the fusion (``prefix`` tokens more) takes the same
    route as at full depth, its backward launched once a layer. ``zero``:
    parameter -> bound of the gradients that are zero in exact
    arithmetic."""
    cut = cut_finetune_config(run.model)
    rows, tokens, route = fusion_shape(cut, kind, b, prefix)
    require(route == fusion_shape(run.model, kind, run.train.size_batch, prefix)[2],
            f"the cut {name} fusion over {tokens} tokens routes to {route}")
    batch = {**synthetic_finetune_batch(kind, b, cut, seed=7, device="cpu"), **(extra or {})}
    card, cpu = build(cut, torch.float32, dev), build(cut, torch.float32, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    results, secs = {}, {}
    _build.launch_counts.clear()
    for side, model, device in (("card", card, dev), ("cpu", cpu, torch.device("cpu"))):
        if hasattr(model, "fc"):
            model.fc[0].p = 0.0             # the score head's dropout, fixed at 0.1
        opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
        step = make_supervised_train_step(model, opt, loss_kind, run.train.temp)
        t0 = time.perf_counter()
        _, ls = step(create_train_state(model, opt), {k: v.to(device) for k, v in batch.items()},
                     0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs[side] = time.perf_counter() - t0
        results[side] = _step_results(model, ls)
    bwd = "lane_self_attention_bwd" if route == "lane" else "packed_self_attention_bwd"
    require(_build.launch_counts[bwd] == cut.fusion.num_hidden_layers,
            f"the cut {name} card step's launches: {dict(_build.launch_counts)}")
    zero = zero or {}
    hold_card_against_cpu(results, secs, {
        "slice": name, "model": type(card).__name__, "loss": loss_kind,
        "swin_depths": list(cut.swin.depths), "fusion_layers": cut.fusion.num_hidden_layers,
        "batch": b, "fusion_rows": rows, "fusion_tokens": tokens, "fusion_route": route,
        "prefix_tokens": prefix,
        "zero_in_exact_arithmetic": {n: [results[k][1][n].abs().max().item()
                                         for k in ("card", "cpu")] for n in zero}},
        zero=zero)


def mc_phases(dev):
    """Phases 14-16, the multiple-choice QA fine-tune step at msrvtt-mc,
    its whole-step check and its eval. Returns the step's and one eval
    batch's launches."""
    # 14. the multiple-choice QA fine-tune step at full width (msrvtt-mc):
    # the fusion over 40 rows of 350 tokens on the tiled self-attention
    run_qamc = load_run_config(str(QAMC_CONFIG))
    ft = {}
    ft["train_step_qamc"], qamc_model = finetune_phase(
        dev, "qamc", QAMC_CONFIG, run_qamc,
        VioletQAMC(run_qamc.model, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED), "ce",
        "mc", TRAIN_QAMC_LAUNCHES, zero_ok={SCORE_OUT_BIAS})
    torch.cuda.empty_cache()

    # 15. the whole multiple-choice step, card fp32 against CPU fp32
    finetune_whole_step_phase(dev, "qamc", run_qamc,
                              lambda c, dt, d: VioletQAMC(c, dtype=dt, device=d, seed=1), "ce",
                              "mc", zero={SCORE_OUT_BIAS: ZERO_GRAD_ATOL})
    torch.cuda.empty_cache()

    # 16. the multiple-choice eval on the trained model
    ft["eval_qamc"] = finetune_eval_phase(
        dev, "qamc", QAMC_CONFIG, qamc_model, run_qamc, "mc",
        lambda lg, bt: {"accuracy": qamc_accuracy(lg, bt["ans"])},
        (run_qamc.train.size_batch, run_qamc.model.size_option), TRAIN_QAMC_LAUNCHES,
        batches=QAMC_EVAL_BATCHES)
    del qamc_model
    torch.cuda.empty_cache()
    return ft


def downstream_phases(dev):
    """Phases 26-31: the retrieval (``nce``), open-ended QA (``ce``,
    ``mlm``) and tgif-action multiple-choice (``mlm``, gumbel ``ce``)
    fine-tune steps at full width with their evals, and the whole-step
    checks of the nce, task-token and prompt mlm and gumbel ce steps.
    Returns each step's and one eval batch's launches."""
    ft = {}
    # 26. the retrieval fine-tune step (nce) at full width (msrvtt-retrieval:
    # 8 clips x 8 captions, 64 fusion rows of 275 on row 5 with dropout and
    # row 6), then the in-batch accuracy of the eval forward's scores
    run_ret = load_run_config(str(RET_CONFIG))
    b_ret = run_ret.train.size_batch
    ft["train_step_retrieval"], model = finetune_phase(
        dev, "retrieval", RET_CONFIG, run_ret,
        VioletRetrieval(run_ret.model, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED), "nce",
        "retrieval", TRAIN_RET_LAUNCHES, zero_ok={SCORE_OUT_BIAS})
    ft["eval_retrieval"] = finetune_eval_phase(
        dev, "retrieval", RET_CONFIG, model, run_ret, "retrieval",
        lambda s, bt: {"in_batch_accuracy": in_batch_retrieval_accuracy(s)}, (b_ret, b_ret),
        TRAIN_RET_LAUNCHES)
    del model
    torch.cuda.empty_cache()

    # 27. the whole nce step, card fp32 against CPU fp32
    finetune_whole_step_phase(dev, "retrieval", run_ret,
                              lambda c, dt, d: VioletRetrieval(c, dtype=dt, device=d, seed=1),
                              "nce", "retrieval", zero={SCORE_OUT_BIAS: NCE_ZERO_GRAD_ATOL})
    torch.cuda.empty_cache()

    # 28. open-ended QA at full width (msrvtt-qa: 10 questions, fusion rows of
    # 275 on row 5): the 1500-way answer head (ce) and the MLM head (mlm),
    # each step and its eval
    run_qaoe = load_run_config(str(QAOE_CONFIG))
    cfg_qaoe, b_qaoe = run_qaoe.model, run_qaoe.train.size_batch
    vocab = cfg_qaoe.fusion.vocab_size
    ft["train_step_qaoe"], model = finetune_phase(
        dev, "qaoe", QAOE_CONFIG, run_qaoe,
        VioletQAOE(cfg_qaoe, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED), "ce", "oe",
        TRAIN_QAOE_LAUNCHES)
    ft["eval_qaoe"] = finetune_eval_phase(
        dev, "qaoe", QAOE_CONFIG, model, run_qaoe, "oe",
        lambda lg, bt: {"accuracy": masked_accuracy(torch.from_numpy(lg.argmax(-1)),
                                                    torch.from_numpy(bt["ans"])).item()},
        (b_qaoe, cfg_qaoe.size_vocab), TRAIN_QAOE_LAUNCHES)
    del model
    torch.cuda.empty_cache()
    ft["train_step_qaoe_mlm"], model = finetune_phase(
        dev, "qaoe_mlm", QAOE_CONFIG, run_qaoe,
        VioletQAOEMLMHead(cfg_qaoe, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED), "mlm",
        "oe_mlm", TRAIN_QAOE_MLM_LAUNCHES)
    ft["eval_qaoe_mlm"] = finetune_eval_phase(
        dev, "qaoe_mlm", QAOE_CONFIG, model, run_qaoe, "oe_mlm",
        lambda lg, bt: {f"top{k}": float(np.mean(qaoe_mlm_topk(lg, bt["mask_ans"], k)))
                        for k in (1, 5)},
        (b_qaoe, cfg_qaoe.size_txt, vocab), TRAIN_QAOE_MLM_LAUNCHES)
    del model
    torch.cuda.empty_cache()

    # 29. the whole mlm step of the open-ended MLM head with its task token,
    # then with a prompt of PROMPT_LEN tokens, card fp32 against CPU fp32
    run_tt = dataclasses.replace(run_qaoe, model=dataclasses.replace(
        cfg_qaoe, enable_task_token=True, task_token="oe"))
    finetune_whole_step_phase(dev, "qaoe_mlm_task_token", run_tt,
                              lambda c, dt, d: VioletQAOEMLMHead(c, dtype=dt, device=d, seed=1),
                              "mlm", "oe_mlm", prefix=1)
    prompt = np.random.RandomState(9).randint(1000, vocab, PROMPT_LEN)
    prompt[0], prompt[-1] = 101, 102
    run_pr = dataclasses.replace(run_qaoe, model=dataclasses.replace(cfg_qaoe,
                                                                     enable_prompt=True))
    finetune_whole_step_phase(
        dev, "qaoe_mlm_prompt", run_pr,
        lambda c, dt, d: VioletQAOEMLMHead(c, dtype=dt, device=d, seed=1,
                                           prompt_tokens=tuple(int(t) for t in prompt)),
        "mlm", "oe_mlm", prefix=PROMPT_LEN)
    torch.cuda.empty_cache()

    # 30. multiple choice at full width (tgif-action): the generative head
    # (8 rows of 350) and the MLM head (40 rows of 350) on mlm, and the
    # gumbel video-token selection on ce, each step and its eval
    run_mc = load_run_config(str(QAMC_GEN_CONFIG))
    cfg_mc, b_mc = run_mc.model, run_mc.train.size_batch
    digits = DIGIT_IDS[:cfg_mc.size_option]
    for name, build, loss, kind, want, metrics, shape in (
            ("qamc_gen", VioletQAMCGen, "mlm", "gen", TRAIN_QAMC_MLM_LAUNCHES,
             lambda lg, bt: {"accuracy": float(np.mean(qamc_gen_accuracy(
                 lg, bt["txt"], MASK_ID, digits, bt["ans"])))},
             (b_mc, cfg_mc.size_txt, vocab)),
            ("qamc_mlm", VioletQAMCMLMHead, "mlm", "mc_mlm", TRAIN_QAMC_MLM_LAUNCHES,
             lambda lg, bt: {"accuracy": float(np.mean(qamc_mlm_head_accuracy(
                 lg, bt["mask_ans"], TRUE_ID, FALSE_ID)))},
             (b_mc, cfg_mc.size_option, cfg_mc.size_txt, vocab)),
            ("qamc_gumbel", functools.partial(VioletQAMC, num_video_tokens=GUMBEL_TOKENS), "ce",
             "mc", TRAIN_QAMC_GUMBEL_LAUNCHES,
             lambda lg, bt: {"accuracy": qamc_accuracy(lg, bt["ans"])},
             (b_mc, cfg_mc.size_option))):
        ft[f"train_step_{name}"], model = finetune_phase(
            dev, name, QAMC_GEN_CONFIG, run_mc,
            build(cfg_mc, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED), loss, kind, want,
            zero_ok={SCORE_OUT_BIAS} if loss == "ce" else ())
        ft[f"eval_{name}"] = finetune_eval_phase(dev, name, QAMC_GEN_CONFIG, model, run_mc,
                                                 kind, metrics, shape, want)
        del model
        torch.cuda.empty_cache()

    # 31. the whole gumbel ce step with the same injected noise on both sides,
    # card fp32 against CPU fp32
    noise = draw_gumbel((2, GUMBEL_TOKENS, cfg_mc.size_frame * cfg_mc.tokens_per_frame),
                        torch.Generator().manual_seed(8))
    finetune_whole_step_phase(
        dev, "qamc_gumbel", run_mc,
        lambda c, dt, d: VioletQAMC(c, dtype=dt, device=d, seed=1,
                                    num_video_tokens=GUMBEL_TOKENS),
        "ce", "mc", zero={SCORE_OUT_BIAS: ZERO_GRAD_ATOL}, extra={"gumbel_noise": noise})
    torch.cuda.empty_cache()
    return ft


def caption_words(row, model):
    """A caption's tokens after [CLS] up to [SEP] or [PAD], each id written
    as a word (the port has no tokenizer yet; the JAX CLI detokenizes)."""
    words = []
    for t in row[1:].tolist():
        if t in (model.sep_token_id, model.pad_token_id):
            break
        words.append(f"w{t}")
    return " ".join(words)


def host_syncs(fn):
    """The operations of one call of ``fn`` at which this thread waits for
    the card (``torch.cuda.set_sync_debug_mode("warn")``'s warnings; those of
    other threads, such as a loader's producer, are not counted)."""
    me = threading.get_ident()
    caught = []

    def show(message, *args, **kwargs):
        if threading.get_ident() == me:
            caught.append(str(message))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [m for m in caught if "called a synchronizing CUDA operation" in m]


def generation_phase(dev, model, run):
    """Phase 34: the decoders of ``model`` (bf16, the caption step's) on the
    run's batch of seeded clips at ``GEN_MAX_LEN``, each through the capbench
    tool's ``bench`` (``GEN_ITERS`` timed calls after a warm-up call):
    re-encoding greedy, cached greedy, beam search (``GEN_BEAM``) and top-k
    sampling (re-encoding); captions/s, and the kernel time of one more call
    under the profiler with the device's idle share; the launches of one
    call of each held to ``generate_launches``; no call waits on the card
    (``host_syncs``: no position reads a token back); each caption [CLS]
    first and [PAD] after [SEP]. The share of greedy tokens the two greedy decoders agree on in bf16 is
    printed; in fp32 (the same weights) they must agree, or first differ
    where the top two logits lie within ``GREEDY_TIE_MARGIN``.
    ``caption_scores`` of the greedy captions against two seeded references
    a clip must be finite and non-negative. Returns each decoder's
    launches."""
    cfg = run.model
    b = run.train.size_batch
    rs = np.random.RandomState(12)
    img = torch.from_numpy(rs.randint(0, 256, (b, cfg.size_frame, cfg.size_img, cfg.size_img,
                                               3)).astype(np.uint8)).to(dev)
    recs, tokens, launches = [], {}, {}
    for name, mode, kw in (("uncached", "full", {}), ("cached", "cached", {}),
                           ("beam", "full", {"beam_size": GEN_BEAM}),
                           ("sample", "full", {"decode": "sample", "top_k": GEN_TOP_K})):
        rec, t = capbench.bench(model, img, mode, GEN_ITERS, max_len=GEN_MAX_LEN, **kw)
        fn = capbench.decoder(model, mode, max_len=GEN_MAX_LEN, **kw)
        rec["kernel_ms_one_call"] = _kernel_ms(lambda: (fn(img), torch.cuda.synchronize(dev)))
        rec["device_idle_share"] = 1.0 - rec["kernel_ms_one_call"] / rec["ms_per_batch"]
        rec["host_syncs"] = host_syncs(lambda: fn(img))
        recs.append(rec)
        require(not rec["host_syncs"],
                f"the {name} decoder waits on the card: {rec['host_syncs']}")
        tokens[name], launches[f"generate_{name}"] = t, rec["launches"]
        want = generate_launches(mode == "cached")
        require(rec["launches"] == want,
                f"launches of one {name} decode {rec['launches']}, not {want}")
        ended = (t == model.sep_token_id).cumsum(1) > 0
        require(t.shape == (b, GEN_MAX_LEN) and bool((t[:, 0] == model.cls_token_id).all())
                and bool(((t >= 0) & (t < cfg.fusion.vocab_size)).all())
                and bool((t[ended & (t != model.sep_token_id)] == model.pad_token_id).all()),
                f"{name} captions: {t.tolist()}")
    bf16_same = (tokens["uncached"] == tokens["cached"]).float().mean().item()
    m32 = VioletCaptioning(cfg, dtype=torch.float32, device=dev)
    m32.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    full32 = m32.generate(img, GEN_MAX_LEN).cpu()
    cached32 = m32.generate_cached(img, GEN_MAX_LEN).cpu()
    diff = capbench.first_difference_margin(m32, img, full32, cached32)
    fp32_s = time.perf_counter() - t0
    del m32
    vocab = cfg.fusion.vocab_size
    refs = {f"v{i}": [" ".join(f"w{t}" for t in rs.randint(1000, vocab, rs.randint(6, 16)))
                      for _ in range(2)] for i in range(b)}
    hyps = {f"v{i}": caption_words(row, model) for i, row in enumerate(tokens["uncached"])}
    scores = caption_scores(hyps, refs)
    print(json.dumps({
        "slice": "caption_generation", "config": CAPTION_CONFIG.name, "dtype": "bfloat16",
        "batch": b, "max_len": GEN_MAX_LEN, "fusion_tokens": cfg.size_frame
        * cfg.tokens_per_frame + GEN_MAX_LEN, "records": recs,
        "bf16_identical_token_share": bf16_same, "fp32_identical": diff is None,
        "fp32_first_difference": diff, "tie_margin_limit": GREEDY_TIE_MARGIN,
        "fp32_check_s": fp32_s, "caption_scores": scores, "captions": hyps}), flush=True)
    require(diff is None or diff["margin"] < GREEDY_TIE_MARGIN,
            f"fp32 greedy decoders differ beyond a tie: {diff}")
    require(all(np.isfinite(v) and v >= 0 for v in scores.values()), f"caption scores {scores}")
    return launches


def caption_phases(dev):
    """Phases 32-34: the caption fine-tune step at configs/caption.json's
    full width, its whole-step check, and the decoders on the trained
    model. Returns the step's and each decoder's launches."""
    run = load_run_config(str(CAPTION_CONFIG))
    launches = {}
    # 32. the caption step: 8 rows of 275 under the seq2seq mask on rows 5-6
    launches["train_step_caption"], model = finetune_phase(
        dev, "caption", CAPTION_CONFIG, run,
        VioletCaptioning(run.model, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED),
        "caption", "caption", CAPTION_LAUNCHES)
    torch.cuda.empty_cache()

    # 33. the whole caption step, card fp32 against CPU fp32
    finetune_whole_step_phase(dev, "caption", run,
                              lambda c, dt, d: VioletCaptioning(c, dtype=dt, device=d, seed=1),
                              "caption", "caption")
    torch.cuda.empty_cache()

    # 34. the decoders: re-encoding and cached greedy, beam search, top-k
    launches.update(generation_phase(dev, model, run))
    del model
    torch.cuda.empty_cache()
    return launches


def with_pretrain_tasks(run, tasks):
    """``run`` with ``train.pretrain_tasks`` replaced."""
    return dataclasses.replace(run, train=dataclasses.replace(run.train, pretrain_tasks=tasks))


# ---------------------------------------------------------------------------
# phases 36-38: the data layer (TSV readers, nvJPEG, the transform plans and
# their executor, the loaders) feeding the steps

LOADER_STEPS = 12                 # loader-fed pretrain steps timed (phase 37)
LOADER_ALONE_BATCHES = 20         # batches of the loader alone (phase 37)
DECODE_REPS = 10                  # timed decode calls (phase 36)
WHOLE_LOADER_B = 4                # rows of the loader batch held card against CPU


def seeded_biases(model, seed, std=0.02):
    """Add seeded N(0, std) to every bias of ``model``, as a trained model
    has them. ``init_weights`` zeroes the biases, and with zero biases a
    corrupt row's zeroed clip stays exactly zero through the whole Video
    Swin: every LayerNorm there then sees zero variance and scales its
    backward by 1 / sqrt(eps) (about 316), the true gradient, which
    overflows fp32 at full depth. The JAX package computes the same
    gradient at its own init: ``tests/test_torch_loader_step.py``
    ``test_zero_biases_and_a_corrupt_row_blow_up_both_packages_gradients``
    reads 5e32 in both at depths (1, 1, 1, 1), against 1e4 without the
    flag. A fault of the reference that the port keeps (ROADMAP Queue 3)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=gen).to(p) * std)


def _data_dir(name):
    """A fresh directory under build/ for the layouts a phase writes."""
    path = _build.BUILD_DIR / "smoke_data" / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def decode_phase(dev):
    """Phase 36: nvJPEG (``data/jpeg.py``) on the committed fixture against
    cv2's decode of it, within the fixture's limits (``limit_max_abs``,
    ``limit_mean_abs``: the IDCT's rounding and the 4:2:0 chroma
    upsampling, measured where the fixture was made); its time a frame and
    a batch of 80; the transform executor on the card against the same
    executor on the CPU on the same decoded frames, for every transform at
    the pretrain size (crops and pads exact, resizes within one uint8
    step); and a frame that fails to decode marking its item corrupt."""
    fx = load_fixture()
    frames, ref = fx["frames"], fx["decode"]
    sizes = [jpeg_size(f) for f in frames]
    dec = NvJpegDecoder(dev)
    out = dec.decode(frames, sizes)
    torch.cuda.synchronize(dev)
    diffs = [np.abs(o.cpu().numpy().astype(np.int16) - r) for o, r in zip(out, ref)]
    max_abs = [int(d.max()) for d in diffs]
    mean_abs = [float(d.mean()) for d in diffs]
    times = {}
    for n in (len(frames), TRAIN_B * TRAIN_T):
        fr = (frames * (n // len(frames) + 1))[:n]
        dec.decode(fr, [sizes[0]] * n)
        torch.cuda.synchronize(dev)
        ts = []
        for _ in range(DECODE_REPS):
            t0 = time.perf_counter()
            dec.decode(fr, [sizes[0]] * n)
            torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - t0)
        times[n] = float(np.median(ts)) * 1e3
    # the executor: card against CPU on the same decoded frames
    cpu_frames = [torch.from_numpy(r) for r in ref]
    card_frames = [f.to(dev) for f in cpu_frames]
    execs = {}
    rng = random.Random(0)
    h, w = sizes[0]
    plans = {t: plan_clip(frames, sizes, 224, "train", t, rng, False) for t in TRANSFORMS}
    plans["crop only"] = ClipPlan(tuple(frames), (FramePlan((h, w), (0, 0, 0, 0), (h, w),
                                                            (16, 58, 224, 224)),) * len(frames),
                                  (len(frames), 224, 224), False)
    plans["pad only"] = ClipPlan(tuple(frames), (FramePlan((h, w), (42, 42, 0, 0), (w, w),
                                                           (0, 0, w, w)),) * len(frames),
                                 (len(frames), w, w), False)
    for name, plan in plans.items():
        a = run_plans([plan], [card_frames], dev)[0].cpu()
        c = run_plans([plan], [cpu_frames], "cpu")[0]
        d = (a.int() - c.int()).abs()
        exact = plan.ops[0].size == plan.ops[0].src or name == "pad only"
        execs[name] = {"max_abs": int(d.max()), "share_differing": float((d > 0).float().mean()),
                       "resized": not exact}
        require(d.max() <= (0 if exact else 1),
                f"transform {name}: card against CPU differs by {int(d.max())}")
    # a frame whose header parses but whose decode fails
    sof = frames[0].index(b"\xff\xc0")
    cut = frames[0][:sof + 2 + int.from_bytes(frames[0][sof + 2:sof + 4], "big")]
    good = plan_clip(frames[:2], sizes[:2], 224, "train", "img_rand_crop", rng, False)
    bad = dataclasses.replace(good, frames=(frames[0], cut))
    mat = materialize({"img": [good, bad]}, dec, dev)
    corrupt = mat["corrupt"].tolist()
    require(corrupt == [False, True] and not mat["img"][1].any(),
            f"a failed decode: corrupt {corrupt}")
    info = {"phase": "decode", "route": "nvjpeg", "nvjpeg_libraries": nvjpeg_libraries(),
            "reference": "cv2 decode of the fixture",
            "frames": len(frames), "frame_hw": list(sizes[0]),
            "max_abs_each": max_abs, "mean_abs_each": mean_abs,
            "limit_max_abs": fx["limit_max_abs"], "limit_mean_abs": fx["limit_mean_abs"],
            "decode_ms_per_call": {str(n): t for n, t in times.items()},
            "decode_ms_per_frame": times[TRAIN_B * TRAIN_T] / (TRAIN_B * TRAIN_T),
            "executor_card_vs_cpu": execs, "failed_decode_corrupt": corrupt}
    print(json.dumps(info), flush=True)
    require(max(max_abs) <= fx["limit_max_abs"] and max(mean_abs) <= fx["limit_mean_abs"],
            f"nvJPEG against cv2: max {max(max_abs)}, mean {max(mean_abs):.3f} over the "
            f"limits {fx['limit_max_abs']}, {fx['limit_mean_abs']:.3f}")
    dec.close()


def loader_pretrain_phase(dev, run, synthetic):
    """Phase 37: the pixel step at full width fed by ``MetaLoader`` over the
    webvid2.5m shards and cc3m (``tools/loaderbench.py`` writes them from
    the fixture; ``pretrain_meta_loader`` wires them as the JAX pretrain
    CLI does) through ``DevicePrefetcher`` (nvJPEG and the transforms on a
    side stream). First the loader alone (clips/s); then, on a model whose
    biases are seeded (``seeded_biases``), warm-up steps and
    ``LOADER_STEPS`` timed steps, each from fetching its batch to the
    synchronise after it: wall ms by dataset, against phase 6's
    ``synthetic`` wall time on its synthetic batch, every loss finite, the
    first 4-frame step's launches held to ``TRAIN_LAUNCHES``, the kernel
    time of one 4-frame and one 1-frame step under the profiler and the
    device's idle share. The shards hold every timed batch within one
    epoch (``shard_rows``), and warm-up steps run until every loader has
    delivered, so no producer starts cold inside the timing. Then a webvid
    (T = 4) and a cc3m (T = 1) batch's first rows, a corrupt one among
    them, are held card fp32 against CPU fp32 on a depth-cut copy
    (``whole_step_phase``). Returns the launches of that 4-frame step."""
    data_dir = _data_dir("pretrain")
    rows = shard_rows(TRAIN_B, LOADER_ALONE_BATCHES)
    build_pretrain(data_dir, videos_per_part=rows, images=rows)
    run_l = with_data(run, data_dir=data_dir)
    tokzr = load_tokenizer()
    meta = pretrain_meta_loader(run_l, tokzr)
    alone = loader_clips_per_s(DevicePrefetcher(meta, dev), LOADER_ALONE_BATCHES)
    meta.close()
    require(alone["epoch_restarts"] == 0,
            f"the loader alone crossed {alone['epoch_restarts']} epochs")
    model = VioletPretrain.from_run_config(run, dtype=torch.bfloat16, device=dev,
                                           seed=TRAIN_SEED)
    seeded_biases(model, TRAIN_SEED)
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
    state = create_train_state(model, opt)
    step = make_pretrain_train_step(model, opt)
    meta = pretrain_meta_loader(run_l, tokzr)
    batches = iter(DevicePrefetcher(meta, dev))
    left = set(meta.loaders)
    while left:     # warm-up: every loader's producer, both clip lengths' first launches
        tag, batch = next(batches)
        state, ls = step(state, batch, TRAIN_SEED)
        left.discard(tag)
    torch.cuda.synchronize(dev)
    secs, tags, losses, corrupt_rows, launches = [], [], [], 0, None
    kept = {}
    for _ in range(LOADER_STEPS):
        t0 = time.perf_counter()
        tag, batch = next(batches)
        four = batch["img"].shape[1] == run.model.size_frame
        if four and launches is None:
            _build.launch_counts.clear()
        state, ls = step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        if four and launches is None:
            launches = dict(_build.launch_counts)
        tags.append(tag)
        losses.append({k: v.item() for k, v in ls.items()})
        corrupt_rows += int(batch["corrupt"].sum())
        t = batch["img"].shape[1]
        if t not in kept or (batch["corrupt"].any() and not kept[t]["corrupt"].any()):
            kept[t] = batch
    batches.close()
    meta.close()
    restarts = sum(ld.epoch for ld in meta.loaders.values())
    by = {}
    for tag, sec in zip(tags, secs):
        by.setdefault(tag.split("/")[0], []).append(sec * 1e3)
    kernel_ms = {f"T={t}": _kernel_ms(_stepper(step, state, b)) for t, b in kept.items()}
    webvid_ms = float(np.median(by.get("webvid2.5m", [float("nan")])))
    STEP_MS["loader_pretrain_webvid"] = webvid_ms
    info = {
        "slice": "loader_pretrain_train_step", "config": PRETRAIN_CONFIG.name,
        "dtype": "bfloat16", "batch": run.train.size_batch, "steps": LOADER_STEPS,
        "datasets_each_step": tags, "step_ms_each": [t * 1e3 for t in secs],
        "step_ms_median_by_dataset": {k: float(np.median(v)) for k, v in by.items()},
        "synthetic_step_ms_median": synthetic["step_ms_median"],
        "loader_over_synthetic": webvid_ms / synthetic["step_ms_median"],
        "synthetic_kernel_ms": synthetic["kernel_ms"], "kernel_ms_one_step": kernel_ms,
        "device_idle_share_webvid": 1.0 - kernel_ms[f"T={run.model.size_frame}"] / webvid_ms,
        "loader_alone": alone, "corrupt_rows_seen": corrupt_rows,
        "shard_rows": rows, "epoch_restarts": restarts,
        "nvjpeg_frames": jpeg_decode_counts["nvjpeg_frames"], "losses_each_step": losses}
    print(f"loader-fed train-step launch counts: {launches}", flush=True)
    print(json.dumps(info), flush=True)
    require(launches == TRAIN_LAUNCHES,
            f"launches of one loader-fed 4-frame step {launches}, not {TRAIN_LAUNCHES}")
    require(set(by) == {"webvid2.5m", "cc3m"}, f"datasets stepped: {sorted(by)}")
    require(restarts == 0, f"the loader-fed steps crossed {restarts} epochs")
    for i, step_ls in enumerate(losses):
        require(all(np.isfinite(v) for v in step_ls.values()),
                f"non-finite loss at loader-fed step {i}: {step_ls}")
    del model, opt, state, step
    torch.cuda.empty_cache()
    for t, b in sorted(kept.items(), reverse=True):
        bad = b["corrupt"].nonzero().flatten().tolist()
        require(bool(bad), f"no {t}-frame loader batch held a corrupt row")
        pick = [bad[0]] + [i for i in range(len(b["corrupt"])) if i != bad[0]][
            :WHOLE_LOADER_B - 1]
        whole_step_phase(dev, run, batch={k: b[k][pick].cpu() for k in (
            "img", "txt", "mask", "corrupt")}, biased=True)
        torch.cuda.empty_cache()
    return launches


def loader_finetune_phases(dev):
    """Phase 38: the retrieval ``nce`` (msrvtt-retrieval), open-ended QA
    ``mlm`` (msrvtt-qa: rows of size_txt + 5 with "answer: [MASK]") and
    generative multiple-choice ``mlm`` (tgif-action: the options in the
    prompt, rows of size_txt + 3) fine-tune steps at full width, as phase
    14, each fed by its dataset (``tools/loaderbench.py`` layouts) through
    ``DevicePrefetcher``; each step's fusion route and launches printed.
    The datasets hold the warm-up and timed batches within one epoch
    (``shard_rows`` videos), so no producer starts cold inside the timing.
    Returns each step's launches."""
    data_dir = _data_dir("downstream")
    build_downstream(data_dir, videos=shard_rows(QAOE_B, TRAIN_STEPS))
    tokzr = load_tokenizer()
    launches = {}
    for name, config, kind, shape_kind, build, loss, want, zero_ok in (
            ("retrieval", RET_CONFIG, "retrieval", "retrieval", VioletRetrieval, "nce",
             TRAIN_RET_LAUNCHES, {SCORE_OUT_BIAS}),
            ("qaoe_mlm", QAOE_CONFIG, "qaoe-mlm", "oe_mlm", VioletQAOEMLMHead, "mlm",
             TRAIN_QAOE_MLM_LAUNCHES, ()),
            ("qamc_gen", QAMC_GEN_CONFIG, "qamc-gen", "gen", VioletQAMCGen, "mlm",
             TRAIN_QAMC_MLM_LAUNCHES, ())):
        run = with_data(load_run_config(str(config)), data_dir=data_dir)
        ds = downstream_dataset(run, kind, tokzr)
        meta = MetaLoader({name: (ShardedBatchLoader(
            ds, run.train.size_batch, shuffle=True, seed=run.train.seed,
            num_threads=run.data.n_workers), 1)}, seed=run.train.seed)
        batches = (b for _, b in DevicePrefetcher(meta, dev))
        model = build(run.model, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED)
        launches[f"loader_train_step_{name}"], _ = finetune_phase(
            dev, f"loader_{name}", config, run, model, loss, shape_kind, want,
            zero_ok=zero_ok, batches=batches)
        batches.close()
        meta.close()
        restarts = sum(ld.epoch for ld in meta.loaders.values())
        require(restarts == 0, f"the loader-fed {name} steps crossed {restarts} epochs")
        del model
        torch.cuda.empty_cache()
    return launches


# phases 39-40: checkpoints, the run loop and the task CLIs

CLI_PRETRAIN_ROWS = 60     # rows a pretrain shard: 3 batches of 20 each, 9 steps an epoch
CLI_VIDEOS = 80            # downstream videos: 10 retrieval / MC / caption steps, 8 QA-OE
CLI_TEST = 16              # the test split's items (the two-stage eval's captions)
CLI_SYNC_STEP = 2          # the step whose host waits are counted (no logging step)
CLI_PROFILE_STEP = 3       # the step whose kernels are timed under the profiler
STEP_MS = {}               # the hand-wired loops' median wall ms a step, by phase name


def _files_mib(path):
    return Path(path).stat().st_size / 2 ** 20


def _same_state(a, b):
    """Names of the leaves of two state_dicts that are not bit-equal."""
    return sorted(k for k in a if k not in b or a[k].dtype != b[k].dtype
                  or not torch.equal(a[k].to(b[k].device), b[k]))


def checkpoint_phase(dev, run):
    """Phase 39: the pretrain model of ``configs/pretrain.json`` (Swin-base,
    BERT-base, ``fc``, ``fc_mtm``, ``decoder_pixel``; bf16) through
    ``save_params`` to ``.msgpack`` and ``.npz`` and back through
    ``load_params`` into a model built from another seed, leaf for leaf
    bit-equal on the card; a reference-layout ``.pt`` (``torch.save`` of
    ``{"model": {"module." + k: v}}`` with an ``emb_len`` two frames longer
    than ``max_size_frame``) through ``load_torch_violet_ckpt``; and
    ``save_train_state`` after one step, then a second step, then
    ``load_train_state`` and the second step again: its losses within
    ``WHOLE_STEP_TOL`` of the uninterrupted run's. Prints each file's size
    and its save and load seconds. Returns the ``.pt``'s path (phase 40
    converts it)."""
    out = Path(_data_dir("checkpoints"))
    model = VioletPretrain.from_run_config(run, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED)
    seeded_biases(model, TRAIN_SEED)
    want = model.state_dict()
    info = {"phase": "checkpoints", "config": PRETRAIN_CONFIG.name,
            "leaves": len(want), "params": sum(v.numel() for v in want.values())}
    for suffix in (".msgpack", ".npz"):
        path = out / f"pretrain{suffix}"
        t0 = time.perf_counter()
        save_params(model, str(path), meta={"phase": 39})
        t1 = time.perf_counter()
        sd = load_params(str(path))
        other = VioletPretrain.from_run_config(run, dtype=torch.bfloat16, device=dev, seed=1)
        other.load_state_dict(sd)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        bad = _same_state(want, other.state_dict())
        info[suffix[1:]] = {"mib": _files_mib(path), "save_s": t1 - t0, "load_s": t2 - t1,
                            "leaves_differing": len(bad)}
        require(not bad, f"{suffix} round trip: {len(bad)} leaves differ, e.g. {bad[:3]}")
        del other, sd
    # a reference-layout .pt: trainer-wrapped, DDP prefix, a longer emb_len
    ref = {k: v.detach().cpu() for k, v in want.items()}
    d = ref["enc_img.emb_len"].shape[-1]
    ref["enc_img.emb_len"] = torch.randn(1, run.model.max_size_frame + 2, 1, d,
                                         generator=torch.Generator().manual_seed(3))
    pt = out / "ckpt_violet_reference.pt"
    t0 = time.perf_counter()
    torch.save({"model": {f"module.{k}": v for k, v in ref.items()}}, pt)
    t1 = time.perf_counter()
    sd = load_torch_violet_ckpt(str(pt), run.model, expected=want)
    t2 = time.perf_counter()
    ref["enc_img.emb_len"] = ref["enc_img.emb_len"][:, :run.model.max_size_frame]
    bad = _same_state(ref, sd)
    info["pt"] = {"mib": _files_mib(pt), "save_s": t1 - t0, "load_s": t2 - t1,
                  "leaves_differing": len(bad), "leaves": len(sd)}
    require(not bad and set(sd) == set(want), f".pt load: {len(bad)} leaves differ, {bad[:3]}")
    # resume: the second step after a restore against the uninterrupted one
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
    state = create_train_state(model, opt)
    step = make_pretrain_train_step(model, opt)
    batches = [synthetic_pretrain_batch(run.train.size_batch, run.model, seed=s, device=dev)
               for s in (11, 12)]
    state, _ = step(state, batches[0], TRAIN_SEED)
    path = out / "restore.state"
    t0 = time.perf_counter()
    save_train_state(state, str(path))
    t1 = time.perf_counter()
    state, ls = step(state, batches[1], TRAIN_SEED)
    through = {k: v.item() for k, v in ls.items()}
    t2 = time.perf_counter()
    state = load_train_state(str(path), state)
    torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    require(state.step == 1, f"restored step {state.step}")
    state, ls = step(state, batches[1], TRAIN_SEED)
    resumed = {k: v.item() for k, v in ls.items()}
    info["train_state"] = {"mib": _files_mib(path), "save_s": t1 - t0, "load_s": t3 - t2,
                           "losses_uninterrupted": through, "losses_resumed": resumed}
    print(json.dumps(info), flush=True)
    for k, v in through.items():
        require(abs(resumed[k] - v) <= WHOLE_STEP_TOL["loss_rtol"] * max(abs(v), 1e-6),
                f"resumed step loss {k}: {resumed[k]} against {v}")
    del model, opt, state, step, want
    torch.cuda.empty_cache()
    return str(pt)


class StepProbe:
    """Wraps the step a CLI's agent builds (``train/agent.py`` takes it from
    ``make_pretrain_train_step`` / ``make_supervised_train_step``, which
    ``probe_steps`` replaces while the CLI runs): each step's start on the
    host clock (no synchronise: the loop as it runs), the launches of the
    first step after the first (with ``frames``, the first of that clip
    length), the host waits of step ``CLI_SYNC_STEP`` on this thread
    (``host_syncs``), and step ``CLI_PROFILE_STEP``'s kernel time under the
    profiler (synchronised, so it and the step after it leave the wall
    median)."""

    def __init__(self, frames=None):
        self.frames = frames
        self.starts, self.launches, self.syncs, self.kernel_ms = [], None, None, None

    def wrap(self, make):
        def build(*args, **kwargs):
            step = make(*args, **kwargs)

            def probed(state, batch, seed):
                i = len(self.starts)
                self.starts.append(time.perf_counter())
                count = self.launches is None and i >= 1 and (
                    self.frames is None or batch["img"].shape[1] == self.frames)
                if count:
                    _build.launch_counts.clear()
                out = []
                if i == CLI_SYNC_STEP:
                    self.syncs = host_syncs(lambda: out.append(step(state, batch, seed)))
                elif i == CLI_PROFILE_STEP:
                    self.kernel_ms = _kernel_ms(lambda: (out.append(step(state, batch, seed)),
                                                         torch.cuda.synchronize()))
                else:
                    out.append(step(state, batch, seed))
                if count:
                    self.launches = dict(_build.launch_counts)
                return out[0]

            return probed

        return build

    def wall_ms(self, skip=()):
        """Median ms between consecutive step starts, leaving out the first
        step, the profiled one and the one after it, and the steps in
        ``skip`` (those an eval or a save follows)."""
        left = {0, CLI_PROFILE_STEP, CLI_PROFILE_STEP + 1, *skip}
        gaps = [(b - a) * 1e3 for i, (a, b) in enumerate(zip(self.starts, self.starts[1:]))
                if i not in left]
        return float(np.median(gaps)) if gaps else float("nan")


@contextlib.contextmanager
def probe_steps(probe):
    saved = agent_module.make_pretrain_train_step, agent_module.make_supervised_train_step
    agent_module.make_pretrain_train_step = probe.wrap(saved[0])
    agent_module.make_supervised_train_step = probe.wrap(saved[1])
    try:
        yield probe
    finally:
        agent_module.make_pretrain_train_step, agent_module.make_supervised_train_step = saved


def _cli_config(src, name, **changes):
    """A copy of the shipped config ``src`` with ``changes`` (the data
    directory a user points it at), under ``name``."""
    raw = json.loads(Path(src).read_text())
    raw.update(changes)
    path = Path(_build.BUILD_DIR) / "smoke_data" / f"{name}.json"
    path.write_text(json.dumps(raw))
    return str(path)


def _cli_step_line(name, res, probe, want, hand_ms, hand_name, skip=()):
    wall = probe.wall_ms(skip)
    line = {"cli": name, "steps": len(probe.starts), "step_ms_median": wall,
            "hand_wired_step_ms": hand_ms, "hand_wired": hand_name,
            "kernel_ms_one_step": probe.kernel_ms,
            "device_idle_share": 1.0 - probe.kernel_ms / wall,
            "host_syncs_non_logging_step": len(probe.syncs), "launches": probe.launches,
            "run_dir": res["run_dir"]}
    print(json.dumps(line), flush=True)
    require(probe.syncs == [], f"{name}: host waits on step {CLI_SYNC_STEP}: {probe.syncs[:3]}")
    require(probe.launches == want, f"{name}: launches of a step {probe.launches}, not {want}")
    return probe.launches


def _load_complete(name, report):
    trunk = ("enc_img", "enc_txt", "trsfr")
    loaded = [p for p in report["loaded"] if p.split(".")[0] in trunk]
    kept = [p for p in report["kept"] if p.split(".")[0] in trunk]
    print(json.dumps({"cli": name, "load": {k: len(v) for k, v in report.items()},
                      "trunk_loaded": len(loaded), "trunk_kept": kept[:5]}), flush=True)
    require(loaded and not kept, f"{name}: trunk leaves kept at init: {kept[:5]}")


def cli_phase(dev, run, reference_pt):
    """Phase 40: the user flow through each CLI's ``main`` at full width in
    bf16, on the data of ``tools/loaderbench.py`` (pretrain shards of
    ``CLI_PRETRAIN_ROWS`` rows with a val shard; ``CLI_VIDEOS`` downstream
    videos, a test split of ``CLI_TEST``): ``cli.pretrain`` from a
    checkpoint of the freshly built model with its biases seeded
    (``seeded_biases``: ROADMAP Queue 3's zero-bias fault, which both
    packages share, overflows the gradients of a corrupt row at an
    all-zero-bias init; the corrupt rows stay in the shards), one epoch;
    ``cli.retrieval`` from its final checkpoint, ``cli.retrieval_eval`` and
    ``cli.parity_eval`` (``--expected`` the eval's R@1/5/10, ``--tol
    0.01``) on the epoch checkpoint; ``cli.qa`` in ``qamc-gen`` and
    ``qaoe-mlm``; ``cli.caption``; ``cli.convert_ckpt`` on phase 39's
    ``.pt``; ``cli.extract_vq`` over a webvid shard with a seeded dVAE
    saved as ``.pt``, its pickle read by ``PretrainTsvDataset``. Each
    training CLI's steps are probed (``StepProbe``): the wall median beside
    the hand-wired loop's (phases 37, 38, 32), kernel ms a step and the
    idle share, 0 host waits on a non-logging step, launches held to the
    hand-wired step's. Returns the launches by CLI."""
    data_dir = _data_dir("cli")
    out_dir = str(Path(data_dir) / "runs")
    build_pretrain(data_dir, videos_per_part=CLI_PRETRAIN_ROWS, images=CLI_PRETRAIN_ROWS)
    shutil.copy(Path(data_dir) / "webvid2.5m_train_0.tsv", Path(data_dir) / "webvid2.5m_val_0.tsv")
    txt_path = Path(data_dir) / "txt_webvid2.5m.json"
    txt = json.loads(txt_path.read_text())
    txt["val"] = txt["train"]
    txt_path.write_text(json.dumps(txt))
    build_downstream(data_dir, videos=CLI_VIDEOS, test=CLI_TEST)
    launches = {}
    t_phase = time.perf_counter()

    # pretrain, one epoch, from a checkpoint of the seeded init
    cfg = _cli_config(PRETRAIN_CONFIG, "pretrain", data_dir=data_dir, path_output=out_dir)
    run_p = load_run_config(cfg)
    init = pretrain_cli.build_model(run_p, load_tokenizer(run_p.data.tokenizer), dev)
    seeded_biases(init, TRAIN_SEED)
    init_ckpt = str(Path(data_dir) / "init_seeded_biases.msgpack")
    save_params(init, init_ckpt)
    del init
    torch.cuda.empty_cache()
    probe = StepProbe(frames=run.model.size_frame)
    t0 = time.perf_counter()
    with probe_steps(probe):
        res = pretrain_cli.main(["--config", cfg, "--path_ckpt", init_ckpt, "--size_epoch", "1"],
                                device=dev)
    secs = time.perf_counter() - t0
    per_ep = res["steps_per_epoch"]
    eval_every = max(per_ep // 2, 1)
    files = set(os.listdir(res["run_dir"]))
    final = f"ckpt_violet_pretrain_final_{res['steps']}.msgpack"
    recs = [json.loads(line) for line in
            (Path(res["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
    val_steps = sorted({r["step"] for r in recs if any(k.startswith("val_") for k in r)})
    print(json.dumps({"cli": "pretrain", "seconds": secs, "steps_per_epoch": per_ep,
                      "val_steps": val_steps, "files": sorted(files),
                      "init": "the built model with seeded_biases, saved by save_params: "
                              "ROADMAP Queue 3's zero-bias fault (a corrupt row at an "
                              "all-zero-bias init overflows the gradients in both packages)",
                      "val": [r for r in recs if r["step"] in val_steps[-1:]]}), flush=True)
    _load_complete("pretrain", res["load"])
    require(val_steps[:1] == [0] and len(val_steps) >= 2, f"pretrain val steps {val_steps}")
    require({"restore.state", final} <= files, f"pretrain files {sorted(files)}")
    launches["cli_pretrain"] = _cli_step_line(
        "pretrain", res, probe, TRAIN_LAUNCHES, STEP_MS.get("loader_pretrain_webvid"),
        "phase 37 (webvid, synchronised each step)",
        skip={i for i in range(len(probe.starts)) if (i + 1) % eval_every == 0})
    pretrained = str(Path(res["run_dir"]) / final)
    torch.cuda.empty_cache()

    # the fine-tune CLIs from the pretrain checkpoint
    ret_cfg = _cli_config(RET_CONFIG, "msrvtt-retrieval", data_dir=data_dir, path_output=out_dir)
    for name, module, args, config, want, hand in (
            ("retrieval", retrieval_cli, [], ret_cfg, TRAIN_RET_LAUNCHES, "loader_retrieval"),
            ("qamc_gen", qa_cli, ["--mode", "qamc-gen"],
             _cli_config(QAMC_GEN_CONFIG, "tgif-action", data_dir=data_dir, path_output=out_dir),
             TRAIN_QAMC_MLM_LAUNCHES, "loader_qamc_gen"),
            ("qaoe_mlm", qa_cli, ["--mode", "qaoe-mlm"],
             _cli_config(QAOE_CONFIG, "msrvtt-qa", data_dir=data_dir, path_output=out_dir),
             TRAIN_QAOE_MLM_LAUNCHES, "loader_qaoe_mlm"),
            ("caption", caption_cli, [], _cli_config(CAPTION_CONFIG, "caption", data_dir=data_dir,
                                                     path_output=out_dir),
             CAPTION_LAUNCHES, "caption")):
        probe = StepProbe()
        t0 = time.perf_counter()
        with probe_steps(probe):
            res = module.main(args + ["--config", config, "--path_ckpt", pretrained,
                                      "--size_epoch", "1"], device=dev)
        log = json.loads((Path(res["run_dir"]) / "log.json").read_text())
        print(json.dumps({"cli": name, "seconds": time.perf_counter() - t0,
                          "log": log, "files": sorted(os.listdir(res["run_dir"]))}),
              flush=True)
        _load_complete(name, res["load"])
        require(np.isfinite(log["ls_tr"][0]["total"]), f"{name}: train loss {log['ls_tr']}")
        launches[f"cli_{name}"] = _cli_step_line(
            name, res, probe, want, STEP_MS.get(hand),
            "phase 32 (synthetic)" if hand == "caption" else "phase 38 (loader)")
        if name == "retrieval":
            retrieved = str(Path(res["run_dir"]) / "ckpt_violet_msrvtt-retrieval_1.msgpack")
        if name == "caption":
            for split in ("ac_vl", "ac_ts"):
                sc = log[split][-1]
                require(all(0.0 <= sc[k] <= 100.0 for k in ("bleu4", "rouge_l", "meteor"))
                        and sc["cider"] >= 0.0, f"caption {split} scores {sc}")
        torch.cuda.empty_cache()

    # the two-stage eval and the parity check on the retrieval checkpoint
    t0 = time.perf_counter()
    m = retrieval_eval_cli.main(["--config", ret_cfg, "--path_ckpt", retrieved], device=dev)
    _load_complete("retrieval_eval", m["load"])
    want = ",".join(repr(m[k]) for k in ("r1", "r5", "r10"))
    par = parity_eval_cli.main(["--config", ret_cfg, "--path_ckpt", retrieved,
                                "--expected", want, "--tol", "0.01"], device=dev)
    print(json.dumps({"cli": "retrieval_eval + parity_eval", "seconds": time.perf_counter() - t0,
                      **{k: m[k] for k in ("split", "r1", "r5", "r10", "medr", "_clips",
                                           "_pairs", "_stage1_s", "_stage2_s")},
                      "parity_ok": par["parity_ok"]}), flush=True)
    require(m["split"] == "test" and 1.0 <= m["medr"] and par["parity_ok"],
            f"retrieval eval {m}, parity {par['verdict']}")
    torch.cuda.empty_cache()

    # convert_ckpt on phase 39's reference .pt
    t0 = time.perf_counter()
    dst = str(Path(data_dir) / "converted.msgpack")
    convert_cli.main(["--src", reference_pt, "--dst", dst, "--config", str(PRETRAIN_CONFIG),
                      "--heads", "fc=score_head", "fc_mtm=mlm_head", "decoder_pixel=linear"])
    sd = load_params(dst)
    ref = torch.load(reference_pt, map_location="cpu")["model"]
    bad = [k for k, v in sd.items() if k != "enc_img.emb_len" and not torch.equal(
        v, ref[f"module.{k}"].float())]
    print(json.dumps({"cli": "convert_ckpt", "seconds": time.perf_counter() - t0,
                      "leaves": len(sd), "mib": _files_mib(dst), "differing": bad[:5]}),
          flush=True)
    require(not bad and sd["enc_img.emb_len"].shape[1] == run.model.max_size_frame,
            f"convert_ckpt: {bad[:5]}")

    # extract_vq over a webvid shard with a seeded dVAE, read back by the dataset
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(5)
    dvae = DvaeEncoder()
    dvae_pt = str(Path(data_dir) / "dvae_seeded.pt")
    torch.save({k: torch.randn(v.shape, generator=gen) * 0.05 for k, v in
                dvae.state_dict().items()}, dvae_pt)
    shard = str(Path(data_dir) / "webvid2.5m_train_1.tsv")
    pkl = str(Path(data_dir) / "vq_webvid2.5m.pkl")
    m_cfg = run_p.model
    vq_res = extract_vq_cli.main(["--tsv", shard, "--dvae", dvae_pt, "--out", pkl,
                                  "--size-img", str(m_cfg.size_img), "--size-patch",
                                  str(m_cfg.size_patch), "--size-frame", str(m_cfg.size_frame)],
                                 device=dev)
    with open(pkl, "rb") as f:
        vq = pickle.load(f)
    ds = PretrainTsvDataset(run_p, "train", load_tokenizer(run_p.data.tokenizer), shard,
                            txt["train"], vq=vq)
    items = [ds[i] for i in range(len(ds))]
    with_vq = sum(int((it["vq"] >= 0).any()) for it in items)
    tokens = np.concatenate([np.stack(v).ravel() for v in vq.values()])
    print(json.dumps({"cli": "extract_vq", "seconds": time.perf_counter() - t0,
                      "videos": vq_res["videos"], "rows": len(ds), "items_with_vq": with_vq,
                      "distinct_tokens": int(len(np.unique(tokens)))}), flush=True)
    require(vq_res["videos"] > 0 and with_vq == sum(1 for it in items if not it["corrupt"])
            and with_vq > 0, f"extract_vq: {vq_res['videos']} videos, {with_vq} items with vq")
    print(f"phase 40 done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phases 41-44: data parallelism, rematerialisation, the CLI across ranks
# ---------------------------------------------------------------------------

DP_STEPS = 2               # steps of each data-parallel comparison (phase 42)
NCCL_STEPS = 4             # phase 41's steps; the ms median leaves out the first
DP_DEVICE = "cuda:0"       # phase 42's ranks, all on the one card
DP_EVAL = (16, 3, 48)      # phase 42's two-stage eval: items, encode batch, chunk
# Phase 42's limits, two ranks against one process on the same card in fp32
# with TF32 off: the ranks run each layer on half the rows, and cuBLAS may
# split a product of another M another way, so a row's activations differ at
# fp32 roundoff, which the backward carries into each gradient's sum over
# the batch; the CPU tests hold the same comparison at 1e-5 (one GEMM order).
# Losses within DP_LOSS_RTOL; each step's gradients within DP_GRAD_REL of
# their tensor's largest element plus DP_GRAD_FLOOR (the VTM and nce score
# heads' output bias, zero in exact arithmetic, holds roundoff of scores /
# 0.05). Parameters after the two steps: every element within Adam's bound,
# 2 x the largest lr of the two steps (Adam's update is at most lr an
# element, whatever the gradient's scale); an element resolved at both steps
# (its gradient over DP_RESOLVED x the two runs' difference, so the two agree
# to 1 %) within DP_PARAM_LR x that lr plus DP_PARAM_ULPS roundings of the
# parameter. Adam's first update is g / |g| and does not move with a 1 %
# error; the second, m / sqrt(v), moves by at most about 3 % of lr, since m
# and sqrt(v) each move by at most 1 % of sqrt(v), which the division
# carries to the update whatever the cancellation in m.
DP_LOSS_RTOL, DP_GRAD_REL, DP_GRAD_FLOOR = 1e-4, 1e-3, 2e-5
DP_RESOLVED, DP_PARAM_LR, DP_PARAM_ULPS = 100.0, 0.05, 4


def depth_cut(cfg, dropout=False):
    """``cfg`` at full width with the Video Swin's depths (2, 2, 2, 2), a
    2-layer fusion and a 2-layer text stack (where the model has one);
    without ``dropout`` the BERT dropouts and the drop-path rate 0 (the
    Swin's in-block dropouts stay as configured)."""
    p = None if dropout else 0.0
    fusion = dataclasses.replace(cfg.fusion, num_hidden_layers=2)
    text = dataclasses.replace(cfg.text, num_hidden_layers=2)
    if p is not None:
        fusion, text = (dataclasses.replace(c, hidden_dropout_prob=p,
                                            attention_probs_dropout_prob=p)
                        for c in (fusion, text))
    swin = dataclasses.replace(backbone_config(cfg), depths=(2, 2, 2, 2))
    return dataclasses.replace(
        cfg, swin_custom=swin if p is None else dataclasses.replace(swin, drop_path_rate=p),
        fusion=fusion, text=text)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _no_score_dropout(model):
    for head in ("fc", "fc_mvm", "fc_mvm_clip"):   # the score heads' dropout, 0.1
        if hasattr(model, head):
            getattr(model, head)[0].p = 0.0
    return model


def _timed_steps(dev, step, state, batch, steps=DP_STEPS, keep_grads=False):
    """``steps`` steps; the losses, each step's wall ms (synchronised) and,
    with ``keep_grads``, each step's gradients on the host."""
    losses, ms, grads = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, ls = step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in ls.items()})
        if keep_grads:
            grads.append({n: (torch.zeros(p.shape) if p.grad is None else p.grad.float().cpu())
                          for n, p in state.params.items()})
    return state, losses, ms, grads


def nccl_w1_phase(dev, run):
    """Phase 41: the process group that ``torch.distributed.run`` sets up for
    one process (NCCL on cuda:0, W = 1): ``NCCL_STEPS`` pixel steps at full
    width in bf16 through the data-parallel path (the loss shares'
    all-reduced denominators, the bucketed gradient all-reduce, the losses'
    reduce) and through the plain path, from the same seed. Losses and every
    parameter must be bit-equal; each step's wall ms shows the reduce's
    cost."""
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    with mock.patch.dict(os.environ, env):
        dp = mesh.distributed_init("cuda")
    try:
        require(dp == mesh.DataParallel(0, 1) and dist.get_backend() == "nccl",
                f"NCCL process group: {dp}")
        batch = synthetic_pretrain_batch(run.train.size_batch, run.model, seed=3, device=dev)
        out = {}
        for name, d in (("plain", None), ("data_parallel", dp)):
            model = VioletPretrain.from_run_config(run, dtype=torch.bfloat16, device=dev,
                                                   seed=TRAIN_SEED)
            opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
            state, losses, ms, _ = _timed_steps(
                dev, make_pretrain_train_step(model, opt, d), create_train_state(model, opt),
                batch, NCCL_STEPS)
            out[name] = (losses, ms, {n: p.detach().clone() for n, p in state.params.items()})
            del model, opt, state
            torch.cuda.empty_cache()
        differ = _same_state(out["plain"][2], out["data_parallel"][2])
        same_losses = out["plain"][0] == out["data_parallel"][0]
        print(json.dumps({
            "phase": 41, "slice": "data_parallel_nccl_w1", "backend": dist.get_backend(),
            "world": 1, "config": PRETRAIN_CONFIG.name, "dtype": "bfloat16",
            "batch": run.train.size_batch, "step_ms": {k: v[1] for k, v in out.items()},
            "step_ms_median_after_the_first": {k: float(np.median(v[1][1:]))
                                               for k, v in out.items()},
            "losses": {k: v[0] for k, v in out.items()},
            "bit_equal": same_losses and not differ, "params_differing": differ[:5]}),
            flush=True)
        require(same_losses and not differ,
                f"data-parallel W = 1 step differs from the plain step: {differ[:5]}")
    finally:
        mesh.destroy()


def _dp_jobs(run):
    """Phase 42's jobs: the depth-cut pixel step (fp32, the one-process
    step's draws), the depth-cut retrieval ``nce`` step and the two-stage
    eval, each with its global batch on the host."""
    cut = depth_cut(run.model)
    run_cut = dataclasses.replace(run, model=cut)
    batch = synthetic_pretrain_batch(run.train.size_batch, cut, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(5)
    hw = cut.size_img // cut.size_patch
    b = batch["img"].shape[0]
    batch.update(draws=draw_masks(gen, batch["txt"], cut.size_frame, hw, hw,
                                  special_token_ids=VioletPretrain.special_token_ids,
                                  mask_token_id=VioletPretrain.mask_token_id,
                                  p_mask=run.train.p_mask, mask_types=run.train.pretrain_masks),
                 neg_idx=draw_negatives(gen, b, min(b, VioletPretrain.num_options) - 1))
    run_ret = load_run_config(str(CONFIG))
    run_ret = dataclasses.replace(run_ret, model=depth_cut(run_ret.model))
    ret_batch = synthetic_finetune_batch("retrieval", run_ret.train.size_batch, run_ret.model,
                                         seed=6, device="cpu")
    return [dict(name="pixel", run=run_cut, batch=batch),
            dict(name="nce", run=run_ret, batch={k: ret_batch[k] for k in ("img", "txt", "mask")}),
            dict(name="two_stage", run=run_ret)]


def _rank_batch(batch, dp, dev):
    """This rank's rows of a global batch (the draws' rows too), on ``dev``."""
    draws = batch.get("draws")
    out = mesh.shard_batch({k: v for k, v in batch.items() if k != "draws"}, dp)
    if draws is not None:
        r, w = (0, 1) if dp is None else (dp.rank, dp.world)
        out["draws"] = type(draws)(draws.choice[r::w], draws.covs[:, r::w],
                                   draws.txt_sel[:, r::w])
    return {k: (type(v)(*(t.to(dev) for t in v)) if k == "draws" else v.to(dev))
            for k, v in out.items()}


def dp_job(job, dev, dp):
    """One of phase 42's jobs on this rank (``dp``) or on one process."""
    run = job["run"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if job["name"] == "two_stage":
        items, encode_batch, chunk = DP_EVAL
        cfg = run.model
        model = VioletRetrieval(cfg, dtype=torch.float32, device=dev, seed=TRAIN_SEED)
        ds = SyntheticRetrievalDataset(items, CLIPS, cfg.size_frame, cfg.size_img,
                                       cfg.size_txt, cfg.text.vocab_size, seed=1)
        metrics = retrieval_two_stage_eval(model, ds, chunk_size=chunk,
                                           encode_batch=encode_batch, device=dev, dp=dp)
        return {"metrics": {k: metrics[k] for k in ("r1", "r5", "r10", "medr", "_pairs")},
                "ms": [(time.perf_counter() - t0) * 1e3],
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    if job["name"] == "pixel":
        model = VioletPretrain.from_run_config(run, dtype=torch.float32, device=dev,
                                               seed=TRAIN_SEED)
    else:
        model = VioletRetrieval(run.model, dtype=torch.float32, device=dev, seed=TRAIN_SEED)
    _no_score_dropout(model)
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
    step = (make_pretrain_train_step(model, opt, dp) if job["name"] == "pixel"
            else make_supervised_train_step(model, opt, "nce", run.train.temp, dp))
    state, losses, ms, grads = _timed_steps(dev, step, create_train_state(model, opt),
                                            _rank_batch(job["batch"], dp, dev), keep_grads=True)
    return {"losses": losses, "ms": ms, "grads": grads,
            "params": {n: p.detach().cpu() for n, p in state.params.items()},
            "lr": max(opt.schedules[g](i) for g in opt.schedules for i in range(DP_STEPS)),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def dp_worker(work, rank, world):
    """A rank of phase 42 (``chip_smoke.py --dp-worker DIR RANK WORLD``):
    gloo over a file rendezvous, on cuda:0 beside the other ranks; writes
    its results to DIR/out_RANK.pt (rank 0's tensors, the others' times)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world)
    try:
        dp, dev = mesh.DataParallel(rank, world), torch.device(DP_DEVICE)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)      # the allocator's stats need the device set up
            torch.empty(1, device=dev)
        out = {}
        for job in torch.load(work / "jobs.pt", weights_only=False):
            res = dp_job(job, dev, dp)
            out[job["name"]] = res if rank == 0 else {
                k: res[k] for k in ("ms", "peak_gib", "losses", "metrics") if k in res}
        torch.save(out, work / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _grad_share(got, want):
    """Each gradient's largest difference over its limit (DP_GRAD_REL of the
    tensor's largest element plus DP_GRAD_FLOOR), by name."""
    return {n: (got[n] - g).abs().max().item() / (DP_GRAD_REL * g.abs().max().item()
                                                  + DP_GRAD_FLOOR)
            for n, g in want.items()}


def _params_apart(got, want):
    """The parameters after DP_STEPS steps of two ranks (``got``) against one
    process (``want``): the largest difference of all elements, and of the
    elements resolved at every step, in units of the resolved bound
    (DP_PARAM_LR x the largest lr plus DP_PARAM_ULPS roundings of the
    parameter), with the share of elements resolved."""
    worst = worst_resolved = 0.0
    resolved_n = total = 0
    for n, w in want["params"].items():
        resolved = torch.ones(w.shape, dtype=torch.bool)
        for gg, gw in zip(got["grads"], want["grads"]):
            resolved &= gw[n].abs() > DP_RESOLVED * (gg[n] - gw[n]).abs()
        d = (got["params"][n] - w).abs()
        worst = max(worst, d.max().item())
        bound = DP_PARAM_LR * want["lr"] + DP_PARAM_ULPS * torch.finfo(w.dtype).eps * w.abs()
        if resolved.any():
            worst_resolved = max(worst_resolved, (d / bound)[resolved].max().item())
        resolved_n += int(resolved.sum())
        total += w.numel()
    return worst, worst_resolved, resolved_n / total


def gloo_w2_phase(dev, run):
    """Phase 42: two ranks on the one card (NCCL refuses two ranks on one
    device; gloo carries CUDA tensors through the host), spawned as
    ``chip_smoke.py --dp-worker`` processes, against one process on the
    same card, fp32 with TF32 off, dropout and drop path off, at full width
    with the depth cut of ``depth_cut``: the pixel step (batch 20, 10 rows a
    rank, the one-process step's draws) and the retrieval ``nce`` step
    (batch 8) for two steps each, held to ``DP_*``, and the two-stage eval
    (``DP_EVAL``: batches and chunks that do not divide over two ranks),
    whose metrics must equal one process's. Prints each rank's ms and peak
    memory."""
    work = Path(_data_dir("dp2"))
    jobs = _dp_jobs(run)
    torch.save(jobs, work / "jobs.pt")
    one = {}
    for job in jobs:
        one[job["name"]] = dp_job(job, dev, None)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--dp-worker",
                               str(work), str(r), "2"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    spawn_s = time.perf_counter() - t0
    for r, p in enumerate(procs):
        require(p.returncode == 0, f"phase 42 rank {r} exited with {p.returncode}:\n"
                                   f"{logs[r][-3000:]}")
    two = [torch.load(work / f"out_{r}.pt", weights_only=False) for r in range(2)]
    line = {"phase": 42, "slice": "data_parallel_gloo_w2_one_card", "backend": "gloo",
            "world": 2, "dtype": "float32", "swin_depths": [2, 2, 2, 2], "fusion_layers": 2,
            "ranks_seconds": spawn_s, "limits": {"loss_rtol": DP_LOSS_RTOL,
                                                 "grad_rel": DP_GRAD_REL,
                                                 "grad_floor": DP_GRAD_FLOOR,
                                                 "resolved_over": DP_RESOLVED,
                                                 "resolved_lr_share": DP_PARAM_LR,
                                                 "resolved_ulps": DP_PARAM_ULPS}}
    for name in ("pixel", "nce"):
        got, want = two[0][name], one[name]
        for lg, lw in zip(got["losses"], want["losses"]):
            for k in lw:
                require(abs(lg[k] - lw[k]) <= DP_LOSS_RTOL * abs(lw[k]),
                        f"phase 42 {name} loss {k}: {lg[k]} against {lw[k]}")
        shares = [_grad_share(gg, gw) for gg, gw in zip(got["grads"], want["grads"])]
        for k, share in enumerate(shares):
            over = [n for n, v in share.items() if v > 1]
            require(not over, f"phase 42 {name} step {k} gradients beyond the limits: {over[:5]}")
        bound = 2 * want["lr"] + 1e-7
        worst, worst_resolved, resolved_share = _params_apart(got, want)
        require(worst <= bound, f"phase 42 {name} parameters {worst} apart, bound {bound}")
        require(resolved_share > 0 and worst_resolved <= 1,
                f"phase 42 {name} resolved parameters at {worst_resolved} of their bound "
                f"({resolved_share} of the elements resolved)")
        b = next(j for j in jobs if j["name"] == name)["batch"]["img"].shape[0]
        line[name] = {
            "batch": b, "rows_a_rank": b // 2,
            "losses_two_ranks": got["losses"], "losses_one_process": want["losses"],
            "grad_share_of_limit_by_step": [max(share.values()) for share in shares],
            "param_max_abs_diff": worst, "adam_bound": bound,
            "resolved_share": resolved_share, "resolved_share_of_bound": worst_resolved,
            "ms_a_step_one_process": want["ms"], "peak_gib_one_process": want["peak_gib"],
            **{f"ms_a_step_rank{r}": two[r][name]["ms"] for r in range(2)},
            **{f"peak_gib_rank{r}": two[r][name]["peak_gib"] for r in range(2)}}
    for r in range(2):
        require(two[r]["two_stage"]["metrics"] == one["two_stage"]["metrics"],
                f"phase 42 two-stage eval, rank {r}: {two[r]['two_stage']['metrics']} against "
                f"{one['two_stage']['metrics']}")
    line["two_stage"] = {"items": DP_EVAL[0], "encode_batch": DP_EVAL[1],
                         "chunk_size": DP_EVAL[2], "metrics": one["two_stage"]["metrics"],
                         "equal_on_every_rank": all(
                             two[r]["two_stage"]["metrics"] == one["two_stage"]["metrics"]
                             for r in range(2)),
                         "ms_one_process": one["two_stage"]["ms"],
                         **{f"ms_rank{r}": two[r]["two_stage"]["ms"] for r in range(2)},
                         **{f"peak_gib_rank{r}": two[r]["two_stage"]["peak_gib"]
                            for r in range(2)}}
    print(json.dumps(line), flush=True)


REMAT_PASSES = 5          # phase 43's timed passes a side (host-bound: one pass varies)


def with_remat(run, on=True):
    """``run`` with ``remat`` set on its swin and its BERT configs."""
    m = run.model
    return dataclasses.replace(run, model=dataclasses.replace(
        m, swin_custom=dataclasses.replace(backbone_config(m), remat=on),
        fusion=dataclasses.replace(m.fusion, remat=on),
        text=dataclasses.replace(m.text, remat=on)))


def _remat_pass(dev, run, dtype, batch):
    """Losses and gradients (on the host) of a training pass of the pixel
    model, with dropout, drop path and the masks drawn from one step's
    generators, and the dropout generator's state after the backward; the
    wall ms of each of REMAT_PASSES such passes after a first that grows
    the allocator's pool, and the peak GiB of the last."""
    model = VioletPretrain.from_run_config(run, dtype=dtype, device=dev, seed=TRAIN_SEED)
    ms = []
    for _ in range(1 + REMAT_PASSES):
        model.zero_grad(set_to_none=True)
        drop, masks = step_generators(TRAIN_SEED, 0, dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        ls = model.losses(batch["img"], batch["txt"], batch["mask"], generator=drop,
                          mask_generator=masks)
        ls["total"].backward()
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters() if p.grad is not None}
    out = ({k: v.item() for k, v in ls.items()}, grads, drop.get_state(), ms[1:], peak)
    del model, ls
    torch.cuda.empty_cache()
    return out


def remat_phase(dev, run):
    """Phase 43: the pixel model's training pass (dropout and drop path at
    the config's rates, the masks drawn) without and with ``remat`` on every
    swin block and BERT layer, from the same seed: bf16 at full width
    (configs/pretrain.json, batch 20) and fp32 at full width with the depth
    cut of ``depth_cut`` (dropout kept). Losses, the dropout generator's
    state after the backward and every gradient must be bit-equal; where
    they are not, a second pass without remat measures the spread of the
    backward kernels, and remat must fall within it. Prints the peak GiB and
    the ms of each timed pass, their medians and the medians' ratio."""
    line = {"phase": 43, "slice": "remat"}
    # checkpoint's first call sets up its machinery once: pay it outside the
    # timed passes
    x = torch.ones(1, device=dev, requires_grad=True)
    torch.utils.checkpoint.checkpoint(torch.exp, x, use_reentrant=False).backward()
    for dtype, r in ((torch.bfloat16, run),
                     (torch.float32, dataclasses.replace(
                         run, model=depth_cut(run.model, dropout=True)))):
        batch = synthetic_pretrain_batch(r.train.size_batch, r.model, seed=3, device=dev)
        off = _remat_pass(dev, with_remat(r, False), dtype, batch)
        on = _remat_pass(dev, with_remat(r, True), dtype, batch)
        differ = [n for n, g in off[1].items() if not torch.equal(g, on[1][n])]
        rec = {"batch": r.train.size_batch, "swin_depths": list(r.model.swin.depths),
               "fusion_layers": r.model.fusion.num_hidden_layers,
               "ms": {"off": off[3], "on": on[3]},
               "ms_median": {"off": float(np.median(off[3])), "on": float(np.median(on[3]))},
               "ms_ratio_of_medians": float(np.median(on[3]) / np.median(off[3])),
               "peak_gib": {"off": off[4], "on": on[4]},
               "losses_equal": off[0] == on[0],
               "generator_state_equal": torch.equal(off[2], on[2]),
               "gradients_differing": len(differ), "gradients": len(off[1])}
        if differ:
            again = _remat_pass(dev, with_remat(r, False), dtype, batch)
            spread = {n: (again[1][n] - g).abs().max().item() for n, g in off[1].items()}
            beyond = [n for n in differ if (on[1][n] - off[1][n]).abs().max().item()
                      > spread[n]]
            rec.update(verdict="within the spread of two passes without remat",
                       no_remat_passes_differ=sum(v > 0 for v in spread.values()),
                       beyond_spread=beyond[:5])
            require(not beyond, f"remat {dtype} gradients beyond the no-remat spread: "
                                f"{beyond[:5]}")
        else:
            rec["verdict"] = "bit-equal"
        line[str(dtype).replace("torch.", "")] = rec
        require(off[0] == on[0] and torch.equal(off[2], on[2]) and set(off[1]) == set(on[1]),
                f"remat {dtype}: losses {off[0]} / {on[0]}, generator state equal "
                f"{torch.equal(off[2], on[2])}")
    print(json.dumps(line), flush=True)


CLI_DP_ACCUM = 2           # phase 44's grad_accum
CLI_DP_MIN_SIZE = 2 ** 16  # phase 44's fsdp_min_size: Swin-base's smallest block has 2e5


def pretrain_cli_worker(config, init_ckpt, result):
    """Phase 44's process (``chip_smoke.py --pretrain-cli CONFIG CKPT OUT``,
    started by ``torch.distributed.run``): ``cli.pretrain``'s main for one
    epoch, ``grad_accum`` set to ``CLI_DP_ACCUM`` (no task file sets it);
    writes OUT, a JSON of the run and of the blocks FSDP sharded."""
    sharded = []

    def shard(*args, **kwargs):
        units = shard_model(*args, **kwargs)
        sharded.extend(type(u).__name__ for u in units)
        return units

    parse = pretrain_cli.common.parse_cli

    def parse_accum(*args, **kwargs):
        cfg = parse(*args, **kwargs)
        return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                  grad_accum=CLI_DP_ACCUM))

    t0 = time.perf_counter()
    with mock.patch.object(agent_module, "shard_model", shard), \
            mock.patch.object(pretrain_cli.common, "parse_cli", parse_accum):
        res = pretrain_cli.main(["--config", config, "--path_ckpt", init_ckpt,
                                 "--size_epoch", "1"])
    if mesh.is_main_process():
        Path(result).write_text(json.dumps({
            "run_dir": res["run_dir"], "steps": res["steps"],
            "steps_per_epoch": res["steps_per_epoch"], "seconds": time.perf_counter() - t0,
            "sharded": sharded, "world": mesh.process_count(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}))


def cli_dp_phase(dev, run):
    """Phase 44: ``python -m torch.distributed.run --standalone
    --nproc_per_node=1 chip_smoke.py --pretrain-cli ...``, the pretrain CLI
    as a user launches it across cards, on phase 40's shards from its
    seeded-bias checkpoint, one epoch, with ``fsdp`` and ``remat`` set in the
    task file and ``grad_accum`` 2: every swin block and fusion layer
    sharded, the final checkpoint written, and that checkpoint loaded into
    the one-process port (every leaf, finite, moved from the start)."""
    data_dir = _build.BUILD_DIR / "smoke_data" / "cli"
    init_ckpt = data_dir / "init_seeded_biases.msgpack"
    cfg = _cli_config(PRETRAIN_CONFIG, "pretrain_dp", data_dir=str(data_dir),
                      path_output=str(data_dir / "runs_dp"), fsdp=True,
                      fsdp_min_size=CLI_DP_MIN_SIZE, swin_custom={"remat": True},
                      fusion={"remat": True})
    result = data_dir / "pretrain_dp.json"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=1", str(REPO / "chip_smoke.py"), "--pretrain-cli",
                           cfg, str(init_ckpt), str(result)],
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    require(proc.returncode == 0, f"phase 44 torch.distributed.run exited with "
                                  f"{proc.returncode}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    res = json.loads(result.read_text())
    run_cfg = load_run_config(cfg)
    final = Path(res["run_dir"]) / f"ckpt_violet_pretrain_final_{res['steps']}.msgpack"
    sd = load_params(str(final))
    model = VioletPretrain.from_run_config(run_cfg, dtype=torch.bfloat16, device=dev)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    start = load_params(str(init_ckpt))
    moved = sum(not torch.equal(sd[k], start[k]) for k in sd if k in start)
    finite = all(torch.isfinite(v).all().item() for v in sd.values() if v.is_floating_point())
    n_blocks = sum(sum(p.numel() for p in m.parameters()) >= run_cfg.train.fsdp_min_size
                   for m in model.modules() if isinstance(m, (SwinTransformerBlock3D, BertLayer)))
    print(json.dumps({"phase": 44, "slice": "pretrain_cli_torch_distributed_run",
                      "nproc_per_node": 1, "fsdp": run_cfg.train.fsdp,
                      "grad_accum": CLI_DP_ACCUM, "remat": [run_cfg.model.swin.remat,
                                                            run_cfg.model.fusion.remat],
                      "launcher_seconds": secs, **res, "sharded": len(res["sharded"]),
                      "checkpoint": final.name, "leaves": len(sd), "leaves_moved": moved,
                      "missing": missing[:5], "unexpected": unexpected[:5],
                      "finite": finite}), flush=True)
    require(len(res["sharded"]) == n_blocks == sum(run_cfg.model.swin.depths)
            + run_cfg.model.fusion.num_hidden_layers and res["world"] == 1,
            f"phase 44 sharded {len(res['sharded'])} blocks, not {n_blocks}")
    require(not missing and not unexpected and finite and moved > 0,
            f"phase 44 checkpoint: missing {missing[:5]}, unexpected {unexpected[:5]}, "
            f"finite {finite}, {moved} leaves moved")
    del model
    torch.cuda.empty_cache()


def lanebench_phase():
    """Phase 17: the lanebench tool (``empirical_mvm_torch.tools.lanebench``)
    as its command line runs it, ``--stage -1 --grad``, in this process: its
    lines, and each path's largest error against the tool's fp32 oracle held
    to phase 3's bf16 limit against plain fp32 (``BF16_VS_FP32["attention"]``,
    shared by the ``attention`` and ``window_fwd_tc`` kinds). Returns the tool's
    launch counts, in which ``lane_attention`` must appear."""
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    recs = lanebench.main(["--stage", "-1", "--grad"])
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    limit = BF16_VS_FP32["attention"]["atol"]
    print(json.dumps({"slice": "lanebench", "records": recs, "launches": launches,
                      "err_limit": limit, "s": time.perf_counter() - t0}), flush=True)
    require(sorted(r["stage"] for r in recs) == sorted(lanebench.SHAPES),
            f"lanebench ran stages {[r['stage'] for r in recs]}")
    for r in recs:
        require(r["err_lane"] <= limit and r["err_packed"] <= limit,
                f"lanebench stage{r['stage']}: errors {r['err_lane']}, {r['err_packed']} "
                f"above {limit}")
    require(launches.get("lane_attention", 0) >= len(recs),
            f"lanebench launched lane_attention {launches.get('lane_attention', 0)} times")
    return launches


def _shared_bwd_calls(dev, gen):
    """(kernel, label, x3, call, plain, kind) of each backward whose bf16 runs
    a tensor-core body, at the shapes phase 3 times it: the window backwards
    of attention_bwd_mma.cuh (rows 4 and 8: ``_direct_bwd_inputs``,
    ``_window_bwd_inputs``; rows 9 and 10: ``_packed_shapes``, the split
    entry at the violet stage-0 shifted shape) and row 6 (the fusion of the
    train step, p = 0.1); ``call(a)`` launches the kernel on a (a dtype of
    x3) with the shape's do, bias and mask, ``plain(a)`` its plain version,
    ``kind`` names the bf16 limits."""
    for stage, win, nh, x3, do, bias, mask in _direct_bwd_inputs(dev, gen):
        hd = x3.shape[-1] // 3 // nh
        args = (bias, mask, do, win, nh, hd ** -0.5)
        yield ("direct_window_attention_bwd",
               f"stage{stage} {'shifted' if mask is not None else 'unshifted'}", x3,
               functools.partial(_with_do, wa._direct_bwd, args),
               functools.partial(_with_do, wa.direct_window_attention_backward_plain, args),
               _window_bwd_kind(hd))
    for stage, nw, nh, x3, do, bias, mk, _ in _window_bwd_inputs(dev, gen):
        args = (bias, mk, do, nw if mk is not None else 1, nh, 32 ** -0.5)
        yield ("lane_window_attention_bwd",
               f"2d stage{stage} {'shifted' if mk is not None else 'unshifted'}", x3,
               functools.partial(_with_do, wa._lane_window_bwd, args),
               functools.partial(_with_do, wa.lane_window_attention_backward_plain, args),
               _window_bwd_kind(32))
    for label, nw, c, nh, n, mk, _ in _packed_shapes():
        qkv = torch.randn(TRAIN_B * nw, 3 * nh, n, 32, device=dev, generator=gen) * 0.5
        do = _bf16_values(torch.randn(TRAIN_B * nw, nh, n, 32, device=dev, generator=gen))
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mk = None if mk is None else torch.from_numpy(mk).to(dev)
        args = (bias, mk, do, nw if mk is not None else 1, nh, 32 ** -0.5)
        label = f"{label} {'shifted' if mk is not None else 'unshifted'}"
        yield ("packed_window_attention_bwd", label, qkv,
               functools.partial(_with_do, wa._packed_bwd, args),
               functools.partial(_with_do, wa.packed_window_attention_backward_plain, args),
               _window_bwd_kind(32))
        if label == "violet stage0 shifted":
            stack = qkv.reshape(-1, 3, nh, n, 32).transpose(0, 1).contiguous()
            args = (bias, mk, do, nw, 32 ** -0.5)
            yield ("fused_window_attention_bwd", label, stack,
                   functools.partial(_with_do, _split(wa._fused_bwd), args),
                   functools.partial(_with_do, _split(wa.fused_window_attention_backward_plain),
                                     args),
                   _window_bwd_kind(32, split=True))
    b, l = 4 * TRAIN_B, TRAIN_L
    x3 = torch.randn(b, l, 3 * 768, device=dev, generator=gen) * 0.5
    do = _bf16_values(torch.randn(b, l, 768, device=dev, generator=gen))
    seed = torch.tensor([20261016, 7], dtype=torch.int32, device=dev)
    args = (_padding_mask(dev, gen, b, l, 32, 6), do, 12, 0.125, P_ATTN, seed)
    yield ("lane_self_attention_bwd", f"train p_drop={P_ATTN}", x3,
           functools.partial(_with_do, wa._lane_bwd, args, at=1),
           functools.partial(_with_do, wa.lane_self_attention_backward_plain, args, at=1),
           "attention_bwd")


def _with_do(fn, args, a, at=2):
    """fn(a, *args) with args[at], the cotangent, cast to a's dtype."""
    args = list(args)
    args[at] = args[at].to(a.dtype)
    return fn(a, *args)


def _split(fn):
    """fn on a (3, ...) stack of q, k, v: fn(q, k, v, ...)."""
    return lambda a, *args: fn(*a.unbind(0), *args)


def _redesigned_fwd_calls(dev, gen):
    """(kernel, label, x3, call, plain, kind) of each forward whose bf16 runs
    a tensor-core body since rows 3, 5, 7, 9, 10 and 12 were redesigned, at
    the main-path shapes phase 3 times: the direct forward (row 3) at the
    train step's stages (``_direct_bwd_inputs``), the eval's (32 clips of 5
    frames, N = 245) and the violet step's stages 2 and 3; the lane
    self-attention (row 5) at the eval's fusion (p = 0), the train step's (p
    = 0.1) and the CLIP and DPT teachers' shapes; the packed forward (row 9) at
    ``_packed_shapes``; the fused forward (row 10) at the violet stage-0
    shifted shape; the lane window forward (row 7) at the 2D swin's shapes
    (``_window_bwd_inputs``); ``lane_attention`` (row 12) at the lanebench
    tool's stage shapes with its zero mask and a shift-like mask. ``kind``
    names the bf16 limits of this checkout's body."""
    direct = itertools.chain(
        (("train", *x) for x in _direct_bwd_inputs(dev, gen)),
        (("eval", *x) for x in _direct_bwd_inputs(dev, gen, b=ITEMS * CLIPS, t=5)),
        (("violet", *x) for x in _direct_bwd_inputs(dev, gen, SwinConfig.violet(), (2, 3))))
    for path, stage, win, nh, x3, _, bias, mask in direct:
        hd, n = x3.shape[-1] // 3 // nh, bias.shape[-1]
        args = (bias, mask, win, nh, hd ** -0.5)
        yield ("direct_window_attention",
               f"{path} stage{stage} {'shifted' if mask is not None else 'unshifted'}", x3,
               functools.partial(_with_args, wa._direct_fwd, args),
               functools.partial(_with_args, wa.direct_window_attention_plain, args),
               _window_fwd_kind(hd, n))
    seed = torch.tensor([20261016, 7], dtype=torch.int32, device=dev)
    for label, b, l, d, text, p_drop in (("eval", CHUNK, 275, 768, 25, 0.0),
                                         ("train", 4 * TRAIN_B, TRAIN_L, 768, 32, P_ATTN),
                                         ("2d_clip teacher", TRAIN_B * TRAIN_T, 50, 768, 0, 0.0),
                                         ("depth teacher", TRAIN_B * TRAIN_T, 197, 1024, 0,
                                          0.0)):
        x3 = torch.randn(b, l, 3 * d, device=dev, generator=gen) * 0.5
        mask = (_padding_mask(dev, gen, b, l, text, 3) if text
                else torch.zeros(1, 1, l, device=dev).expand(b, l, l))
        args = (mask, d // 64, 0.125, p_drop, seed if p_drop else None)
        yield ("lane_self_attention" if p_drop == 0 else "lane_self_attention_dropout",
               f"{label} p_drop={p_drop}", x3, functools.partial(_with_args, wa._lane_fwd, args),
               functools.partial(_with_args, wa.lane_self_attention_plain, args),
               _lane_fwd_kind(64))
    for label, nw, c, nh, n, mk, _ in _packed_shapes():
        qkv = torch.randn(TRAIN_B * nw, 3 * nh, n, 32, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        mk = None if mk is None else torch.from_numpy(mk).to(dev)
        args = (bias, mk, nw if mk is not None else 1, nh, 32 ** -0.5)
        label = f"{label} {'shifted' if mk is not None else 'unshifted'}"
        yield ("packed_window_attention", label, qkv,
               functools.partial(_with_args, wa._packed_fwd, args),
               functools.partial(_with_args, wa.packed_window_attention_plain, args),
               _window_fwd_kind(32, n))
        if label == "violet stage0 shifted":
            stack = qkv.reshape(-1, 3, nh, n, 32).transpose(0, 1).contiguous()
            args = (bias, mk, nw, 32 ** -0.5)
            yield ("fused_window_attention", label, stack,
                   functools.partial(_with_args, _split(wa._fused_fwd), args),
                   functools.partial(_with_args, _split(wa.fused_window_attention_plain), args),
                   _window_fwd_kind(32, n))
    for stage, nw, nh, x3, _, bias, mk, _ in _window_bwd_inputs(dev, gen):
        args = (bias, mk, nw if mk is not None else 1, nh, 32 ** -0.5)
        yield ("lane_window_attention",
               f"2d stage{stage} {'shifted' if mk is not None else 'unshifted'}", x3,
               functools.partial(_with_args, wa._lane_window_fwd, args),
               functools.partial(_with_args, wa.lane_window_attention_reference, args),
               _window_fwd_kind(32, x3.shape[1]))
    for stage, sh in lanebench.SHAPES.items():
        b_, n, c, nh, nw = (sh[k] for k in ("b_", "n", "c", "nh", "nw"))
        x3 = torch.randn(b_, n, 3 * c, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.1
        for name, mask in (("zero mask", torch.zeros(nw, n, n, device=dev)),
                           ("shift-like mask", _shift_like_mask(dev, gen, nw, n))):
            args = (bias, mask, nh, (c // nh) ** -0.5)
            yield ("lane_attention", f"lanebench stage{stage} {name}", x3,
                   functools.partial(_with_args, wa._lane_attention_fwd, args),
                   functools.partial(_with_args, wa.lane_attention_reference, args),
                   _window_fwd_kind(c // nh, n))


def _with_args(fn, args, a):
    """fn(a, *args)."""
    return fn(a, *args)


def _tiled_calls(dev, gen):
    """(kernel, label, qkv, calls, kind) of row 11 at the multiple-choice
    fusion shape (40 rows of 350, 12 heads of 64, the padding mask):
    forward at p = 0 and p = 0.1, backward at p = 0.1. ``calls()`` returns a
    fresh (kernel call, plain version) pair, so that each build's backward
    runs from its own forward's stats."""
    b, nh, n, hd = QAMC_B * QAMC_O, 12, QAMC_L, 64
    qkv = torch.randn(b, 3 * nh, n, hd, device=dev, generator=gen) * 0.5
    do = _bf16_values(torch.randn(b, nh, n, hd, device=dev, generator=gen))
    mask = _padding_mask(dev, gen, b, n, 100, 8)
    seed = torch.tensor([20261016, 11], dtype=torch.int32, device=dev)

    def calls(p_drop, backward):
        return _sa_calls(mask, nh, hd ** -0.5, p_drop, seed if p_drop else None,
                         do)[backward][:2]

    for p_drop in (0.0, P_ATTN):
        label = f"mc fusion p_drop={p_drop}"
        yield "packed_self_attention", label, qkv, functools.partial(calls, p_drop, 0), "sa"
        if p_drop:
            yield ("packed_self_attention_bwd", label, qkv, functools.partial(calls, p_drop, 1),
                   "sa_bwd")


def _ln_sites():
    """(kernel, label, rows, C, eps, dtype) of every LayerNorm site of the
    paths: the forward at ``EVAL_LN``, ``TRAIN_LN``, ``TEACHER3D_LN`` (the
    2D teacher's sites and the 3D teacher's final norm), ``CLIP_LN`` and
    ``DPT_LN``, the backward at ``TRAIN_LN``."""
    for path, sites in (("eval", EVAL_LN), ("train", TRAIN_LN), ("teacher", TEACHER3D_LN),
                        ("clip teacher", CLIP_LN), ("dpt teacher", DPT_LN)):
        for label, rows, c, eps, work in sites:
            yield "fused_layer_norm", f"{path} {label} rows={rows} C={c}", rows, c, eps, work
    for label, rows, c, eps, work in TRAIN_LN:
        yield "fused_layer_norm_bwd", f"{label} rows={rows} C={c}", rows, c, eps, work


# train steps of each build in --compare-build: STEP_TURNS steps a turn,
# after one warm-up step with each build
STEP_TURNS = 3


def _step_calls(dev):
    """(label, one_step) of the pixel, violet, 2d_feature (the frozen 2D
    teacher on row 7) and swin2d (the trained 2D swin on rows 7 and 8)
    pretrain steps and the multiple-choice step at full width, each model
    built once: one_step() runs one step, ending in a synchronise (the
    parameters move from step to step, which the times do not depend on)."""
    run = load_run_config(str(PRETRAIN_CONFIG))
    for label, r in (("pixel", run), ("violet", with_violet_backbone(run)),
                     ("2d_feature", with_mvm_target(run, ("2d_feature",))),
                     ("swin2d", with_swin2d_backbone(run))):
        model = VioletPretrain.from_run_config(r, dtype=torch.bfloat16, device=dev,
                                               seed=TRAIN_SEED)
        opt = build_optimizer(model, r.train, TRAIN_MAX_ITER)
        step = make_pretrain_train_step(model, opt)
        batch = synthetic_pretrain_batch(r.train.size_batch, r.model, seed=3, device=dev)
        yield f"train step {label}", _stepper(step, create_train_state(model, opt), batch)
        del model, opt, step, batch
        torch.cuda.empty_cache()
    run = load_run_config(str(QAMC_CONFIG))
    model = VioletQAMC(run.model, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED)
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
    step = make_supervised_train_step(model, opt, "ce")
    batch = synthetic_finetune_batch("mc", run.train.size_batch, run.model, seed=6, device=dev)
    yield "train step qamc", _stepper(step, create_train_state(model, opt), batch)


def _kernel_ms(one_step):
    """The ms that CUDA kernels ran during one call of ``one_step``
    (torch.profiler, CUDA activity alone); the rest of the step's time the
    device waits for the host."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_step()
    return sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages() if str(e.device_type).endswith("CUDA")) / 1e3


def _stepper(step, state, batch):
    """A zero-argument call of one train step on ``state``, synchronised."""
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch, TRAIN_SEED)
        torch.cuda.synchronize()

    return one_step


def compare_builds(base_csrc: Path) -> None:
    """Build the kernel library from ``base_csrc`` too and hold this
    checkout's build against it, times of both builds' bf16 calls taken with
    CUDA events in turns (base, new, new, base):
    * the forwards whose bf16 runs a tensor-core body since their redesign
      (``_redesigned_fwd_calls``: rows 3, 5, 7, 9, 10, 12): fp32
      bit-identical (the CUDA-core bodies), each build's bf16 held to the
      bf16 limits of this checkout's body (which take the CUDA-core body's
      readings too), and whether bf16 is bit-identical printed (a body
      that neither build changed reads true);
    * the backwards whose bf16 runs a tensor-core body (``_shared_bwd_calls``:
      rows 4, 6, 8, 9, 10) and row 11 forward and backward (``_tiled_calls``):
      fp32 and bf16 bit-identical, each build's bf16 held to its limits;
    * the LayerNorm forward and backward (rows 1 and 2) at every site of the
      paths (``_ln_sites``), timed in the site's dtype: each build's fp32
      and bf16 held to the ``layer_norm`` / ``layer_norm_bwd`` limits (the
      bodies' sum orders differ, so their bits may), and the body this
      checkout's build runs there;
    * the pixel, violet, 2d_feature and swin2d train steps and the
      multiple-choice step (``_step_calls``): host seconds of ``STEP_TURNS``
      steps a turn, after one warm-up step with each build, their medians
      per build; then two steps of each build under torch.profiler, in
      turns: the mean ms their kernels ran, and the device's idle share of
      the median step (``_kernel_ms``).
    Size queries that the base build predates (``*_smem_bytes`` entry
    points, which feed only the wrappers' shared-memory check before a
    launch) are answered by this build's. Prints one JSON line per shape and
    the sums per kernel with new / base; exits non-zero if an output differs
    or a limit is exceeded."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(_nvidia_smi(), flush=True)
    libs = {"new": _build.library(), "base": _build.load(_build.build(csrc=base_csrc), False)}
    for name in _build._SIGNATURES:
        if name.endswith("_smem_bytes") and not hasattr(libs["base"], name):
            setattr(libs["base"], name, getattr(libs["new"], name))
    gen = torch.Generator(dev).manual_seed(0)
    differ, failures, sums = [], [], {}

    def in_turns(calls, a):
        """Times of calls[build](a), base, new, new, base."""
        ms = {"base": [], "new": []}
        for which in ("base", "new", "new", "base"):
            _build._lib = libs[which]
            ms[which].append(time_ms(lambda: calls[which](a)))
        return ms

    def record(kernel, label, ms, **extra):
        print(json.dumps({"kernel": kernel, "shape": label, **extra,
                          **{f"{w}_ms": v for w, v in ms.items()},
                          "new_over_base": float(np.mean(ms["new"]) / np.mean(ms["base"]))}),
              flush=True)
        tot = sums.setdefault(kernel, {"base_ms": 0.0, "new_ms": 0.0})
        for w, v in ms.items():
            tot[f"{w}_ms"] += float(np.mean(v))

    def outputs(calls, a):
        """Each build's outputs of calls[build](a)."""
        outs = {}
        for which, lib in libs.items():
            _build._lib = lib
            outs[which] = _tuple(calls[which](a))
        return outs

    def equal(outs):
        return all(torch.equal(u, v) for u, v in zip(outs["base"], outs["new"]))

    def same_in(calls, a, dtypes):
        return {dt: equal(outputs(calls, a.to(dt))) for dt in dtypes}

    def held(kernel, label, calls, plains, a, kind):
        """Each build's bf16 readings against the plain version; failures
        are collected."""
        readings = {}
        for which, lib in libs.items():
            _build._lib = lib
            readings[which], failed = bf16_check(calls[which], plains[which], a, kind)
            failures.extend(f"{which} build {kernel} [{label}] {f}" for f in failed)
        return readings

    both = (torch.float32, torch.bfloat16)
    for kernel, label, x3, call, plain, kind in _redesigned_fwd_calls(dev, gen):
        calls = {w: call for w in libs}
        same = same_in(calls, x3, both)
        readings = held(kernel, label, calls, {w: plain for w in libs}, x3, kind)
        record(kernel, label, in_turns(calls, x3.to(torch.bfloat16)),
               fp32_bit_identical=same[torch.float32], bf16_bit_identical=same[torch.bfloat16],
               bf16=readings)
        differ += [] if same[torch.float32] else [f"{kernel} [{label}] fp32"]
    for kernel, label, x3, call, plain, kind in _shared_bwd_calls(dev, gen):
        calls = {w: call for w in libs}
        same = same_in(calls, x3, both)
        readings = held(kernel, label, calls, {w: plain for w in libs}, x3, kind)
        record(kernel, label, in_turns(calls, x3.to(torch.bfloat16)),
               fp32_bit_identical=same[torch.float32], bf16_bit_identical=same[torch.bfloat16],
               bf16=readings)
        differ += [f"{kernel} [{label}] {str(dt)[6:]}" for dt, ok in same.items() if not ok]
    for kernel, label, qkv, calls, kind in _tiled_calls(dev, gen):
        pairs = {w: calls() for w in libs}        # each build's backward from its own stats
        kernel_calls = {w: c for w, (c, _) in pairs.items()}
        same = same_in(kernel_calls, qkv, both)
        readings = held(kernel, label, kernel_calls, {w: pl for w, (_, pl) in pairs.items()}, qkv,
                        kind)
        record(kernel, label, in_turns(kernel_calls, qkv.to(torch.bfloat16)),
               fp32_bit_identical=same[torch.float32], bf16_bit_identical=same[torch.bfloat16],
               bf16=readings)
        differ += [f"{kernel} [{label}] {str(dt)[6:]}" for dt, ok in same.items() if not ok]
    for kernel, label, rows, c, eps, work in _ln_sites():
        x, _, g, bt = _ln_inputs(dev, gen, rows, c)
        if kernel.endswith("_bwd"):
            dy = _bf16_values(torch.randn(rows, c, device=dev, generator=gen))
            call, plain, _ = _ln_bwd_calls(g, dy, eps, c)
        else:
            call, plain, _ = _ln_fwd_calls(g, bt, eps, c)
        kind = "layer_norm_bwd" if kernel.endswith("_bwd") else "layer_norm"
        readings = {}
        for which, lib in libs.items():
            _build._lib = lib
            readings[which], failed = full_check(call, plain, x, kind)
            failures.extend(f"{which} build {kernel} [{label}] {f}" for f in failed)
        record(kernel, label, in_turns({w: call for w in libs}, x.to(work)),
               dtype=str(work)[6:], new_body=ln._ln_body(work, c, kind == "layer_norm_bwd"),
               checks=readings)
        del x, g, bt
    steps = {}
    for label, one_step in _step_calls(dev):
        ms = {"base": [], "new": []}
        for which in ("base", "new"):
            _build._lib = libs[which]
            one_step()                                  # warm-up
        for which in ("base", "new", "new", "base"):
            _build._lib = libs[which]
            for _ in range(STEP_TURNS):
                t0 = time.perf_counter()
                one_step()
                ms[which].append((time.perf_counter() - t0) * 1e3)
        steps[label] = {**{f"{w}_ms_median": float(np.median(v)) for w, v in ms.items()},
                        **{f"{w}_ms": v for w, v in ms.items()}}
        steps[label]["new_minus_base_ms"] = (steps[label]["new_ms_median"]
                                             - steps[label]["base_ms_median"])
        kernel_ms = {"base": [], "new": []}
        for which in ("base", "new", "new", "base"):
            _build._lib = libs[which]
            kernel_ms[which].append(_kernel_ms(one_step))
        for which, kms in kernel_ms.items():
            steps[label][f"{which}_kernel_ms_each"] = kms
            steps[label][f"{which}_kernel_ms"] = float(np.mean(kms))
            steps[label][f"{which}_device_idle_share"] = 1 - np.mean(kms) / steps[label][
                f"{which}_ms_median"]
        print(json.dumps({"step": label, **steps[label]}), flush=True)
        del one_step
        torch.cuda.empty_cache()
    _build._lib = libs["new"]
    for tot in sums.values():
        tot["new_over_base"] = tot["new_ms"] / tot["base_ms"]
    print(json.dumps({"compare_build": str(base_csrc), "per_kernel": sums,
                      "steps": {k: {w: v[w] for w in (
                          "base_ms_median", "new_ms_median", "new_minus_base_ms",
                          "base_kernel_ms", "new_kernel_ms", "base_device_idle_share",
                          "new_device_idle_share")} for k, v in steps.items()}}), flush=True)
    require(not differ, f"outputs differ from the base build: {differ}")
    require(not failures, f"bf16 limits exceeded: {failures}")


def kernels_line(recs, runs):
    """The ``kernels`` line: per kernel, times summed over its main-path
    shapes (one call of each; the records marked off_path are left out of
    the sums, unless the kernel has no other, as the split entries), the
    largest errors over every shape checked, and ``launches``: those of the
    first run in ``runs`` (name -> launch counts of one step or call, in
    order: the 2d_feature step, the pixel step, the swin2d step, the violet
    step, the multiple-choice step, one eval, one multiple-choice eval, the
    3d_feature, 2d_clip, hog, depth, vq (on the fly, pre-extracted) and
    optical_flow steps, the smtm step, the lanebench tool's run, the
    fine-tune steps and evals of phases 26-30, then the caption step and
    one call of each decoder, phases 32 and 34, the loader-fed steps of
    phases 37-38, the CLIs' steps of phase 40, and the steps, decoder and
    CLIs of phases 45-51) that launched the kernel, each run's beside it as
    ``launches_<name>``."""
    line = []
    for name, meta in KERNELS.items():
        checked = [r for r in recs if r["kernel"] == name]
        mine = [r for r in checked if not r.get("off_path")] or checked
        tot = {k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        ops_bound = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        bf16 = {k: max(r[k] for r in checked if k in r) for k in checked[0]
                if k.startswith(("max_abs_err_bf16", "mismatch_bf16", "over_one_step_bf16",
                                 "share_over_one_step_bf16"))}
        # the window kernels: each shape weighted by its blocks in a step
        step = {f"{k}_step": sum(r[k] * r["launches_per_step"] for r in mine)
                for k in tot} if "launches_per_step" in mine[0] else {}
        # rows 4, 6, 8-11: the body each dtype ran (tensor_core or cuda_core)
        body = {"body": {k: v for r in checked for k, v in r["body"].items()}} if (
            "body" in checked[0]) else {}
        line.append({"name": name, "route": "cuda", **meta,
                     "launches": next((n[name] for n in runs.values() if n.get(name)), 0),
                     **{f"launches_{run}": n.get(name, 0) for run, n in runs.items()},
                     "max_abs_err": max(r["max_abs_err"] for r in checked), **bf16,
                     "ms": tot["ms"], "kernel_ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": tot["bound_ms"],
                     "bound_by": "operations" if ops_bound > tot["bound_ms"] / 2 else "bytes",
                     "library_ms": tot["library_ms"], **step, **body, "shapes": len(mine),
                     "shapes_checked": len(checked)})
    return line


# ---------------------------------------------------------------------------
# phases 45-48: the swin2d-tiny, ResNet-50 and MERLOT backbones, am masking
# ---------------------------------------------------------------------------

# The whole steps on the R50 and MERLOT backbones shift every BatchNorm bias
# by R50_BN_SHIFT before card and CPU take the same weights. At init (biases
# 0) many ReLU inputs lie within fp32 roundoff of 0; one that flips on one
# side only moves the gradient of the channel it feeds by a term of its sum,
# 2-30 % of a tensor's largest element, as much between the port in fp32
# and in fp64 on the CPU as between the port and JAX
# (tests/test_torch_encoders2d.py).
R50_BN_SHIFT = 3.0
MERLOT_CUT = dict(vit_depth=2)  # the merlot whole step's ViT blocks (phase 47)
R50_WHOLE_B = 2                 # clips of the r50 and merlot whole steps
# the running statistics after a step against the torch rule recomputed on
# the host from the card's batch statistics: the card's fp32 fold rounds
# twice (rtol); the stem BatchNorm's statistics recomputed on the host in
# fp64 from its input, 1e6 values a channel summed in fp32 on the card
BN_FOLD_RTOL, BN_STAT_RTOL = 1e-6, 1e-4
AM_MASKS = ("am", "rm")         # phase 48's pretrain_masks
AM_DRAWS = 512                  # draws of one row for the selection frequencies
# Spearman's rho between the slots' selection frequency over AM_DRAWS draws
# and their scores, on scores spread as exp(U(-3, 3)): Gumbel top-k includes
# a slot more often the higher its score, and the CPU rehearsal reads 0.99
AM_SPEARMAN = 0.9


def with_2d_backbone(run, vis_backbone, **changes):
    """``run`` with a 2D backbone (``swin2d``, ``r50``, ``merlot``), concat
    fusion unless ``changes`` say otherwise."""
    return dataclasses.replace(run, model=dataclasses.replace(
        run.model, vis_backbone=vis_backbone, **{"temporal_fusion": "concat", **changes}))


def with_pretrain_masks(run, masks):
    """``run`` with ``train.pretrain_masks`` replaced."""
    return dataclasses.replace(run, train=dataclasses.replace(run.train, pretrain_masks=masks))


def shift_bn_biases(model):
    """Add ``R50_BN_SHIFT`` to every BatchNorm bias of ``model`` (none
    without an R50)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.bias.add_(R50_BN_SHIFT)


def _ranks(x):
    """Ranks from 0, ties averaged."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x))
    ranks[order] = np.arange(len(x))
    _, inverse, counts = np.unique(x, return_inverse=True, return_counts=True)
    sums = np.bincount(inverse, weights=ranks)
    return sums[inverse] / counts[inverse]


def spearman(a, b):
    """Spearman's rank correlation of two 1-D arrays."""
    return float(np.corrcoef(_ranks(np.asarray(a)), _ranks(np.asarray(b)))[0, 1])


def bn_fold_check(dev, run):
    """Phase 46: the r50 step's running statistics (``r50_train_bn``) after
    each of two steps, against the torch rule (0.9 running + 0.1 batch)
    recomputed on the host in fp64 from the batch statistics each BatchNorm
    computed on the card (forward hooks), within ``BN_FOLD_RTOL`` of each
    tensor's largest value; the stem
    BatchNorm's batch statistics recomputed on the host from its input,
    within ``BN_STAT_RTOL``. No running statistic is a parameter, so none is
    in an optimizer group, and weight decay cannot reach it; the JAX
    package's decay, which would, is printed at each step's lr."""
    model = VioletPretrain.from_run_config(run, dtype=torch.bfloat16, device=dev,
                                           seed=TRAIN_SEED)
    opt = build_optimizer(model, run.train, TRAIN_MAX_ITER)
    state = create_train_state(model, opt)
    step = make_pretrain_train_step(model, opt)
    batch = synthetic_pretrain_batch(run.train.size_batch, run.model, seed=3, device=dev)
    require(not set(state.buffers) & set(opt.labels) and len(state.buffers) == 2 * 53,
            f"running statistics: {len(state.buffers)}, in the optimizer: "
            f"{sorted(set(state.buffers) & set(opt.labels))[:4]}")
    captured, stem_in = {}, []
    handles = [m.register_forward_hook(
        lambda m, args, out, n=n: captured.__setitem__(n, tuple(t.double().cpu()
                                                               for t in m.batch_stats)))
        for n, m in model.named_modules() if isinstance(m, BatchNorm2d)]
    handles.append(model.enc_img.res.bn1.register_forward_hook(
        lambda m, args, out: stem_in.append(args[0].detach().double().cpu())))
    fold, stats, decay = [], [], []
    for i in range(2):
        before = {k: v.double().cpu() for k, v in state.buffers.items()}
        captured.clear()
        stem_in.clear()
        state, _ = step(state, batch, TRAIN_SEED)
        torch.cuda.synchronize(dev)
        worst = 0.0
        for name, pair in captured.items():
            for leaf, stat in zip(("running_mean", "running_var"), pair):
                k = f"{name}.{leaf}"
                want = 0.9 * before[k] + 0.1 * stat
                d = (state.buffers[k].double().cpu() - want).abs().max()
                worst = max(worst, d.item() / want.abs().max().item())
        fold.append(worst)
        x = stem_in[0].reshape(-1, stem_in[0].shape[-1])
        mean, var = captured["enc_img.res.bn1"]
        stats.append(max(((mean - x.mean(0)).abs() / x.std(0)).max().item(),
                         ((var - x.var(0)).abs() / x.var(0)).max().item()))
        lr = opt.schedules["other_decay"](i)
        decay.append(0.9 * lr * run.train.decay * max(v.abs().max().item()
                                                       for v in before.values()))
    for h in handles:
        h.remove()
    print(json.dumps({"r50_running_statistics": {
        "batch_norms": len(captured), "steps": 2, "fold_max_rel_diff_each_step": fold,
        "fold_rtol": BN_FOLD_RTOL, "stem_stats_vs_host_fp64_each_step": stats,
        "stem_stats_rtol": BN_STAT_RTOL, "in_optimizer_groups": 0,
        "jax_weight_decay_would_move_by_each_step": decay}}), flush=True)
    require(len(captured) == 53 and max(fold) <= BN_FOLD_RTOL,
            f"running statistics against the torch rule: {fold}")
    require(max(stats) <= BN_STAT_RTOL, f"stem batch statistics against the host: {stats}")


def am_draw_phase(dev, run):
    """Phase 48's draw: the rollout (``get_att``) of the full-width model on
    the pixel step's batch, its device ms (CUDA events, median of 5), one
    ``am`` draw from it in which every row masks exactly k = max(floor(L p),
    1) slots and none special; then ``AM_DRAWS`` draws of one row on scores
    spread as exp(U(-3, 3)) over its slots: Spearman's rho between each
    non-special slot's selection frequency and its score at least
    ``AM_SPEARMAN`` (printed also on the rollout's own scores, which a
    random-weight fusion spreads little, without a limit)."""
    cfg, b = run.model, run.train.size_batch
    model = VioletPretrain.from_run_config(run, dtype=torch.bfloat16, device=dev,
                                           seed=TRAIN_SEED)
    batch = synthetic_pretrain_batch(b, cfg, seed=3, device=dev)
    img = maybe_normalize(batch["img"])
    scores = model.get_att(img, batch["txt"], batch["mask"])
    rollout_ms = float(np.median([_event_ms(lambda: model.get_att(img, batch["txt"],
                                                                  batch["mask"]))
                                  for _ in range(5)]))
    t, hw = cfg.size_frame, cfg.size_img // cfg.size_patch
    kw = dict(special_token_ids=VioletPretrain.special_token_ids,
              mask_token_id=VioletPretrain.mask_token_id, p_mask=run.train.p_mask,
              mask_types=("am",))
    gen = torch.Generator(dev).manual_seed(9)
    spc = special_tokens(batch["txt"], kw["special_token_ids"], kw["mask_token_id"])
    d = draw_masks(gen, batch["txt"], t, hw, hw, att_scores=scores, **kw)
    lv, l = t * (1 + hw * hw), scores.shape[1]
    k = max(int(l * run.train.p_mask), 1)
    counts = (d.covs[0].sum((1, 2, 3)) + d.txt_sel[0].sum(1)).long().tolist()
    on_special = int((d.txt_sel[0] & spc).sum())

    def frequencies(row_scores):
        rows = row_scores.expand(AM_DRAWS, l)
        dr = draw_masks(gen, batch["txt"][:1].expand(AM_DRAWS, -1), t, hw, hw,
                        att_scores=rows, **kw)
        video = torch.cat([torch.zeros(AM_DRAWS, t, 1, device=dev),
                           dr.covs[0].reshape(AM_DRAWS, t, -1)], dim=2).reshape(AM_DRAWS, lv)
        sel = torch.cat([video, dr.txt_sel[0].float()], dim=1)
        return sel.mean(0).cpu().numpy(), int(sel.sum(1).min()), int(sel.sum(1).max())

    keep = ~am_special(spc[:1], t, hw, hw)[0].cpu().numpy()
    spread = torch.exp(torch.empty(l, device=dev).uniform_(-3.0, 3.0, generator=gen))
    freq, lo, hi = frequencies(spread)
    rho = spearman(freq[keep], spread.cpu().numpy()[keep])
    freq_model, _, _ = frequencies(scores[0])
    rho_model = spearman(freq_model[keep], scores[0].float().cpu().numpy()[keep])
    s0 = scores[0].float().cpu().numpy()[keep]
    print(json.dumps({"am_draw": {
        "rollout_ms": rollout_ms, "rollout_shape": list(scores.shape), "k": k,
        "masked_slots_each_row": counts, "masked_special_slots": on_special,
        "draws": AM_DRAWS, "spearman_spread_scores": rho, "spearman_limit": AM_SPEARMAN,
        "masked_slots_range_spread_scores": [lo, hi],
        "spearman_rollout_scores": rho_model,
        "rollout_score_range": [float(s0.min()), float(s0.max())]}}), flush=True)
    require(all(c == k for c in counts) and on_special == 0 and lo == hi == k,
            f"am rows mask {counts} slots (k = {k}), {on_special} special")
    require(rho >= AM_SPEARMAN, f"am selection frequency against the scores: rho {rho}")
    return rollout_ms


def backbone_phases(dev, run, pixel):
    """Phases 45-48 at full width in bf16 on configs/pretrain.json's shapes:
    the swin2d-tiny pixel step and its whole step (row 9 at N = 49 in stages
    0-1); the r50 pixel step (concat, ``r50_train_bn``), its running
    statistics (``bn_fold_check``) and whole step, and the r50 ``nce``
    retrieval step (mean fusion); the merlot pixel step and its whole step
    (the ViT cut to ``MERLOT_CUT``); the pixel step with ``AM_MASKS`` and
    its draw (``am_draw_phase``), its wall beside phase 6's (``pixel``, the
    record of ``train_phase``). Returns each step's launches."""
    out, rec = {}, {}
    # 45. the 2D Swin-tiny backbone
    run_tiny = with_2d_backbone(run, "swin2d", vis_backbone_size="tiny")
    out["train_step_swin2d_tiny"] = train_phase(dev, run_tiny, TRAIN_SWIN2D_TINY_LAUNCHES)
    torch.cuda.empty_cache()
    whole_step_phase(dev, run_tiny)
    torch.cuda.empty_cache()
    # 46. the ResNet-50 backbone with train-mode BatchNorm, and its nce step
    run_r50 = with_2d_backbone(run, "r50", r50_train_bn=True)
    out["train_step_r50"] = train_phase(dev, run_r50, TRAIN_R50_LAUNCHES)
    torch.cuda.empty_cache()
    bn_fold_check(dev, run_r50)
    torch.cuda.empty_cache()
    whole_step_phase(dev, run_r50, b=R50_WHOLE_B)
    torch.cuda.empty_cache()
    run_ret = load_run_config(str(RET_CONFIG))
    run_ret = with_2d_backbone(run_ret, "r50", temporal_fusion="mean", r50_train_bn=True)
    out["train_step_retrieval_r50"], model = finetune_phase(
        dev, "retrieval_r50", RET_CONFIG, run_ret,
        VioletRetrieval(run_ret.model, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED), "nce",
        "retrieval", TRAIN_RET_R50_LAUNCHES, zero_ok={SCORE_OUT_BIAS})
    del model
    torch.cuda.empty_cache()
    # 47. the MERLOT backbone (R50 + a trained ViT-base per frame)
    run_merlot = with_2d_backbone(run, "merlot", r50_train_bn=True)
    out["train_step_merlot"] = train_phase(dev, run_merlot, TRAIN_MERLOT_LAUNCHES)
    torch.cuda.empty_cache()
    whole_step_phase(dev, run_merlot, b=R50_WHOLE_B)
    torch.cuda.empty_cache()
    # 48. am masking on the pixel step: the rollout, the draw, the step
    run_am = with_pretrain_masks(run, AM_MASKS)
    out["train_step_am"] = train_phase(dev, run_am, TRAIN_AM_LAUNCHES, record=rec)
    torch.cuda.empty_cache()
    _beside_pixel("am", rec, pixel, rollout_ms=am_draw_phase(dev, run_am))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 49-51: the text encoder stack, the SwinBERT layout, the Video Swin's
# in-block dropouts
# ---------------------------------------------------------------------------

# the text stack's pretrain step (phase 49) adds BERT-base over the 20
# captions of 32 tokens before the fusion, in training: row 5 with dropout
# and row 6 in each of its 12 layers, the LayerNorm kernel at its 24 sites,
# forward and backward
TRAIN_STACK_LAUNCHES = {**TRAIN_LAUNCHES, "fused_layer_norm": 27 + 24,
                        "fused_layer_norm_bwd": 27 + 24, "lane_self_attention_dropout": 12 + 12,
                        "lane_self_attention_bwd": 12 + 12}
# the SwinBERT caption step (phase 50): EncVideo has no norm in SwinBERT's
# layout, so the LayerNorm kernel runs at 26 sites; the rest is the caption
# step's. Its greedy re-encoding decoder: generate_launches without that norm
CAPTION_SWINBERT_LAUNCHES = {**CAPTION_LAUNCHES, "fused_layer_norm": 26,
                             "fused_layer_norm_bwd": 26}
# the pixel step with the Swin's in-block dropouts (phase 51) at a probe rate
# (no shipped config sets them): drop_rate alone keeps the direct kernels
# (TRAIN_LAUNCHES); attn_drop_rate sends every window attention to
# window_attention_xla, as JAX sends it to its XLA branch, and rows 3-4
# launch no time
SWIN_DROP = 0.1
TRAIN_SWIN_ATTN_DROP_LAUNCHES = {k: v for k, v in TRAIN_LAUNCHES.items()
                                 if not k.startswith("direct_window_attention")}
SWIN_KEEP_B = 4                 # clips of phase 51's keep-fraction pass


def with_model(run, **changes):
    """``run`` with ``changes`` to its model config."""
    return dataclasses.replace(run, model=dataclasses.replace(run.model, **changes))


def with_swin_rates(run, drop, attn_drop):
    """``run`` with the Video Swin's ``drop_rate`` and ``attn_drop_rate`` set
    (``swin_custom``, as a user sets them)."""
    return with_model(run, swin_custom=dataclasses.replace(
        backbone_config(run.model), drop_rate=drop, attn_drop_rate=attn_drop))


def swinbert_names(sd):
    """A caption model's ``state_dict`` under SwinBERT's key names: the
    inverse of ``remap_swinbert_keys``, the MLM decoder's bias as HF's tied
    ``cls.predictions.bias``."""
    renames = (("enc_img.swin.", "swin.backbone."), ("enc_img.fc.", "fc."),
               ("enc_img.img_embedding.", "trans_encoder.bert.img_embedding."),
               ("enc_txt.emb_txt.", "trans_encoder.bert.embeddings."),
               ("trsfr.", "trans_encoder.bert.encoder."),
               ("fc_mtm.predictions.decoder.bias", "trans_encoder.cls.predictions.bias"),
               ("fc_mtm.", "trans_encoder.cls."))
    out = {}
    for k, v in sd.items():
        port, theirs = next(r for r in renames if k.startswith(r[0]))
        out[theirs + k[len(port):]] = v
    return out


def swin_routes(swin, frames, size_img):
    """The route of each block's window attention (``WindowAttention3D.route``)
    for clips of ``frames`` frames of ``size_img``^2, counted by route."""
    with torch.device("meta"):
        model = SwinTransformer3D(swin)
    routes, hw = collections.Counter(), size_img // swin.patch_size[1]
    for i, layer in enumerate(model.layers):
        side = -(-hw // 2 ** i)
        window, _ = get_window_size((frames, side, side), layer.window_size, layer.window_size)
        dp = -(-frames // window[0]) * window[0]
        routes.update(blk.attn.route(dp, window[0]) for blk in layer.blocks)
    return dict(routes)


class SameDraws:
    """The Video Swin's dropout (``models/video_swin.dropout``) with its keep
    masks drawn from a seeded CPU generator: the card's step draws and keeps
    them, the CPU's step after it takes the same masks in the same order."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.masks, self.taken = [], 0

    def __call__(self, x, p, generator):
        if generator is None or p == 0.0:
            return x
        if x.device.type == "cuda":
            self.masks.append(torch.rand(x.shape, generator=self.gen) >= p)
            keep = self.masks[-1].to(x.device)
        else:
            keep, self.taken = self.masks[self.taken], self.taken + 1
        return torch.where(keep, x / (1.0 - p), x.new_zeros(()))


def swin_keep_fraction(dev, swin, frames, size_img):
    """The Swin's dropout sites in one no-grad training pass of the backbone
    (bf16, ``SWIN_KEEP_B`` seeded clips): each site's rate, their count, and
    the kept share of the elements whose input is not 0, which must lie
    within ``KEEP_SIGMAS`` sigma of 1 - rate."""
    counts = []
    real = video_swin_module.dropout

    def spy(x, p, generator):
        out = real(x, p, generator)
        if generator is not None and p > 0.0:
            seen = x != 0
            counts.append((p, int((out != 0)[seen].sum()), int(seen.sum())))
        return out

    model = SwinTransformer3D(swin, torch.bfloat16).to(dev)
    img = torch.randn(SWIN_KEEP_B, frames, size_img, size_img, 3, device=dev,
                      generator=torch.Generator(dev).manual_seed(13))
    with mock.patch.object(video_swin_module, "dropout", spy), torch.no_grad():
        model(img, torch.Generator(dev).manual_seed(14))
    del model
    kept, total = sum(c[1] for c in counts), sum(c[2] for c in counts)
    rate = counts[0][0]
    sigma = (rate * (1 - rate) / total) ** 0.5
    rec = {"sites": len(counts), "rates": sorted({c[0] for c in counts}),
           "keep_fraction": kept / total, "expected": 1 - rate, "sigma": sigma,
           "elements": total}
    print(json.dumps({"swin_dropout_keep_fraction": rec}), flush=True)
    blocks = sum(swin.depths)
    sites = 1 + (4 if swin.attn_drop_rate else 3) * blocks
    require(len(counts) == sites and rec["rates"] == [rate]
            and abs(kept / total - (1 - rate)) <= KEEP_SIGMAS * sigma,
            f"the Swin's dropout sites: {rec}, {sites} sites expected")


def phase40_data() -> Path:
    """The directory of phase 40's pretrain shards and downstream videos."""
    data_dir = _build.BUILD_DIR / "smoke_data" / "cli"
    require((data_dir / "webvid2.5m_val_0.tsv").exists(), f"no phase 40 data in {data_dir}")
    return data_dir


def _beside_pixel(name, rec, pixel, **extra):
    """Print a step's record (``train_phase``'s ``record``) beside phase 6's."""
    print(json.dumps({f"{name}_step_against_pixel_step": {
        f"{name}_step_ms": rec["step_ms_median"], "pixel_step_ms": pixel["step_ms_median"],
        "ratio": rec["step_ms_median"] / pixel["step_ms_median"],
        f"{name}_kernel_ms": rec["kernel_ms"], "pixel_kernel_ms": pixel["kernel_ms"],
        **extra}}), flush=True)


def text_stack_phase(dev, run, pixel):
    """Phase 49: the pixel step at configs/pretrain.json with the text stack
    (``txt_backbone_embed_only`` false: BERT-base over the captions before
    the fusion; ``TRAIN_STACK_LAUNCHES``) beside phase 6's (``pixel``), its
    whole step as phase 7 (the stack cut to 2 layers); then the user flow:
    ``cli.pretrain`` with the stack on phase 40's shards for one epoch from
    a seeded-bias checkpoint, and ``cli.retrieval_eval`` on its final
    checkpoint with msrvtt-retrieval's config, which has no such key: the
    eval adopts ``txt_backbone_embed_only`` from the run's ``args.json`` and
    loads every leaf of the stack. Returns the launches by run."""
    out, rec = {}, {}
    run_stack = with_model(run, txt_backbone_embed_only=False)
    out["train_step_text_stack"] = train_phase(dev, run_stack, TRAIN_STACK_LAUNCHES, record=rec)
    _beside_pixel("text_stack", rec, pixel)
    torch.cuda.empty_cache()
    whole_step_phase(dev, run_stack)
    torch.cuda.empty_cache()

    data_dir = phase40_data()
    out_dir = str(data_dir / "runs_text_stack")
    cfg = _cli_config(PRETRAIN_CONFIG, "pretrain_text_stack", data_dir=str(data_dir),
                      path_output=out_dir, txt_backbone_embed_only=False)
    run_p = load_run_config(cfg)
    init = pretrain_cli.build_model(run_p, load_tokenizer(run_p.data.tokenizer), dev)
    seeded_biases(init, TRAIN_SEED)
    init_ckpt = str(data_dir / "init_text_stack.msgpack")
    save_params(init, init_ckpt)
    del init
    torch.cuda.empty_cache()
    probe = StepProbe(frames=run.model.size_frame)
    t0 = time.perf_counter()
    with probe_steps(probe):
        res = pretrain_cli.main(["--config", cfg, "--path_ckpt", init_ckpt, "--size_epoch", "1"],
                                device=dev)
    print(json.dumps({"cli": "pretrain_text_stack", "seconds": time.perf_counter() - t0,
                      "steps": res["steps"]}), flush=True)
    _load_complete("pretrain_text_stack", res["load"])
    eval_every = max(res["steps_per_epoch"] // 2, 1)
    out["cli_pretrain_text_stack"] = _cli_step_line(
        "pretrain_text_stack", res, probe, TRAIN_STACK_LAUNCHES, rec["step_ms_median"],
        "phase 49 (synthetic)",
        skip={i for i in range(len(probe.starts)) if (i + 1) % eval_every == 0})
    final = Path(res["run_dir"]) / f"ckpt_violet_pretrain_final_{res['steps']}.msgpack"
    torch.cuda.empty_cache()
    ret_cfg = _cli_config(RET_CONFIG, "msrvtt-retrieval_text_stack", data_dir=str(data_dir),
                          path_output=out_dir)
    require("txt_backbone_embed_only" not in json.loads(Path(ret_cfg).read_text()),
            "the eval's config names the text stack itself")
    t0 = time.perf_counter()
    m = retrieval_eval_cli.main(["--config", ret_cfg, "--path_ckpt", str(final)], device=dev)
    adopted = json.loads((Path(m["run_dir"]) / "args.json").read_text())["model"]
    stack = [k for k in m["load"]["loaded"] if k.startswith("enc_txt.txt_trsfr.")]
    print(json.dumps({"cli": "retrieval_eval_text_stack", "seconds": time.perf_counter() - t0,
                      "adopted_txt_backbone_embed_only": adopted["txt_backbone_embed_only"],
                      "text_stack_leaves_loaded": len(stack),
                      **{k: m[k] for k in ("split", "r1", "r5", "r10", "medr")}}), flush=True)
    _load_complete("retrieval_eval_text_stack", m["load"])
    layers = run.model.text.num_hidden_layers
    require(adopted["txt_backbone_embed_only"] is False and len(stack) == 16 * layers
            and 1.0 <= m["medr"], f"retrieval_eval on the text-stack checkpoint: {m}")
    torch.cuda.empty_cache()
    return out


def swinbert_phase(dev):
    """Phase 50: the caption step at configs/caption.json in SwinBERT's
    layout (``swinbert``: each frame's first video token a zero fake CLS
    with mask 0, so the fusion's 8 rows of 5 x 50 + 25 run rows 5-6 under a
    seq2seq mask with a hole in each frame's first key;
    ``CAPTION_SWINBERT_LAUNCHES``), its greedy re-encoding decoder at
    ``GEN_MAX_LEN`` (bf16 captions/s and launches; in fp32 its tokens
    against the K/V-cached decoder's, as phase 34), then ``cli.caption``
    for one epoch on phase 40's data from a ``*SwinBERT*.pt`` written from a
    seeded model under SwinBERT's names (every leaf loaded, ``img_embedding``
    among them), and the whole step as phase 33. Returns the launches."""
    run = with_model(load_run_config(str(CAPTION_CONFIG)), swinbert=True)
    cfg = run.model
    out = {}
    out["train_step_caption_swinbert"], model = finetune_phase(
        dev, "caption_swinbert", CAPTION_CONFIG, run,
        VioletCaptioning(cfg, dtype=torch.bfloat16, device=dev, seed=TRAIN_SEED), "caption",
        "caption", CAPTION_SWINBERT_LAUNCHES)
    torch.cuda.empty_cache()
    b = run.train.size_batch
    rs = np.random.RandomState(15)
    img = torch.from_numpy(rs.randint(0, 256, (b, cfg.size_frame, cfg.size_img, cfg.size_img,
                                               3)).astype(np.uint8)).to(dev)
    rec, tokens = capbench.bench(model, img, "full", GEN_ITERS, max_len=GEN_MAX_LEN)
    want = generate_launches(False)
    want["fused_layer_norm"] -= 1                    # no EncVideo norm in this layout
    m32 = VioletCaptioning(cfg, dtype=torch.float32, device=dev)
    m32.load_state_dict(model.state_dict())
    full32 = m32.generate(img, GEN_MAX_LEN).cpu()
    diff = capbench.first_difference_margin(m32, img, full32,
                                            m32.generate_cached(img, GEN_MAX_LEN).cpu())
    print(json.dumps({"slice": "caption_generation_swinbert", "batch": b, "max_len": GEN_MAX_LEN,
                      "record": rec, "fp32_identical": diff is None,
                      "fp32_first_difference": diff}), flush=True)
    ended = (tokens == model.sep_token_id).cumsum(1) > 0
    require(rec["launches"] == want,
            f"launches of one SwinBERT decode {rec['launches']}, not {want}")
    require(tokens.shape == (b, GEN_MAX_LEN) and bool((tokens[:, 0] == model.cls_token_id).all())
            and bool((tokens[ended & (tokens != model.sep_token_id)]
                      == model.pad_token_id).all()), f"SwinBERT captions {tokens.tolist()}")
    require(diff is None or diff["margin"] < GREEDY_TIE_MARGIN,
            f"fp32 greedy decoders differ beyond a tie: {diff}")
    out["generate_swinbert_uncached"] = rec["launches"]
    del m32, model
    torch.cuda.empty_cache()

    data_dir = phase40_data()
    src = VioletCaptioning(cfg, dtype=torch.float32, device=dev, seed=TRAIN_SEED + 1)
    seeded_biases(src, TRAIN_SEED + 1)
    pt = data_dir / "swinbert_caption_SwinBERT.pt"
    torch.save(swinbert_names({k: v.cpu() for k, v in src.state_dict().items()}), pt)
    expected = set(src.state_dict())
    del src
    torch.cuda.empty_cache()
    cli_cfg = _cli_config(CAPTION_CONFIG, "caption_swinbert", data_dir=str(data_dir),
                          path_output=str(data_dir / "runs_swinbert"), swinbert=True)
    probe = StepProbe()
    t0 = time.perf_counter()
    with probe_steps(probe):
        res = caption_cli.main(["--config", cli_cfg, "--path_ckpt", str(pt), "--size_epoch", "1"],
                               device=dev)
    log = json.loads((Path(res["run_dir"]) / "log.json").read_text())
    print(json.dumps({"cli": "caption_swinbert", "seconds": time.perf_counter() - t0,
                      "log": log, "load": {k: len(v) for k, v in res["load"].items()}}),
          flush=True)
    _load_complete("caption_swinbert", res["load"])
    require(set(res["load"]["loaded"]) == expected and not res["load"]["kept"],
            f"caption_swinbert: kept at init {res['load']['kept'][:5]}")
    for split in ("ac_vl", "ac_ts"):
        sc = log[split][-1]
        require(all(0.0 <= sc[k] <= 100.0 for k in ("bleu4", "rouge_l", "meteor"))
                and sc["cider"] >= 0.0, f"caption_swinbert {split} scores {sc}")
    out["cli_caption_swinbert"] = _cli_step_line(
        "caption_swinbert", res, probe, CAPTION_SWINBERT_LAUNCHES, STEP_MS["caption_swinbert"],
        "phase 50 (synthetic)")
    torch.cuda.empty_cache()
    finetune_whole_step_phase(dev, "caption_swinbert", run,
                              lambda c, dt, d: VioletCaptioning(c, dtype=dt, device=d, seed=1),
                              "caption", "caption")
    torch.cuda.empty_cache()
    return out


def swin_dropout_phase(dev, run, pixel):
    """Phase 51: the pixel step with the Video Swin's ``drop_rate`` at
    ``SWIN_DROP`` (the direct kernels on, ``TRAIN_LAUNCHES``), then with
    ``attn_drop_rate`` too (every window attention on window_attention_xla,
    ``TRAIN_SWIN_ATTN_DROP_LAUNCHES``), each beside phase 6's (``pixel``)
    with the route each block took; the dropout sites' keep fraction
    (``swin_keep_fraction``); each whole step as phase 7 with the same
    dropout masks on card and CPU (``SameDraws``). Returns the launches."""
    out = {}
    for name, attn_drop, want in (("swin_drop", 0.0, TRAIN_LAUNCHES),
                                  ("swin_attn_drop", SWIN_DROP, TRAIN_SWIN_ATTN_DROP_LAUNCHES)):
        r, rec = with_swin_rates(run, SWIN_DROP, attn_drop), {}
        routes = swin_routes(r.model.swin, r.model.size_frame, r.model.size_img)
        out[f"train_step_{name}"] = train_phase(dev, r, want, record=rec)
        _beside_pixel(name, rec, pixel, routes=routes, launches=out[f"train_step_{name}"])
        require(set(routes) == ({"xla"} if attn_drop else {"direct"}), f"{name} routes {routes}")
        torch.cuda.empty_cache()
        swin_keep_fraction(dev, r.model.swin, r.model.size_frame, r.model.size_img)
        torch.cuda.empty_cache()
        with mock.patch.object(video_swin_module, "dropout", SameDraws(16)):
            whole_step_phase(dev, r)
        torch.cuda.empty_cache()
    return out


def _nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare-build", type=Path, metavar="CSRC",
                        help="only compare the redesigned kernels (rows 1-12) with a "
                             "build of CSRC")
    parser.add_argument("--dp-worker", nargs=3, metavar=("DIR", "RANK", "WORLD"),
                        help=argparse.SUPPRESS)     # a rank of phase 42
    parser.add_argument("--pretrain-cli", nargs=3, metavar=("CONFIG", "CKPT", "OUT"),
                        help=argparse.SUPPRESS)     # phase 44's process
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's chip run needs a CUDA card")
    if args.compare_build:
        compare_builds(args.compare_build)
        return
    if args.dp_worker:
        dp_worker(args.dp_worker[0], int(args.dp_worker[1]), int(args.dp_worker[2]))
        return
    if args.pretrain_cli:
        pretrain_cli_worker(*args.pretrain_cli)
        return
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = _nvidia_smi()
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    so = _build.build(verbose=True)
    _build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against plain versions, at the main-path shapes; a limit
    # exceeded fails the run after the later phases have printed theirs
    gen = torch.Generator(dev).manual_seed(0)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    # the planted row-stride and suffix-mask copies (the seq2seq and SwinBERT
    # records' checks) build while the earlier records run
    row_stride = pool.submit(planted_row_stride_library)
    suffix_mask = pool.submit(planted_suffix_library)
    recs = (direct_cases(dev, gen, ITEMS * CLIPS, 5, "eval") + lane_case(dev, gen)
            + ln_cases(dev, gen, EVAL_LN, "eval")
            + direct_cases(dev, gen, TRAIN_B, TRAIN_T, "train")
            + ln_cases(dev, gen, TRAIN_LN, "train")
            + direct_bwd_cases(dev, gen) + lane_train_cases(dev, gen)
            + ln_bwd_cases(dev, gen)
            + lane_window_cases(dev, gen) + ln_cases(dev, gen, TEACHER_LN, "train teacher")
            + lane_window_bwd_cases(dev, gen) + packed_cases(dev, gen)
            + direct_cases(dev, gen, TRAIN_B, TRAIN_T, "violet train", SwinConfig.violet(),
                           (2, 3))
            + direct_bwd_cases(dev, gen, "violet ", SwinConfig.violet(), (2, 3))
            + direct_bwd_cases(dev, gen, "mc ", b=QAMC_B, t=5)
            + tiled_sa_cases(dev, gen)
            + ln_cases(dev, gen, TEACHER3D_LN[len(TEACHER_LN):], "train 3d teacher")
            + teacher_lane_case(dev, gen, "2d_clip", 50, 768, 12)
            + ln_cases(dev, gen, CLIP_LN, "train clip teacher")
            + teacher_lane_case(dev, gen, "depth", 197, 1024, 16)
            + ln_cases(dev, gen, DPT_LN, "train dpt teacher")
            + lane_attention_cases(dev, gen) + c128_cases(dev, gen)
            + lane_train_cases(dev, gen, *FINETUNE_LANE, path="retrieval ")
            + direct_cases(dev, gen, QAOE_B, 5, "qaoe")
            + direct_bwd_cases(dev, gen, "qaoe ", b=QAOE_B, t=5)
            + ln_cases(dev, gen, FINETUNE_LN, "finetune")
            + ln_bwd_cases(dev, gen, FINETUNE_LN, "finetune ", planted=False)
            + direct_cases(dev, gen, CAPTION_B, 5, "caption")
            + ln_cases(dev, gen, CAPTION_LN + SMTM_LN + DECODE_LN, "captioning")
            + ln_bwd_cases(dev, gen, CAPTION_LN + SMTM_LN, "captioning ", planted=False)
            + direct_cases(dev, gen, TRAIN_B, 1, "cc3m")
            + direct_bwd_cases(dev, gen, "cc3m ", t=1)
            + [r for label, p, l, text in LOADER_LANE
               for r in lane_train_cases(dev, gen, p, l, text, path=label)]
            + ln_cases(dev, gen, LOADER_LN, "loader")
            + ln_bwd_cases(dev, gen, LOADER_LN, "loader ", planted=False)
            + seq2seq_lane_cases(dev, gen, row_stride)
            + lane_window_cases(dev, gen, "tiny", (2, 3), "2d swin-tiny")
            + lane_window_bwd_cases(dev, gen, "tiny", (2, 3), "2d swin-tiny")
            + merlot_lane_cases(dev, gen) + ln_cases(dev, gen, MERLOT_LN, "merlot")
            + ln_bwd_cases(dev, gen, MERLOT_LN, "merlot ", planted=False)
            + lane_train_cases(dev, gen, *TEXT_STACK_LANE, path="text stack ")
            + ln_cases(dev, gen, TEXT_STACK_LN, "train")
            + ln_bwd_cases(dev, gen, TEXT_STACK_LN, "train ", planted=False)
            + swinbert_lane_cases(dev, gen, suffix_mask))
    pool.shutdown()
    failures = [f for r in recs for f in r.pop("failures")]
    print(json.dumps({"kernel_shapes": recs}), flush=True)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s; "
          f"{len(failures)} limit(s) exceeded", flush=True)

    # 4. the retrieval eval at full width
    cfg = load_run_config(str(CONFIG)).model
    model = VioletRetrieval(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    ds = SyntheticRetrievalDataset(ITEMS, CLIPS, cfg.size_frame, cfg.size_img,
                                   cfg.size_txt, cfg.text.vocab_size, seed=1)

    def run_eval():
        return retrieval_two_stage_eval(model, ds, chunk_size=CHUNK,
                                        encode_batch=ITEMS, device=dev)

    run_eval()                                  # warm-up: first launches, cuBLAS
    _build.launch_counts.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = run_eval()
    launches = dict(_build.launch_counts)
    runs = [metrics] + [run_eval() for _ in range(EVAL_REPEATS - 1)]
    clips_s = [m["_clips"] / m["_stage1_s"] for m in runs]
    pairs_s = [m["_pairs"] / m["_stage2_s"] for m in runs]
    print(f"eval launch counts: {launches}", flush=True)
    for name in EVAL_KERNELS:
        require(launches.get(name, 0) > 0, f"{name} was never launched on the eval path")
    for k in ("r1", "r5", "r10", "medr"):
        require(np.isfinite(metrics[k]), f"{k} is not finite: {metrics}")
        require(all(m[k] == metrics[k] for m in runs), f"{k} differs between evals")
    require(1.0 <= metrics["medr"] <= ITEMS and 0.0 <= metrics["r1"] <= 100.0,
            f"metrics out of range: {metrics}")
    print(json.dumps({
        "slice": "retrieval_two_stage_eval", "config": CONFIG.name, "dtype": "bfloat16",
        "captions": ITEMS, "videos": ITEMS, "clips_per_video": CLIPS,
        "encode_batch": ITEMS, "chunk_size": CHUNK, "evals": EVAL_REPEATS,
        "stage1_clips_per_s": float(np.median(clips_s)),
        "stage1_clips_per_s_range": [min(clips_s), max(clips_s)],
        "stage2_pairs_per_s": float(np.median(pairs_s)),
        "stage2_pairs_per_s_range": [min(pairs_s), max(pairs_s)],
        "stage1_clips_per_s_each": clips_s, "stage2_pairs_per_s_each": pairs_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        **{k: metrics[k] for k in ("r1", "r5", "r10", "medr")}}), flush=True)

    # 5. whole model: card fp32 (kernels) against CPU fp32 (plain versions)
    state = model.state_dict()
    rs = np.random.RandomState(2)
    img = torch.from_numpy(rs.randint(0, 256, (2, 1, cfg.size_frame, cfg.size_img,
                                               cfg.size_img, 3)).astype(np.uint8))
    txt = torch.from_numpy(np.stack([ds.items[i]["txt"] for i in range(2)]))
    mask = torch.from_numpy(np.stack([ds.items[i]["mask"] for i in range(2)]))
    vj, ti = [0, 1, 1, 0], [0, 0, 1, 1]

    def whole(m, device):
        with torch.inference_mode():
            fi, mi, ft, mt = m.encode(img.to(device), txt.to(device), mask.to(device))
            s = m.score_pairs(fi[vj], mi[vj], ft[ti], mt[ti])
        return [t.float().cpu() for t in (fi, ft, s)]

    bf16_out = whole(model, dev)
    del model
    torch.cuda.empty_cache()
    m32 = VioletRetrieval(cfg, dtype=torch.float32, device=dev)
    m32.load_state_dict(state)
    card = whole(m32, dev)
    del m32
    cpu = VioletRetrieval(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict(state)
    ref = whole(cpu, "cpu")
    diffs = {}
    for name, a, b16, r in zip(("feat_img", "feat_txt", "scores"), card, bf16_out, ref):
        torch.testing.assert_close(a, r, atol=1e-3, rtol=1e-3,
                                   msg=lambda m, name=name: f"whole model {name}: {m}")
        diffs[name] = {"fp32_max_abs": (a - r).abs().max().item(),
                       "bf16_max_abs": (b16 - r).abs().max().item(),
                       "ref_max_abs": r.abs().max().item()}
    print(json.dumps({"whole_model_vs_cpu": diffs}), flush=True)
    eval_launches = launches
    del cpu, card, ref
    torch.cuda.empty_cache()

    # 6. the pretrain train step at full width, MVM-pixel
    run = load_run_config(str(PRETRAIN_CONFIG))
    synthetic = {}
    train_launches = train_phase(dev, run, TRAIN_LAUNCHES, record=synthetic)
    torch.cuda.empty_cache()

    # 7. the whole pixel train step, card fp32 against CPU fp32
    whole_step_phase(dev, run)
    torch.cuda.empty_cache()

    # 8. the pretrain train step at full width, MVM-2d_feature (the frozen
    # 2D Swin-base teacher in the loop)
    run_2d = with_mvm_target(run, ("2d_feature",))
    train_2d_launches = train_phase(dev, run_2d, TRAIN_2D_LAUNCHES)
    torch.cuda.empty_cache()

    # 9. the whole 2d_feature train step, card fp32 against CPU fp32
    whole_step_phase(dev, run_2d)
    torch.cuda.empty_cache()

    # 10. the pretrain train step at full width on the trained 2D Swin-base
    # backbone (concat fusion), MVM-pixel
    run_swin2d = with_swin2d_backbone(run)
    train_swin2d_launches = train_phase(dev, run_swin2d, TRAIN_SWIN2D_LAUNCHES)
    torch.cuda.empty_cache()

    # 11. the whole swin2d train step, card fp32 against CPU fp32
    whole_step_phase(dev, run_swin2d)
    torch.cuda.empty_cache()

    # 12. the pretrain train step at full width on the C = 96 Video Swin
    # (vis_backbone_size "violet"), MVM-pixel: the packed kernel in stages 0-1
    run_violet = with_violet_backbone(run)
    train_violet_launches = train_phase(dev, run_violet, TRAIN_VIOLET_LAUNCHES)
    torch.cuda.empty_cache()

    # 13. the whole violet train step, card fp32 against CPU fp32
    whole_step_phase(dev, run_violet)
    torch.cuda.empty_cache()

    # 14-16. the multiple-choice QA fine-tune step, its whole-step check and
    # its eval (msrvtt-mc)
    ft = mc_phases(dev)

    # 17. the lanebench tool: row 12 against transpose + row 9, and the lane
    # window forward + backward (rows 7-8) against the packed one (rows 9-10)
    lanebench_launches = lanebench_phase()
    torch.cuda.empty_cache()

    # 18-20. the pretrain train step at full width for the 3d_feature (the
    # frozen Video Swin-base teacher), 2d_clip (the frozen CLIP ViT-B/32) and
    # hog MVM targets
    step_launches = {}
    for target, want in (("3d_feature", TRAIN_3D_LAUNCHES), ("2d_clip", TRAIN_CLIP_LAUNCHES),
                         ("hog", TRAIN_HOG_LAUNCHES)):
        step_launches[f"train_step_{target}"] = train_phase(
            dev, with_mvm_target(run, (target,)), want)
        torch.cuda.empty_cache()

    # 21. the whole train step for the three targets together, card fp32
    # against CPU fp32 (the teachers at full depth, one hog target for both)
    whole_step_phase(dev, with_mvm_target(run, ("hog", "3d_feature", "2d_clip")))
    torch.cuda.empty_cache()

    # 22-24. the pretrain train step at full width for the depth (the frozen
    # DPT-Large), vq (the dVAE on the fly, then pre-extracted tokens) and
    # optical_flow (RAFT-large, 12 updates) MVM targets
    for name, r, want in (("depth", with_mvm_target(run, ("depth",)), TRAIN_DEPTH_LAUNCHES),
                          ("vq_on_the_fly", with_vq_on_the_fly(run), TRAIN_VQ_LAUNCHES),
                          ("vq", with_mvm_target(run, ("vq",)), TRAIN_VQ_LAUNCHES),
                          ("optical_flow", with_mvm_target(run, ("optical_flow",)),
                           TRAIN_FLOW_LAUNCHES)):
        step_launches[f"train_step_{name}"] = train_phase(dev, r, want)
        torch.cuda.empty_cache()

    # 25. the whole train step for depth, optical_flow and vq on the fly
    # together, card fp32 against CPU fp32 (the DPT cut to DPT_CUT; the
    # teachers held card against CPU apart, the CPU's dVAE tokens for both)
    run_teachers = with_vq_on_the_fly(run)
    whole_step_phase(dev, with_mvm_target(run_teachers, ("depth", "optical_flow", "vq")), b=2)
    torch.cuda.empty_cache()

    # 26-31. the downstream heads' fine-tune steps, their evals and
    # whole-step checks
    ft.update(downstream_phases(dev))

    # 32-34. captioning: the caption step, its whole-step check, the decoders
    caption_launches = caption_phases(dev)

    # 35. the smtm pretrain step at full width (the pixel step's tasks and
    # smtm), and its whole-step check, card fp32 against CPU fp32
    run_smtm = with_pretrain_tasks(run, run.train.pretrain_tasks + ("smtm",))
    step_launches["train_step_smtm"] = train_phase(dev, run_smtm, TRAIN_SMTM_LAUNCHES)
    torch.cuda.empty_cache()
    whole_step_phase(dev, run_smtm)
    torch.cuda.empty_cache()

    # 36. nvJPEG against the fixture's cv2 decode, its time, the transform
    # executor card against CPU, a failed decode marking its item corrupt
    decode_phase(dev)

    # 37. the pixel step at full width fed by the loader over webvid2.5m and
    # cc3m, against phase 6; its corrupt row held card against CPU
    loader_launches = {"loader_train_step": loader_pretrain_phase(dev, run, synthetic)}

    # 38. the retrieval, open-ended QA and generative MC fine-tune steps fed
    # by their datasets at their real text lengths
    loader_launches.update(loader_finetune_phases(dev))

    # 39. checkpoints at full width: .msgpack, .npz and a reference .pt round
    # trips, the resumable state
    reference_pt = checkpoint_phase(dev, run)

    # 40. the user flow through each CLI's main at full width, in bf16:
    # pretrain -> retrieval, QA, caption -> the two-stage eval and parity_eval,
    # convert_ckpt, extract_vq
    cli_launches = cli_phase(dev, run, reference_pt)

    # 41. the data-parallel pixel step at W = 1 over NCCL against the plain step
    t0 = time.perf_counter()
    nccl_w1_phase(dev, run)
    torch.cuda.empty_cache()
    # 42. two ranks on the one card over gloo against one process: the pixel
    # and nce steps, the two-stage eval
    gloo_w2_phase(dev, run)
    torch.cuda.empty_cache()
    # 43. remat against no remat, bf16 and fp32, dropout on
    remat_phase(dev, run)
    # 44. the pretrain CLI under torch.distributed.run: fsdp, grad_accum, remat
    cli_dp_phase(dev, run)
    print(f"phases 41-44 done in {time.perf_counter() - t0:.1f} s", flush=True)

    # 45-48. the swin2d-tiny, r50 and merlot pixel steps with their whole
    # steps, the r50 nce step, and the pixel step with am masking
    t0 = time.perf_counter()
    backbone_launches = backbone_phases(dev, run, synthetic)
    print(f"phases 45-48 done in {time.perf_counter() - t0:.1f} s", flush=True)

    # 49-51. the text encoder stack, the SwinBERT layout, the Swin's in-block
    # dropouts: their steps, whole steps and CLI flows
    t0 = time.perf_counter()
    variant_launches = text_stack_phase(dev, run, synthetic)
    variant_launches.update(swinbert_phase(dev))
    variant_launches.update(swin_dropout_phase(dev, run, synthetic))
    print(f"phases 49-51 done in {time.perf_counter() - t0:.1f} s", flush=True)

    require(not failures, "kernel checks failed:\n" + "\n".join(failures))

    line = kernels_line(recs, {
        "train_step_2d_feature": train_2d_launches, "train_step": train_launches,
        "train_step_swin2d": train_swin2d_launches, "train_step_violet": train_violet_launches,
        "train_step_qamc": ft.pop("train_step_qamc"), "eval": eval_launches,
        "eval_qamc": ft.pop("eval_qamc"), **step_launches, "lanebench": lanebench_launches,
        **ft, **caption_launches, **loader_launches, **cli_launches, **backbone_launches,
        **variant_launches})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
