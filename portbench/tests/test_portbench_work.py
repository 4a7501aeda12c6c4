"""The FLOP and byte counters against figures worked out by hand."""

import pytest

from portbench.harness import work

BERT = {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 1}


def test_bert_layer_by_hand():
    # one BERT-base layer over 275 tokens: q, k, v, out 4 x 768^2, FFN
    # 2 x 768 x 3072 a token, 2 FLOPs a multiply-add; QK^T and PV 2 x 2 x
    # 275 x 768 a token
    l, d, f = 275, 768, 3072
    by_hand = 2 * l * (4 * d * d + 2 * d * f) + 2 * 2 * l * l * d
    assert work.bert_layer_flops(l, d, f) == by_hand == 4_125_158_400


def test_video_swin_block_by_hand():
    # stage 0 of Swin-base at 4 x 224^2: 4 x 56 x 56 = 12,544 tokens of 128,
    # windows (4, 7, 7) of N = 196: qkv 3C^2 + proj C^2 + MLP 8C^2 = 12C^2
    # multiply-adds a token, attention 2 N C
    swin = {"patch_size": [2, 4, 4], "embed_dim": 128, "depths": [2], "num_heads": [4],
            "window_size": [8, 7, 7]}
    tok, c, n = 12_544, 128, 196
    block = 2 * (12 * tok * c * c) + 2 * (2 * tok * n * c)
    embed = 2 * tok * (2 * 4 * 4 * 3) * c
    assert work.swin_forward_flops(swin, 4, 224, 224) == 2 * block + embed
    stage = work.swin_stages(swin, 4, 224, 224)[0]
    assert (stage["tokens"], stage["n"], stage["nw"]) == (tok, n, 64)
    assert (stage["shifted"], stage["unshifted"]) == (1, 1)


def test_window_attention_calls_by_hand():
    swin = {"patch_size": [2, 4, 4], "embed_dim": 128, "depths": [2], "num_heads": [4],
            "window_size": [8, 7, 7]}
    calls = work.window_attention_calls(swin, 20, 4, 224, backward=True)
    assert len(calls) == 4                       # two blocks, forward and backward
    fwd_unshifted, bwd_unshifted = calls[2], calls[3]
    ops = 4 * 20 * 64 * 196 * 196 * 128          # 4 N^2 hd a head and window
    assert fwd_unshifted.ops == ops and bwd_unshifted.ops == 2.5 * ops
    tok = 20 * 12_544
    bias = 4 * 196 * 196 * 4
    assert fwd_unshifted.nbytes == tok * 4 * 128 * 2 + bias   # x3 in, out, bias
    assert bwd_unshifted.nbytes == tok * 7 * 128 * 2 + 2 * bias
    assert calls[0].nbytes == fwd_unshifted.nbytes + 64 * 196 * 196 * 4   # shift mask
    # stage 0 at batch 20 is bound by its bytes: 267.4 MB at 3.35 TB/s
    assert work.least_seconds([calls[0]], 989e12, 3.35e12) == pytest.approx(
        (tok * 4 * 128 * 2 + bias + 64 * 196 * 196 * 4) / 3.35e12)


def test_self_attention_calls_by_hand():
    calls = work.self_attention_calls({"hidden_size": 768, "num_hidden_layers": 2}, 64, 275,
                                      backward=False)
    assert len(calls) == 2
    assert calls[0].ops == 4 * 64 * 275 * 275 * 768
    assert calls[0].nbytes == 64 * 275 * 4 * 768 * 2 + 64 * 275 * 4


def test_step_flops_add_up():
    dims = {"swin": {"patch_size": [2, 4, 4], "embed_dim": 128, "depths": [2, 2, 18, 2],
                     "num_heads": [4, 8, 16, 32], "window_size": [8, 7, 7]},
            "teacher": {"patch_size": [1, 4, 4], "embed_dim": 128, "depths": [2, 2, 18, 2],
                        "num_heads": [4, 8, 16, 32], "window_size": [1, 7, 7]},
            "fusion": {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
                       "vocab_size": 30522},
            "size_patch": 32}
    # about 165 GFLOP a 5-frame clip through Video-Swin-base, 50 a fused pair
    assert 160e9 < work.swin_forward_flops(dims["swin"], 5, 224, 224) < 170e9
    assert 49e9 < work.fusion_forward_flops(dims["fusion"], 1, 275) < 51e9
    # an eval of 256 clips and 16,384 pairs: about 42 + 812 TFLOP
    assert 850e12 < work.retrieval_eval_flops(dims, 256, 16384, 5, 224, 25) < 860e12


def test_pretrain_step_flops_follow_the_run():
    """The teacher and each MVM head count only where the run configuration
    names them; VTM and MTM always, as the program computes them."""
    import json
    from portbench.harness import spec
    config = json.loads((spec.ROOT / "portbench/configs/violet-base-pretrain.json").read_text())
    dims, run = config["dims"], config["run"]
    feature = work.pretrain_step_flops(dims, run, 20)
    pixel = work.pretrain_step_flops(dims, dict(run, mvm_target=["pixel"]), 20)
    none = work.pretrain_step_flops(dims, dict(run, pretrain_tasks=["vtm", "mtm"]), 20)
    rows = 20 * 4 * 7 * 7                        # MVM's tokens: 4 frames of 7 x 7 patches
    teacher = 20 * work.swin_forward_flops(dims["teacher"], 4, 224, 224)
    head = 3 * work.score_head_flops(768, 1024, rows)
    assert feature - none == pytest.approx(teacher + head, rel=1e-12)
    assert pixel - none == pytest.approx(3 * 2 * rows * 768 * 32 * 32 * 3, rel=1e-12)
    # about 1,010 GFLOP a clip, of which the teacher's forward is about 123
    assert 990e9 < feature / 20 < 1030e9 and 115e9 < teacher / 20 < 130e9
