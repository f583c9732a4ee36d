"""The yardstick's operation and byte counts against hand counts."""

import math

from pb import shapes

M = dict(d_model=4, num_layers=1, d_ff=6, vocab_size=9, decoder_kind="cmn", cmm_size=5,
         cmn_topk=2, rm_num_slots=2, rm_d_model=4, d_vf=8, output_dim=8,
         encoder_hidden_size=4, encoder_num_layers=1, encoder_intermediate_size=6,
         sk_fusion_num_layers=1, fusion_intermediate_size=6, proj_num_heads=2,
         fusion_wide_qkv=False)


def test_resnet101_is_7_8_billion_multiply_adds():
    assert math.isclose(shapes.resnet101_flops(224) / 2, 7.80e9, rel_tol=1e-3)


def test_dense_and_attention():
    assert shapes.dense(2, 3, 4) == 48
    assert shapes.attention(2, 5, 3) == 2 * (2 * 5 * 3) * 2


def test_k1_bytes_and_operations():
    # per step t: 3 query and 3 output rows of 4 bf16, (t + 1) K and V rows,
    # 3 (t + 1) int32 ancestors: t=0: 48 + 16 + 12, t=1: 48 + 32 + 24
    assert shapes.k1_study_bytes(M, 2, 3) == 76 + 104
    assert shapes.k1_study_flops(M, 2, 3) == 3 * (4 * 1 * 4 + 4 * 2 * 4)


def test_k2_bytes_and_operations():
    # h 2 x 4, W 10 x 4, b 10 in bf16; 2 x 3 (value, index) pairs; 2 lse
    assert shapes.k2_call_bytes(M, 2, 3) == 2 * (8 + 40 + 10) + 48 + 8
    assert shapes.k2_call_flops(M, 2) == 2 * 2 * 4 * 10


def test_cmn_decode_step():
    # 6 d x d projections, self-attention over t + 1 rows, cross-attention over
    # 49 patches at 224 px, the FFN, the memory read, the 10 logits
    t, d = 3, 4
    want = (6 * 2 * d * d + 4 * (t + 1) * d + 4 * 49 * d + 2 * 2 * d * 6
            + (2 * 2 * d * d + 2 * 5 * d + 2 * 2 * d) + 2 * d * 10)
    assert shapes.decode_step_flops(M, t, 224) == want
    assert shapes.report_decode_flops(M, 2, 3, 224) == 3 * (
        shapes.decode_step_flops(M, 0, 224) + shapes.decode_step_flops(M, 1, 224))


def test_r2gen_decode_step_adds_memory_and_norms():
    r2 = dict(M, decoder_kind="r2gen")
    s, d, mem = 2, 4, 8
    rm = (2 * s * d * d + 2 * 2 * (s + 1) * d * d + 4 * s * (s + 1) * d + 2 * s * d * d
          + 2 * 2 * s * d * d + 2 * d * 2 * d + 2 * s * d * 2 * d)
    norms = 3 * 2 * (2 * mem * d + 2 * d * d)
    base = shapes.decode_step_flops(M, 3, 224) - (2 * 2 * d * d + 2 * 5 * d + 2 * 2 * d)
    assert shapes.decode_step_flops(r2, 3, 224) == base + rm + norms


def test_bound_takes_the_larger():
    assert shapes.bound_s(3.35e12, 0) == 1.0
    assert shapes.bound_s(0, 989e12) == 1.0
