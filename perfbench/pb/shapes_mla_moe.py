"""The operations and bytes of the ``mla_moe`` configurations, counted from
their shapes (``pb/shapes.py``'s conventions: a FLOP is a multiply or an add,
only matrix products and attention are counted, so every count is a lower
bound of the work).

A token's language-model operations are its active parameters' products
(attention projections, the dense layer or the router, its top-k routed
experts and the shared experts) and its attention over the keys it sees.
Prefill runs the non-absorbed attention (per-head keys and values from the
latent); a decode step the absorbed one (the query through W_UK, the context
through W_UV, scores and context over the latent), as the program computes
them.
"""

from __future__ import annotations

from typing import Dict

from pb import shapes
from pb.ref_mla_moe import lm_config
from pb.shapes import dense

BF16 = 2


def _dims(c: Dict):
    return (c["hidden_size"], c["num_attention_heads"], c["qk_nope_head_dim"],
            c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"])


def projections(c: Dict) -> float:
    """One token's q, latent and output projections, one layer."""
    h, heads, nope, r, vd, lat = _dims(c)
    return dense(1, h, heads * (nope + r)) + dense(1, h, lat + r) + dense(1, heads * vd, h)


def mlp(c: Dict, layer: int) -> float:
    """One token's MLP: the dense SwiGLU, or the router, its top-k routed
    experts and the shared experts."""
    h = c["hidden_size"]
    if layer < c["first_k_dense_replace"]:
        return 3 * dense(1, h, c["intermediate_size"])
    i = c["moe_intermediate_size"]
    return (dense(1, h, c["n_routed_experts"]) + c["num_experts_per_tok"] * 3 * dense(1, h, i)
            + 3 * dense(1, h, i * c["n_shared_experts"]))


def expert_flops(c: Dict, assignments: float) -> float:
    """The routed experts' three products for ``assignments`` (token, expert) pairs."""
    return assignments * 3 * dense(1, c["hidden_size"], c["moe_intermediate_size"])


def expert_bytes(c: Dict, touched: float, assignments: float) -> float:
    """Each touched expert's three matrices read once, each assignment's row
    read in and written out, bf16."""
    h, i = c["hidden_size"], c["moe_intermediate_size"]
    return BF16 * (touched * 3 * h * i + assignments * 2 * h)


def prefill_flops(cfg: Dict, p: int) -> float:
    """One study's prefill over ``p`` prefix tokens: every layer's
    projections and causal attention (keys and values from the latent), the
    MLP of every layer but the last (no later latent reads its output)."""
    c = lm_config(cfg)
    h, heads, nope, r, vd, lat = _dims(c)
    keys = p * (p + 1) / 2
    f = 0.0
    for n in range(c["num_hidden_layers"]):
        f += p * (projections(c) + dense(1, lat, heads * (nope + vd)))
        f += 2.0 * heads * keys * (nope + r + vd)
        if n + 1 < c["num_hidden_layers"]:
            f += p * mlp(c, n)
    return f


def decode_step_flops(cfg: Dict, keys: int) -> float:
    """One beam row's decode step that attends ``keys`` positions (prefix
    and report): the absorbed attention and the MLP in every layer, then the
    head over the whole vocabulary."""
    c = lm_config(cfg)
    h, heads, nope, r, vd, lat = _dims(c)
    per_layer = (projections(c) + heads * (dense(1, nope, lat) + dense(1, lat, vd))
                 + 2.0 * heads * keys * (lat + r + lat))
    f = sum(per_layer + mlp(c, n) for n in range(c["num_hidden_layers"]))
    return f + dense(1, h, c["vocab_size"])


def report_flops(cfg: Dict, p: int, length: int, beam: int) -> float:
    """A report of ``length`` tokens: ``beam`` rows, steps 0 .. length - 1,
    step t attending the prefix and t + 1 report positions."""
    return beam * sum(decode_step_flops(cfg, p + t + 1) for t in range(length))


def study_encoder_flops(cfg: Dict, n_images: int, n_partner_images: int,
                        inc_len: int) -> float:
    """EVOKE's encoder for one study as ``pb/shapes.py`` counts it (no decoder
    encoder layers), and the projector's two products."""
    m, c = cfg["model"], lm_config(cfg)
    h, size = c["hidden_size"], cfg["image_size"]
    enc = dict(m, num_layers=0, d_model=h, d_ff=0)
    p = shapes.image_tokens(m, size) - 1
    # the shared count ends with dense(p, output_dim, d_model): the projector's first
    return shapes.study_encoder_flops(enc, size, n_images, n_partner_images, inc_len) + dense(
        p, h, h)
