"""Report generation step (port of the beam path of evoke_tpu/train/steps.py).

``make_generate_step`` returns ``generate_step(batch) -> seqs`` over a model
that holds its own weights. The serving policy follows the JAX package's TPU
policy: ``serving=True`` keeps ancestor-table caches read by the lineage
kernel, an 8-phase cache schedule and the fused logit + top-k tail (on CPU
tensors the kernels' plain versions run); eval paths (``serving=False``)
resolve to reorder caches, one phase and the unfused tail, as in JAX. Only
the beam path (beam_size > 1, group_size 1) is ported; greedy / sampled /
diverse decoding and int8 caches are ROADMAP A12a, the train and eval steps A10.
"""

from __future__ import annotations

import torch

from evoke_tpu_torch.core.device import resolve_device
from evoke_tpu_torch.decode.beam import BeamLoop

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def maybe_normalize_images(batch):
    """uint8 images -> ImageNet-normalised float32, on the batch's device."""
    images = batch["images"]
    if images.dtype == torch.uint8:
        mean = torch.tensor(_IMAGENET_MEAN, device=images.device)
        std = torch.tensor(_IMAGENET_STD, device=images.device)
        batch = dict(batch)
        batch["images"] = (images.float() / 255.0 - mean) / std
    return batch


def resolve_beam_kv(decode_cfg, serving: bool) -> str:
    """DecodeConfig.beam_kv 'auto' -> 'ancestor' on the serving path (the
    lineage kernel on the card, its plain version on the CPU), 'reorder' on
    eval paths. An explicit value always wins."""
    beam_kv = str(getattr(decode_cfg, "beam_kv", "auto"))
    if beam_kv not in ("auto", "reorder", "ancestor"):
        raise ValueError(f"beam_kv must be auto|reorder|ancestor, got {beam_kv!r}")
    if beam_kv != "auto":
        return beam_kv
    return "ancestor" if serving else "reorder"


def use_fused_topk(model, decode_cfg, serving: bool) -> bool:
    """The fused vocab tail on the serving path of the r2gen decoder, unless
    the decoding constraint needs the full logits; eval paths stay unfused."""
    return (serving and not bool(decode_cfg.decoding_constraint)
            and getattr(model, "decoder_kind", "r2gen") == "r2gen")


def cache_schedule(decode_cfg, max_seq_len: int, serving: bool):
    phases = int(getattr(decode_cfg, "cache_phases", 0))
    if phases <= 0:
        phases = 8 if serving else 1
    if phases > 1 and max_seq_len >= 2 * phases:
        return tuple(-(-max_seq_len * i // phases) for i in range(1, phases + 1))
    return (max_seq_len,)


def make_generate_step(model, tokenizer, decode_cfg, max_seq_len: int,
                       with_indication: bool = False, serving: bool = False,
                       all_samples: bool = False, device="cuda", graphs=None):
    """-> ``generate_step(batch) -> seqs [n_anchor, L]`` ([n_anchor, beam, L]
    with ``all_samples``). ``batch`` holds tensors on ``device``: images
    [B, H, W, 3] (uint8 or normalised float), ids [n_anchor, T] (its first
    dim is the anchor count), pids [B], valid [B], and with_indication
    inc_ids / inc_mask.

    The step keeps one ``BeamLoop`` per batch shape (``generate_step.loops``):
    on a CUDA device the loop's steps are captured into CUDA graphs at the
    shape's first batch and replayed for every later one, so the step returns
    while the card still runs the batch's last cache phase; ``seqs`` is a new
    tensor, queued on the current stream before any later batch's copies into
    the loop's buffers. ``graphs=False`` runs the same steps eagerly (the
    CPU's path; on the card for an A/B)."""
    device = resolve_device(device)
    beam = int(decode_cfg.beam_size)
    groups = max(int(decode_cfg.group_size), 1)
    if not (beam > 1 and decode_cfg.sample_method in ("greedy", "beam_search")
            and groups == 1):
        raise NotImplementedError(
            f"sample_method={decode_cfg.sample_method!r}, beam_size={beam}, "
            f"group_size={groups}: only beam search (beam_size > 1, group_size 1) "
            "is ported; greedy, sampled and diverse decoding are ROADMAP A12a")
    if str(getattr(decode_cfg, "kv_cache_dtype", "") or ""):
        raise NotImplementedError("kv_cache_dtype='int8' is ROADMAP A12a")
    sample_n = max(int(getattr(decode_cfg, "sample_n", 1)), 1)
    if sample_n not in (1, beam):
        raise ValueError(f"sample_n={sample_n} with beam_size={beam}: on the beam path "
                         "sample_n must be 1 or beam_size (each beam is a sample)")
    vocab = tokenizer.get_vocab_size() + 1
    common = dict(bos_id=tokenizer.bos_id, eos_id=tokenizer.eos_id,
                  pad_id=tokenizer.pad_id, vocab_size=vocab, max_len=max_seq_len,
                  beam_size=beam, length_penalty=decode_cfg.length_penalty)
    suppress = (tokenizer.unk_id,) if decode_cfg.suppress_unk else ()
    schedule = cache_schedule(decode_cfg, max_seq_len, serving)
    ancestor_kv = resolve_beam_kv(decode_cfg, serving) == "ancestor"
    fused = use_fused_topk(model, decode_cfg, serving)

    decoding_constraint = bool(decode_cfg.decoding_constraint)
    loops = {}   # batch shape -> (BeamLoop, its attention-mask buffer)

    def loop_for(state0, att_mask, b):
        """The beam loop of this batch shape, built (and on the card captured)
        at the shape's first batch. Its step reads the attention mask from a
        buffer of its own, which every later batch's mask is copied into."""
        key = (b, beam, tuple(att_mask.shape), state0["cross_k"][0].dtype, fused,
               ancestor_kv, schedule)
        if key not in loops:
            mask = att_mask.clone()
            step_kw = (dict(return_topk=beam, topk_suppress=suppress) if fused
                       else dict(return_logits=True))
            contract = (dict(fused_topk=True) if fused else
                        dict(suppress_ids=suppress, decoding_constraint=decoding_constraint))

            def step(tok, pos, dstate):
                return model.decode_step(tok, pos, dstate, mask, **step_kw)

            loops[key] = (BeamLoop(step, state0, b, cache_schedule=schedule, raw_logits=True,
                                   ancestor_kv=ancestor_kv, graphs=graphs, **contract,
                                   **common), mask)
        return loops[key]

    @torch.inference_mode()
    def generate_step(batch):
        batch = maybe_normalize_images(batch)
        b = batch["ids"].shape[0]
        inc = [batch["inc_ids"], batch["inc_mask"]] if with_indication else []
        enc, att_mask = model.encode_for_decode(batch["images"], batch["pids"],
                                                batch["valid"], b, *inc)
        state0 = model.init_decode_state(enc, b * beam, schedule[0])
        loop, mask = loop_for(state0, att_mask, b)
        mask.copy_(att_mask)
        loop.load(state0)
        res = loop.run()
        return res.seqs if all_samples else res.seqs[:, 0, :]

    generate_step.loops = loops
    generate_step.ancestor_kv = ancestor_kv
    generate_step.fused_topk = fused
    generate_step.schedule = schedule
    return generate_step
