"""Train, eval and report generation steps (port of evoke_tpu/train/steps.py).

``TrainState`` holds the step count, the model (its parameters, in the
compute dtype, and its BatchNorm statistics) and the optimizer (float32
masters and moments). ``make_train_step`` returns ``train_step(state, batch)
-> metrics``: the training forward with dropout drawn from a generator
seeded by (seed, step, task), the backward pass, BatchNorm's running update,
then the optax chain (``train/optim.py``); the metrics stay on the device.
``make_eval_step`` is the same forward with ``train=False``.

``make_generate_step`` returns ``generate_step(batch) -> seqs`` over a model
that holds its own weights. It dispatches as the JAX package does
(att_model._sample's dispatch): beam search (beam_size > 1 with
sample_method greedy / beam_search), diverse beam search (the same with
group_size > 1), diverse sampling (group_size > 1 otherwise) and greedy /
sampled decoding (``sample_n`` rows a study). The serving policy follows the
JAX package's TPU policy: ``serving=True`` keeps ancestor-table caches read
by the lineage kernel (reorder with int8 caches), an 8-phase cache schedule
and, on the R2Gen beam path, the fused logit + top-k tail (on CPU tensors the
kernels' plain versions run); eval paths (``serving=False``) resolve to
reorder caches, one phase and the unfused tail, as in JAX. Diverse modes run
one full-length cache phase, as JAX's do.

``logits_hook`` / ``topk_hook`` are the load-testing surface of the JAX
package's ``make_generate_step``: they rewrite each step's candidates (for
instance to force EOS at per-study target lengths) so that a serving engine
can be measured on a controlled length mix with random weights.

Under a dp x mp mesh (``core/mesh.py``) the model holds this rank's slice of
the tensor-parallel parameters (``parallel/tp.shard_params_tp``, called
before the optimizer is built): the gradients of split parameters are summed
over ``dp_group``, those of replicated parameters over the world and divided
by ``mp`` (so every rank's replicated parameters stay bit-identical), and the
decode loops, whose steps hold mp collectives, run eagerly
(``generate_step.captured`` is False).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import torch

from evoke_tpu_torch.core import prng
from evoke_tpu_torch.core.device import resolve_device
from evoke_tpu_torch.core.profiling import span
from evoke_tpu_torch.core.mesh import use_mesh
from evoke_tpu_torch.decode.beam import (BeamLoop, DiverseBeamLoop, DiverseSampleLoop,
                                         SampleLoop, make_sampler)
from evoke_tpu_torch.models.layers import commit_batch_stats
from evoke_tpu_torch.ops.fused_logit_topk import use_fused_logit_topk
from evoke_tpu_torch.ops.sharding import mesh_allows_kernels
from evoke_tpu_torch.parallel.collectives import all_reduce_, all_reduce_sum
from evoke_tpu_torch.parallel.tp import split_dims
from evoke_tpu_torch.train.optim import Optimizer

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


def _model_args(batch, with_indication: bool):
    args = [batch["images"], batch["ids"], batch["mask"], batch["pids"], batch["valid"]]
    if with_indication:
        args += [batch["inc_ids"], batch["inc_mask"]]
    return args


@dataclass
class TrainState:
    """A run's state: ``step`` (a host count of train steps), the model and
    its optimizer. ``state_dict`` is what a checkpoint holds: the float32
    parameters (the optimizer's masters), the BatchNorm statistics, the
    optimizer's moments and counters, and the step."""

    model: torch.nn.Module
    opt: Optimizer
    step: int = 0

    def buffers(self) -> Dict[str, torch.Tensor]:
        """The model's saved buffers (BatchNorm statistics)."""
        params = dict(self.model.named_parameters())
        return {k: v for k, v in self.model.state_dict().items() if k not in params}

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "params": self.opt.masters(), "buffers": self.buffers(),
                "opt": self.opt.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, d: Mapping[str, Any]) -> None:
        """Full restore: every parameter, buffer and optimizer slot must be
        there with its shape."""
        masters = self.opt.masters()
        buffers = self.buffers()
        for want, have, what in ((masters, d["params"], "parameters"),
                                 (buffers, d["buffers"], "buffers")):
            missing = sorted(set(want) - set(have))
            bad = sorted(k for k in set(want) & set(have)
                         if tuple(want[k].shape) != tuple(have[k].shape))
            if missing or bad:
                raise KeyError(f"checkpoint {what}: missing {missing[:10]}, shape "
                               f"mismatch {bad[:10]}")
        self.opt.load_masters(d["params"])
        for k, b in buffers.items():
            b.copy_(d["buffers"][k])
        self.opt.load_state_dict(d["opt"])
        self.step = int(d["step"])


def _global_metrics(out, mesh) -> Dict[str, torch.Tensor]:
    """Detached metrics; under a mesh the ranks' shares summed (one
    all-reduce), so every rank holds the global batch's values."""
    out = {k: v.detach() for k, v in out.items()}
    if mesh is None:
        return out
    keys = sorted(out)
    total = all_reduce_sum(torch.stack([out[k].float() for k in keys]), mesh)
    return {k: total[i].to(out[k].dtype) for i, k in enumerate(keys)}


def check_tp(model, mesh) -> None:
    """Raise unless ``model`` is sharded for ``mesh``'s mp axis (mp > 1)."""
    if mesh is not None and mesh.mp > 1 and getattr(model, "tp_mesh", None) is not mesh:
        raise ValueError(f"a mesh with mp={mesh.mp} needs the model sharded over it first: "
                         "parallel/tp.shard_params_tp(model, mesh)")


def sum_gradients_(model, grads: Mapping[str, torch.Tensor], mesh) -> None:
    """The global batch's gradients on every rank, in place: split
    parameters' summed over ``dp``; replicated ones over the world, then
    divided by ``mp`` (the ``mp`` ranks of a dp group hold equal copies in
    exact arithmetic; the mean keeps them bit-identical)."""
    split = split_dims(model)
    live = {n: g for n, g in grads.items() if g is not None}
    all_reduce_([g for n, g in live.items() if n in split], mesh, "dp")
    repl = [g for n, g in live.items() if n not in split]
    all_reduce_(repl, mesh, None)
    if repl and mesh.mp > 1:
        torch._foreach_div_(repl, float(mesh.mp))


def make_train_step(model, opt: Optimizer, seed: int, loss_key: str = "all_loss",
                    with_indication: bool = False, task: str = "finetune",
                    dropout: bool = True, mesh=None):
    """-> ``train_step(state, batch) -> metrics`` (the model's output dict,
    detached, on the device; nothing is read back).

    ``batch`` holds tensors on the model's device: images [B, H, W, 3] (uint8
    is normalised on the device), ids / mask [n_anchor, T], pids, valid [B]
    and, ``with_indication``, inc_ids / inc_mask. Dropout masks of step ``s``
    come from ``prng.step_generator(seed, s, f"{task}-dropout")``, so a
    resumed run draws what an unbroken run draws; ``dropout=False`` trains
    with dropout off (BatchNorm still on batch statistics).

    ``mesh`` (``core/mesh.Mesh``): ``batch`` holds this rank's rows
    (``core/mesh.shard_batch``) and the step computes the one-device step on
    the global batch: the forward and backward run under ``use_mesh`` (the
    visual features gathered at the fusion, BatchNorm statistics and loss
    denominators summed over ranks, dropout masks drawn at the global shape),
    each rank's loss is its share of the global loss, the gradients are
    summed over ranks before the optimizer's chain, and the returned metrics
    are the global ones. Every rank's parameters stay identical. A mesh with
    mp > 1 needs ``model`` sharded over it (``parallel/tp.shard_params_tp``)
    and ``sum_gradients_`` sums the gradients by placement."""
    check_tp(model, mesh)
    name = f"{task}-dropout"

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        batch = maybe_normalize_images(batch)
        device = batch["ids"].device
        rng = prng.step_generator(seed, state.step, name, device) if dropout else None
        with use_mesh(mesh):
            out = model(*_model_args(batch, with_indication), train=True, rng=rng)
            out[loss_key].backward()
        commit_batch_stats(model)
        grads = {n: p.grad for n, p in model.named_parameters()}
        if mesh is not None:
            sum_gradients_(model, grads, mesh)
        opt.step(grads)
        for p in model.parameters():
            p.grad = None
        state.step += 1
        return _global_metrics(out, mesh)

    return train_step


def make_eval_step(model, with_indication: bool = False, mesh=None):
    """-> ``eval_step(state, batch) -> metrics``: the forward with
    ``train=False`` (running statistics, no dropout), no gradients. Under
    ``mesh`` the batch is this rank's rows and the metrics the global
    batch's."""
    check_tp(model, mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        batch = maybe_normalize_images(batch)
        with use_mesh(mesh):
            out = model(*_model_args(batch, with_indication), train=False)
        return _global_metrics(out, mesh)

    return eval_step


def resolve_beam_kv(decode_cfg, serving: bool, mesh=None) -> str:
    """DecodeConfig.beam_kv 'auto' -> 'ancestor' on the serving path (the
    lineage kernel on the card, its plain version on the CPU) unless the
    caches are int8 (the kernel reads bf16 / float32 caches) or the mesh
    cannot carry the kernel (mp > 1, ``ops/sharding.mesh_allows_kernels``),
    'reorder' on eval paths. An explicit value always wins."""
    beam_kv = str(getattr(decode_cfg, "beam_kv", "auto"))
    if beam_kv not in ("auto", "reorder", "ancestor"):
        raise ValueError(f"beam_kv must be auto|reorder|ancestor, got {beam_kv!r}")
    if beam_kv != "auto":
        return beam_kv
    int8 = str(getattr(decode_cfg, "kv_cache_dtype", "") or "") == "int8"
    return "ancestor" if serving and not int8 and mesh_allows_kernels(mesh) else "reorder"


def kv_cache_dtype(decode_cfg, model) -> str:
    """DecodeConfig.kv_cache_dtype checked: '' or 'int8', and int8 only for
    the R2Gen decoder (the only one with quantized caches, as in JAX)."""
    kv = str(getattr(decode_cfg, "kv_cache_dtype", "") or "")
    if kv not in ("", "int8"):
        raise ValueError(f"kv_cache_dtype must be '' or 'int8', got {kv!r}")
    kind = getattr(model, "decoder_kind", "r2gen")
    if kv and kind != "r2gen":
        raise NotImplementedError(f"kv_cache_dtype='int8' with decoder_kind={kind!r}: only "
                                  "the R2Gen decoder implements quantized caches")
    return kv


def sampling_method(decode_cfg):
    """(method, top_k, top_p) of the greedy / sampling paths, spelled as
    caption_model.py:363-401 spells them (evoke_tpu/train/steps.py:352-364):
    'beam_search' -> greedy, 'gumbel' -> sample, 'topN' -> top_k N (N >= 1)
    or top_p N (0 < N < 1)."""
    method = str(decode_cfg.sample_method)
    top_k = int(getattr(decode_cfg, "top_k", 0))
    top_p = float(getattr(decode_cfg, "top_p", 0.0))
    method = {"beam_search": "greedy", "gumbel": "sample"}.get(method, method)
    if method.startswith("top") and method not in ("top_k", "top_p"):
        num = float(method[3:])
        if 0 < num < 1:
            method, top_p = "top_p", num
        else:
            method, top_k = "top_k", int(num)
    if method not in ("greedy", "sample", "top_k", "top_p"):
        raise ValueError(f"sample_method={decode_cfg.sample_method!r}: one of beam_search, "
                         "greedy, sample, gumbel, top_k, top_p or topN")
    return method, top_k, top_p


def cache_schedule(decode_cfg, max_seq_len: int, serving: bool):
    phases = int(getattr(decode_cfg, "cache_phases", 0))
    if phases <= 0:
        phases = 8 if serving else 1
    if phases > 1 and max_seq_len >= 2 * phases:
        return tuple(-(-max_seq_len * i // phases) for i in range(1, phases + 1))
    return (max_seq_len,)


def make_generate_step(model, tokenizer, decode_cfg, max_seq_len: int,
                       with_indication: bool = False, serving: bool = False,
                       all_samples: bool = False, device="cuda", graphs=None,
                       logits_hook=None, topk_hook=None, seed: int = 0, mesh=None):
    """-> ``generate_step(batch) -> seqs [n_anchor, L]``. With ``all_samples``
    every candidate: [n_anchor, beam, L] beams best-first (plain and diverse
    beam search), [n_anchor, group_size, L] for diverse sampling,
    [n_anchor, sample_n, L] for ``sample_n`` > 1 (study-major rows, as
    ``jnp.repeat``); greedy / sampled decoding of one row a study returns
    [n_anchor, L] either way. ``batch`` holds tensors on ``device``: images
    [B, H, W, 3] (uint8 or normalised float), ids [n_anchor, T] (its first
    dim is the anchor count), pids [B], valid [B], and with_indication
    inc_ids / inc_mask.

    The step keeps one loop per batch shape (``generate_step.loops``:
    ``decode/beam.BeamLoop``, ``SampleLoop``, ``DiverseBeamLoop`` or
    ``DiverseSampleLoop``, by ``generate_step.mode``): on a CUDA device the
    loop's steps are captured into CUDA graphs at the shape's first batch and
    replayed for every later one, so the step returns while the card still
    runs the batch's last steps; ``seqs`` is a new tensor, queued on the
    current stream before any later batch's copies into the loop's buffers.
    ``graphs=False`` runs the same steps eagerly (the CPU's path; on the card
    for an A/B). Sampled modes draw from a generator reseeded from
    ``generate_step.seed`` (``seed``; it may be changed between batches) at
    every batch, as JAX draws from ``jax.random.key(0)`` at every batch.

    ``logits_hook(scores, tok, pos, batch) -> scores`` rewrites each step's
    per-row scores before token selection: raw [N, V] logits on the beam
    path (it forces the unfused tail), log-probs on every other path.
    ``topk_hook(vals, idx, lse, tok, pos, batch) -> (vals, idx)`` rewrites the
    fused tail's [N, k] candidates instead and keeps the fused tail; given
    both, the fused tail uses ``topk_hook`` and ignores ``logits_hook``
    (callers pass equivalent forcings). ``pos`` is the step (a Python
    number); ``batch`` holds every entry of the batch but ``images``, in
    buffers of the loop that each batch is copied into, so a hook reads the
    current batch's values under replay too.

    ``mesh`` (a ``core/mesh.Mesh``): ``batch`` holds this rank's rows
    (``core/mesh.shard_batch``; a batch that does not divide dp raises
    there). The encoder runs under ``use_mesh`` (the visual features
    gathered at the fusion) and the rank decodes its own anchors, with K1 and
    K2 at its rows; ``seqs`` are those rows (``serve.generate_stream``
    gathers them). On a pure-dp mesh the loops hold no collective, so the
    captured graphs are per rank. With mp > 1 (the model sharded over it)
    each step holds mp collectives: the loops run eagerly (``graphs=True``
    raises; ``generate_step.captured`` says which), K1 and K2 are declined
    by the policies, and the ``mp`` ranks of a dp group seed their samplers
    alike, so they pick the same tokens."""
    device = resolve_device(device)
    check_tp(model, mesh)
    if mesh is not None and mesh.mp > 1:
        if graphs:
            raise ValueError(f"graphs=True with mp={mesh.mp}: the decode steps hold mp "
                             "collectives, which are not captured (ROADMAP C9)")
        graphs = False
    beam = int(decode_cfg.beam_size)
    groups = max(int(decode_cfg.group_size), 1)
    sample_n = max(int(getattr(decode_cfg, "sample_n", 1)), 1)
    kv = kv_cache_dtype(decode_cfg, model)
    beam_path = beam > 1 and decode_cfg.sample_method in ("greedy", "beam_search")
    if beam_path and sample_n not in (1, beam // groups):
        raise ValueError(f"sample_n={sample_n} with beam_size={beam}: on the beam path "
                         "sample_n must be 1 or beam_size//group_size (each beam is a "
                         "sample; pass all_samples=True to receive them)")
    if beam_path:
        mode = "beam" if groups == 1 else "diverse_beam"
    else:
        mode = "diverse_sample" if groups > 1 else "sample"
        method, top_k, top_p = sampling_method(decode_cfg)
        make_sampler(method, float(decode_cfg.temperature), top_k, top_p)   # its checks
        sampling = dict(sample_method=method, top_k=top_k, top_p=top_p,
                        block_trigrams=bool(decode_cfg.block_trigrams),
                        decoding_constraint=bool(decode_cfg.decoding_constraint))
    vocab = tokenizer.get_vocab_size() + 1
    common = dict(bos_id=tokenizer.bos_id, eos_id=tokenizer.eos_id,
                  pad_id=tokenizer.pad_id, vocab_size=vocab, max_len=max_seq_len)
    suppress = (tokenizer.unk_id,) if decode_cfg.suppress_unk else ()
    schedule = (cache_schedule(decode_cfg, max_seq_len, serving)
                if mode in ("beam", "sample") else (max_seq_len,))
    ancestor_kv = mode in ("beam", "diverse_beam") and \
        resolve_beam_kv(decode_cfg, serving, mesh) == "ancestor"
    fused = (mode == "beam"
             and use_fused_logit_topk(model, serving, mesh=mesh,
                                      decoding_constraint=bool(decode_cfg.decoding_constraint))
             and (logits_hook is None or topk_hook is not None))
    hooked = (topk_hook if fused else logits_hook) is not None
    rows_per_study = {"beam": beam, "diverse_beam": beam // groups, "diverse_sample": 1,
                      "sample": sample_n}[mode]

    def build(step, state0, b):
        if mode == "beam":
            contract = (dict(fused_topk=True) if fused else
                        dict(suppress_ids=suppress,
                             decoding_constraint=bool(decode_cfg.decoding_constraint)))
            return BeamLoop(step, state0, b, cache_schedule=schedule, raw_logits=True,
                            ancestor_kv=ancestor_kv, graphs=graphs, beam_size=beam,
                            length_penalty=decode_cfg.length_penalty, **contract, **common)
        if mode == "diverse_beam":
            return DiverseBeamLoop(step, state0, b, beam_size=beam, group_size=groups,
                                   diversity_lambda=decode_cfg.diversity_lambda,
                                   length_penalty=decode_cfg.length_penalty,
                                   ancestor_kv=ancestor_kv, graphs=graphs, **common)
        if mode == "diverse_sample":
            return DiverseSampleLoop(step, state0, b, group_size=groups,
                                     temperature=decode_cfg.temperature,
                                     diversity_lambda=decode_cfg.diversity_lambda,
                                     graphs=graphs, **sampling, **common)
        return SampleLoop(step, state0, b * sample_n, temperature=decode_cfg.temperature,
                          cache_schedule=schedule, graphs=graphs, **sampling, **common)

    loops = {}        # batch shape -> (loop, its attention-mask buffer)
    hook_batches = {}  # batch shape -> the hook's batch buffers

    def loop_for(state0, att_mask, b, hook_batch):
        """The loop of this batch shape, built (and on the card captured) at
        the shape's first batch. Its step reads the attention mask (and a hook
        its batch) from buffers of its own, which every later batch's values
        are copied into."""
        key = (b, tuple(att_mask.shape), state0["cross_k"][0].dtype,
               tuple((name, tuple(v.shape), v.dtype) for name, v in hook_batch.items()))
        if key not in loops:
            mask = att_mask.clone()
            hook_bufs = {name: v.clone() for name, v in hook_batch.items()}
            step_kw = (dict(return_topk=beam, topk_suppress=suppress) if fused
                       else dict(return_logits=mode == "beam"))

            def step(tok, pos, dstate):
                out, st = model.decode_step(tok, pos, dstate, mask, **step_kw)
                if fused and topk_hook is not None:
                    vals, idx, lse = out
                    vals, idx = topk_hook(vals, idx, lse, tok, pos, hook_bufs)
                    out = (vals, idx, lse)
                elif not fused and logits_hook is not None:
                    out = logits_hook(out, tok, pos, hook_bufs)
                return out, st

            hook_batches[key] = hook_bufs
            loops[key] = (build(step, state0, b), mask)
        return loops[key] + (hook_batches[key],)

    @torch.inference_mode()
    def generate_step(batch):
        with span("generate.encode"):
            batch = maybe_normalize_images(batch)
            b = batch["ids"].shape[0]
            inc = [batch["inc_ids"], batch["inc_mask"]] if with_indication else []
            with use_mesh(mesh):
                enc, att_mask = model.encode_for_decode(batch["images"], batch["pids"],
                                                        batch["valid"], b, *inc)
            if mode == "sample" and sample_n > 1:
                enc = enc.repeat_interleave(sample_n, dim=0)
                att_mask = att_mask.repeat_interleave(sample_n, dim=0)
            state0 = model.init_decode_state(enc, b * rows_per_study, schedule[0],
                                             **({"kv_dtype": kv} if kv and mode in (
                                                 "beam", "sample") else {}))
        with span("generate.decode"):
            hook_batch = ({name: v for name, v in batch.items() if name != "images"}
                          if hooked else {})
            loop, mask, hook_bufs = loop_for(state0, att_mask, b, hook_batch)
            mask.copy_(att_mask)
            for name, v in hook_batch.items():
                hook_bufs[name].copy_(v)
            if mode in ("beam", "diverse_beam"):
                loop.load(state0)
                seqs = loop.run().seqs
            else:
                loop.load(state0, prng.stream_seed(generate_step.seed, 0, "decode-sample"))
                seqs = loop.run()[0]
        if mode == "sample":
            if sample_n == 1:
                return seqs
            seqs = seqs.reshape(b, sample_n, max_seq_len)
        return seqs if all_samples else seqs[:, 0, :]

    generate_step.loops = loops
    generate_step.seed = seed
    generate_step.mode = mode
    generate_step.ancestor_kv = ancestor_kv
    generate_step.fused_topk = fused
    generate_step.schedule = schedule
    generate_step.mesh = mesh
    generate_step.captured = device.type == "cuda" and graphs is not False
    return generate_step
