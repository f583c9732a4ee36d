"""The port's multi-device dry run (the counterpart of
``__graft_entry__.dryrun_multichip``): the whole workflow at tiny widths
over N ranks, one line a stage.

    python -m evoke_tpu_torch.dryrun N [--device cpu]

JAX's layout: an even N >= 4 runs stages 1-4 at ``dp = N/2 x mp = 2``
(the model sharded over mp, ``parallel/tp.shard_params_tp``), any other N
at ``dp = N``. Stages: (1) one train step; (2) beam-3 decode of the rank's
anchors, the tokens gathered over dp; (3) a checkpoint save (the full
tensors; rank 0 writes), restore (broadcast, each rank's slice) and one
more step on the restored state, and rank 0 restores the same slot into
an unsharded one-device model (a re-shard: it must equal the gathered
tensors); (4) the wide fusion (``fusion_wide_qkv=True``, per-head dim =
d_vf) train step; (5) the continuous engine slot-sharded over a pure-dp
mesh of all N ranks (as JAX's stage 5), with ancestor ring caches and the
fused vocab tail (on the card K1 and K2 launch, each rank at its rows).

On the card the ranks take ``cuda:0 .. cuda:N-1`` over NCCL (N above the
visible cards raises); ``--device cpu`` runs N gloo ranks on the CPU;
``dryrun(n, devices=[...], backend="gloo")`` lists each rank's device (N
ranks may share one card over gloo). Every rank checks its result; rank 0
prints.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

# the decoder's head dim (64 / 2) is one K1 takes, so stage 5 launches it on the card
TINY = dict(output_dim=64, encoder_hidden_size=32, encoder_num_layers=1,
            encoder_num_heads=2, encoder_intermediate_size=64, d_model=64, d_ff=64,
            num_heads=2, num_layers=2, rm_num_slots=3, rm_d_model=64,
            fusion_num_heads=2, fusion_intermediate_size=64, sk_fusion_num_layers=1,
            max_seq_len=16, drop_prob_lm=0.5)
VOCAB = 64


class _Tok:
    """Ids-only tokenizer of the dry run (JAX's ``_Tok`` / ``_DecTok``)."""

    bos_id, eos_id, pad_id, unk_id = VOCAB - 2, VOCAB - 1, 0, 4

    def get_vocab_size(self):
        return VOCAB

    def decode(self, ids):
        ids = [int(t) for t in ids]
        if self.eos_id in ids:
            ids = ids[:ids.index(self.eos_id)]
        return " ".join(str(t) for t in ids if t != self.pad_id) or "x"


def example_batch(rng, n_anchor, n_aux, image_size, seq_len, vocab_size):
    """``__graft_entry__._example_batch``'s layout: anchors first, aux view j
    belongs to anchor j % n_anchor, indication ids and masks."""
    total = n_anchor + n_aux
    pids = np.concatenate([np.arange(n_anchor), np.arange(n_aux) % n_anchor]).astype(np.int32)
    return {
        "images": rng.normal(size=(total, image_size, image_size, 3)).astype(np.float32),
        "ids": rng.integers(5, vocab_size - 3, size=(n_anchor, seq_len)).astype(np.int32),
        "mask": np.ones((n_anchor, seq_len), np.int32),
        "pids": pids,
        "valid": np.ones(total, bool),
        "inc_ids": rng.integers(5, vocab_size - 3, size=(n_anchor, seq_len)).astype(np.int32),
        "inc_mask": np.ones((n_anchor, seq_len), np.int32),
    }


def _launches():
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention

    return lineage_attention.launches, fused_logit_topk.launches


def layout(n: int):
    """JAX's ``dryrun_multichip`` layout of ``n`` ranks: (dp, mp)."""
    return (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)


def run(mesh) -> None:
    """The five stages on this rank of ``mesh`` (stages 1-4 on it, stage 5
    on a pure-dp mesh of the same ranks)."""
    from evoke_tpu_torch.core.checkpoint import CheckpointManager
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.core.mesh import MeshSpec, create_mesh, shard_batch
    from evoke_tpu_torch.decode.continuous import ContinuousServer
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.parallel.collectives import all_gather_batch, barrier, gather_objects
    from evoke_tpu_torch.parallel.tp import (full_state_dict, replicate_params,
                                             shard_params_tp)
    from evoke_tpu_torch.params import init_params_
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_generate_step, make_train_step

    t0 = time.monotonic()
    dp, mp, n, dev = mesh.dp, mesh.mp, mesh.world_size, mesh.device
    where = f"dp={dp}, mp={mp}"
    say = (lambda msg: print(f"dryrun({n}): {msg} [{time.monotonic() - t0:.0f}s]",
                             flush=True)) if mesh.rank == 0 else (lambda msg: None)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    rng = np.random.default_rng(0)
    batch = example_batch(rng, 2 * dp, 2 * dp, 32, 16, VOCAB)
    local = shard_batch(batch, mesh)

    def new_model(seed=None, **kw):
        with torch.device(dev):
            m = FinetuneModel(vocab_size=VOCAB, **{"fusion_wide_qkv": False, **TINY, **kw})
        if seed is not None:
            init_params_(m, seed)
        return m

    def new_state(model):
        return TrainState(model, build_optimizer("RAdam", "finetune", model, pt_lr=5e-6,
                                                 ft_lr=5e-5, weight_decay=1e-4))

    # stage 1: one train step
    model = shard_params_tp(new_model(0), mesh)
    state = new_state(model)
    step = make_train_step(model, state.opt, 0, with_indication=True, mesh=mesh)
    model.train()
    loss = float(step(state, local)["all_loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    say(f"train ok ({where}), loss={loss:.4f}")

    # stage 2: beam-3 decode of this rank's anchors, the tokens gathered
    model.eval()
    gen = make_generate_step(model, _Tok(), DecodeConfig(beam_size=3), 16,
                             with_indication=True, device=dev, mesh=mesh)
    seqs = all_gather_batch(gen(local), mesh)
    assert tuple(seqs.shape) == (2 * dp, 16), f"decode shape {tuple(seqs.shape)}"
    say(f"decode ok ({where}), beam=3 seqs {tuple(seqs.shape)}, captured={gen.captured}")

    # stage 3: save (rank 0 writes the full tensors), restore (each rank's
    # slice), a re-shard into one unsharded device, one more step
    ckpt_dir = gather_objects(tempfile.mkdtemp(prefix="evoke_torch_dryrun_ckpt_")
                              if mesh.rank == 0 else None, mesh)[0]
    mgr = CheckpointManager(ckpt_dir, mesh=mesh)
    mgr.save("current", state, {"epoch": 1, "monitor_best": loss})
    want = full_state_dict(model)
    model2 = shard_params_tp(new_model(), mesh)
    state2 = new_state(model2)
    meta = mgr.restore("current", state2)
    assert int(meta["epoch"]) == 1 and state2.step == state.step
    for k, v in full_state_dict(model2).items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    if mesh.rank == 0:
        one = new_model()
        CheckpointManager(ckpt_dir).restore("current", one)
        for k, v in one.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    step2 = make_train_step(model2, state2.opt, 0, with_indication=True, mesh=mesh)
    model2.train()
    loss2 = float(step2(state2, local)["all_loss"])
    assert np.isfinite(loss2), f"non-finite post-restore loss {loss2}"
    barrier(mesh)
    if mesh.rank == 0:
        shutil.rmtree(ckpt_dir)
    say(f"ckpt ok ({where}), restored == saved, re-sharded to one device == saved, "
        f"post-restore loss={loss2:.4f}")

    # stage 4: the wide fusion (per-head dim = d_vf) under the same mesh
    wide = shard_params_tp(new_model(1, visual_encoder="vit_b32", d_vf=64,
                                     fusion_wide_qkv=True), mesh)
    wstate = new_state(wide)
    wbatch = shard_batch(example_batch(rng, 2 * dp, 2 * dp, 32, 16, VOCAB), mesh)
    wide.train()
    wloss = float(make_train_step(wide, wstate.opt, 1, with_indication=True,
                                  mesh=mesh)(wstate, wbatch)["all_loss"])
    assert np.isfinite(wloss), f"non-finite wide-fusion loss {wloss}"
    say(f"wide-fusion ok ({where}, wide_qkv), loss={wloss:.4f}")

    # stage 5: the continuous engine slot-sharded over a pure-dp mesh of all
    # the ranks, K1 + K2 per rank
    model2 = replicate_params(model2).eval()
    mesh = create_mesh(MeshSpec(dp=n), device=dev.type,
                       devices=[str(dev)] * n if dev.type == "cuda" else None)
    batch = example_batch(rng, 2 * n, 2 * n, 32, 16, VOCAB)
    k0 = _launches()
    srv = ContinuousServer(model2, _Tok(), max_seq_len=16, slots=n, beam_size=2,
                           seg_steps=4, dispatch_segs=2, pack_batches=1,
                           beam_kv="ancestor", mesh=mesh)
    loader = [{**batch, "_image_ids": [f"s{i}_{j}" for j in range(2 * n)]}
              for i in range(2)]
    recs, st = srv.serve(loader)
    k1, k2 = (b - a for a, b in zip(k0, _launches()))
    assert len(recs) == 4 * n, (len(recs), 4 * n)
    assert all(r["report"] for r in recs)
    assert srv.ancestor_kv and srv.fused_topk
    if dev.type == "cuda":
        assert k1 > 0 and k2 > 0, f"K1 {k1} / K2 {k2} launches on the card"
    say(f"engine ok (pure-dp={n}, slots={n}, {len(recs)} reports, "
        f"{st['segment_steps']:.0f} steps, rank 0 launches K1={k1} K2={k2})")


def dryrun(n: int, device="cuda", devices=None, backend=None, timeout_s=None) -> None:
    """Spawn ``n`` ranks in JAX's layout (``layout``) and run the five
    stages. ``devices`` lists each rank's device (ranks may then share a
    card, over ``backend="gloo"``)."""
    from evoke_tpu_torch.core.mesh import MeshSpec, spawn

    dp, mp = layout(n)
    if timeout_s is None:
        timeout_s = float(os.environ.get("EVOKE_DRYRUN_BUDGET_S", 900))
    spawn(run, spec=MeshSpec(dp=dp, mp=mp), device=device, devices=devices,
          backend=backend, timeout_s=timeout_s)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    dryrun(int(args[0]) if args else 2, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
