"""Port parity: the trainers over a data-parallel mesh (2 gloo ranks on the
CPU, the rank bodies in ``_torch_port_dp.py``) against the same trainers in
one process, over the CLI's loaders on a synthetic dataset.

One epoch of ``PretrainTrainer`` and of ``FinetuneTrainer`` (train steps,
then the eval step or the val / test decode): both ranks end with the same
parameters bit for bit, the epoch's losses are the one-process run's within
1e-3 relative (96 px images: the ResNet's batch-statistics BatchNorms
amplify the rounding of statistics summed over two ranks, and at 32 px they
amplify it past 1 % within two steps), and rank 0 alone writes the run's
files: one epoch record, the prediction columns. No checkpoint is saved
(each holds the full ResNet-101 and its moments, ~0.7 GB): the dry run
(test_torch_port_parallel.py) saves and restores one over the mesh."""

import json
import math
import os

import torch

from evoke_tpu_torch.data.synthetic import write_synthetic_dataset
from evoke_tpu_torch.data.tokenizer import build_tokenizer

import _torch_port_dp as dpcase
from test_torch_port_cli import TINY as CLI_TINY

torch.set_num_threads(2)


def test_trainers_over_dp_train_the_global_batch(tmp_path):
    root = str(tmp_path)
    ann = write_synthetic_dataset(root, n_train=4, n_val=2, n_test=2, image_size=96, seed=1)
    argv = ["--data.ann_path", ann, "--data.image_dir", root,
            "--data.tokenizer_dir", os.path.join(root, "tok"),
            "--trainer.result_dir", os.path.join(root, "results")] + CLI_TINY + [
        "--model.image_size", "96", "--trainer.save_period", "100"]
    with open(os.path.join(root, "argv.json"), "w") as f:
        json.dump(argv, f)
    build_tokenizer(os.path.join(root, "tok"), "mimic_cxr", ann_path=ann)
    one = {task: dpcase.trainer_run(None, root, task, f"one_{task}")
           for task in ("pretrain", "finetune")}
    ranks = dpcase.spawn_case(dpcase.trainers, os.path.join(root, "inputs"), timeout_s=240)
    for task, (want, _) in one.items():
        (log0, digest0), (log1, digest1) = ranks[0][task], ranks[1][task]
        assert digest0 == digest1 and log0 == log1
        losses = [k for k in want if k.endswith(("loss", "_lm"))]
        assert losses and sorted(log0) == sorted(want)
        for k in losses:
            assert math.isclose(log0[k], want[k], rel_tol=1e-3), (task, k, log0[k], want[k])
        run = os.path.join(root, "results", "mimic_cxr", task, f"dp_{task}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            assert [json.loads(line)["event"] for line in f] == ["epoch"]
    run = os.path.join(root, "results", "mimic_cxr", "finetune", "dp_finetune")
    with open(os.path.join(run, "val_prediction.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0].split(",")[-1] == "pred_1" and len(rows) == 3
