from evoke_tpu_torch.evals.nlg import bleu, cider_d, meteor_lite, rouge_l, compute_nlg_scores
