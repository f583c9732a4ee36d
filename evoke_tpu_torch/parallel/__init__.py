from evoke_tpu_torch.parallel.collectives import (all_gather_batch, all_reduce_sum,
                                                  make_shardmap_loss, psum_mean)
