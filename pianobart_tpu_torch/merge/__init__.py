from .methods import (average_merging, collect_dense_grams, combine,
                      compute_fisher_weights, fisher_merging, mask_model_weights,
                      mask_tensor, regmean_merging, task_arithmetic, task_vector,
                      ties_merging)
