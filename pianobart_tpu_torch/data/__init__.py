from .datasets import (DEFAULT_PRETRAIN_DATASETS, ShardedWindows,
                       concatenate_pretrain, load_finetune, load_pretrain)
