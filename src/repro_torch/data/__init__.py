from .pipeline import (BinaryShardWriter, DataConfig, make_batches,
                       synthetic_batch, TokenDataset)
