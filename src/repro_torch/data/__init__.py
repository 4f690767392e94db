"""Phase-III dataset output of the port: the sharded writer and reader."""

from repro_torch.data.shards import DatasetWriter, ShardedDataset, write_dataset

__all__ = ["DatasetWriter", "ShardedDataset", "write_dataset"]
