"""Phase-III data of the port: the sharded writer and reader
(:mod:`~repro_torch.data.shards`), and LM batches from a sweep's token
streams (:mod:`~repro_torch.data.sim_dataset`) or synthetic ones
(:mod:`~repro_torch.data.synthetic`)."""

from repro_torch.data.shards import DatasetWriter, ShardedDataset, write_dataset

__all__ = ["DatasetWriter", "ShardedDataset", "write_dataset"]
