"""``paddle.io`` of the port (counterpart of ``paddle_tpu/io``): datasets,
samplers, the ``DataLoader`` (batches collated on the host), bucketing and
the ``DeviceLoader`` (prefetched host-to-card copies on a side stream,
``stack_batches=K`` windows for ``TrainStep(accumulate_steps=K)``)."""
from .dataset import (  # noqa: F401
    Dataset, IterableDataset, TensorDataset, ComposeDataset, ChainDataset,
    ConcatDataset, Subset, random_split, get_worker_info, WorkerInfo,
)
from .sampler import (  # noqa: F401
    Sampler, SequenceSampler, RandomSampler, WeightedRandomSampler, BatchSampler,
    DistributedBatchSampler,
)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .device_loader import DeviceLoader, batch_sharding, stack_microbatches  # noqa: F401
from .bucketing import (  # noqa: F401
    DEFAULT_BOUNDARIES, bucket_length, pad_to_bucket, padding_attn_mask,
    BucketingCollate, LengthGroupedBatchSampler,
)
