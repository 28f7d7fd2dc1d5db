"""Row sharding of the device index over several devices (PyTorch port of
omni_recall_tpu/parallel/): the shard mesh (``mesh``), the process-group
setup across hosts (``distributed``) and the sharded scorer with its
all-gather merge and exact-zero combine (``sharded``)."""

from omni_recall_tpu_torch.parallel.mesh import shards_mesh  # noqa: F401
from omni_recall_tpu_torch.parallel.sharded import ShardedScorer  # noqa: F401
