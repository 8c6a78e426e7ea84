"""Host-side data structures: rollout batch structs, datasets."""

from rlinf_tpu_torch.data.io_struct import RolloutRequest, RolloutResult, TrainBatch, build_train_batch

__all__ = ["RolloutRequest", "RolloutResult", "TrainBatch", "build_train_batch"]
