from perception_tpu_torch.parallel.sharding import (  # noqa: F401
    make_pose_mesh,
    score_pose_batch_multichip,
)
