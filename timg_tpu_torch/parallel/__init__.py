"""Sharding over cards of the frame pipeline (counterpart of
timg_tpu/parallel/): ``auto`` routes the CLI's windows, ``mesh`` holds
the (data, space) grid pipelines."""

from timg_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    sharded_quarter_pipeline,
)
