"""Source factory of the port (counterpart of
timg_tpu/sources/base.py:create_source).

This slice ports the video path only, so the factory offers the port's
VideoSource and nothing else; images fail with a "not yet ported"
message instead of reaching a decoder that would call into jax.
"""

from __future__ import annotations

import os
from typing import Optional

from timg_tpu.options import NOT_INITIALIZED, DisplayOptions
from timg_tpu.sources.base import ImageSource


def create_source(
    filename: str,
    options: DisplayOptions,
    frame_offset: int = 0,
    frame_count: int = NOT_INITIALIZED,
    attempt_image_loading: bool = True,
    attempt_video_loading: bool = True,
) -> tuple[Optional[ImageSource], str]:
    """Returns (source, error_message), like the JAX package's factory."""
    from timg_tpu_torch.sources.video_source import VideoSource

    if filename != "-" and not os.path.exists(filename):
        return None, f"{filename}: No such file or directory"
    if attempt_video_loading:
        count = -1 if frame_count == NOT_INITIALIZED else frame_count
        src = VideoSource(filename)
        try:
            if src.load_and_scale(options, frame_offset, count):
                return src, ""
        except NotImplementedError as e:
            return None, f"{filename}: {e}"
    from timg_tpu.native import runtime
    if runtime.load() is None:
        return None, (f"{filename}: the native video helper is not built "
                      "(make -C timg_tpu/native)")
    return None, (f"{filename}: not a video the native decoder opens; "
                  "images are not yet ported to timg_tpu_torch")
