"""Video source of the port (counterpart of
timg_tpu/sources/video_source.py:VideoSource).

Decode, pacing, looping and the 8-frame window pipeline are inherited
from the JAX package's source (they are host code around the native
libav helper).  What changes is the window: 4:2:0 Y/U/V planes go to
the port's device flow (render/plane_cache.prime_sixel_video_device).
Streams that would take another path in the reference (RGBA decode,
transparent-capable suffixes, swscale resampling) are not yet ported.
"""

from __future__ import annotations

from typing import List

import numpy as np

from timg_tpu.sources import video_source as _ref
from timg_tpu_torch.render.plane_cache import (not_ported,
                                               prime_sixel_video_device)


class VideoSource(_ref.VideoSource):

    def load_and_scale(self, options, frame_offset: int,
                       frame_count: int) -> bool:
        resample = getattr(options, "resample", "auto")
        if resample != "auto":
            raise not_ported(f"--resample={resample}")
        if not super().load_and_scale(options, frame_offset, frame_count):
            return False
        if not self._use_yuv:
            raise not_ported("video that is not opaque 8-bit 4:2:0 "
                             "(RGBA window path)")
        return True

    def _process_window(self, raw: List, kind: str = "rgba"
                        ) -> List[np.ndarray]:
        """One device window: raw = list of (y, u, v) plane triples."""
        if kind != "yuv":
            raise not_ported(f"the {kind!r} video window")
        tw, th = self._target
        ys = np.stack([f[0] for f in raw])
        us = np.stack([f[1] for f in raw])
        vs = np.stack([f[2] for f in raw])
        return prime_sixel_video_device(ys, us, vs, th, tw, self._full_range,
                                        self._options, self._sixel_state)
