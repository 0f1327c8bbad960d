"""Protocol model families of the port: the embeddable library API
(counterpart of timg_tpu/models/__init__.py).

Each model bundles a device pipeline (torch ops and the port's CUDA
kernels) with a host byte-emitter for one terminal protocol family:
hand a model a frame batch, it returns per-frame escape payloads.

    model = timg_tpu_torch.models.get("sixel")(out_h=720, out_w=1280,
                                               dither="cube")
    payloads = model.render_batch(frames_u8)   # [B,H,W,4] -> list[bytes]

Every model of the JAX package is ported: half, quarter, sixel, kitty
and iterm2.
"""

from timg_tpu_torch.models.blocks import (HalfBlockModel,  # noqa: F401
                                          QuarterBlockModel)
from timg_tpu_torch.models.pixel import (ITerm2Model,  # noqa: F401
                                         KittyModel, SixelModel)

_REGISTRY = {
    "half": HalfBlockModel,
    "quarter": QuarterBlockModel,
    "sixel": SixelModel,
    "kitty": KittyModel,
    "iterm2": ITerm2Model,
}


def get(name: str):
    return _REGISTRY[name]


def available() -> list:
    return sorted(_REGISTRY)
