"""Protocol model families of the port: the embeddable library API
(counterpart of timg_tpu/models/__init__.py).

Each model bundles a device pipeline (torch ops and the port's CUDA
kernels) with a host byte-emitter for one terminal protocol family:
hand a model a frame batch, it returns per-frame escape payloads.

    model = timg_tpu_torch.models.get("sixel")(out_h=720, out_w=1280,
                                               dither="cube")
    payloads = model.render_batch(frames_u8)   # [B,H,W,4] -> list[bytes]

Only the sixel model is ported; ``get`` of the JAX package's other
names (half, quarter, kitty, iterm2) raises "not yet ported".
"""

from timg_tpu_torch.models.pixel import SixelModel  # noqa: F401

_REGISTRY = {
    "sixel": SixelModel,
}

_NOT_PORTED = ("half", "quarter", "kitty", "iterm2")


def get(name: str):
    if name in _NOT_PORTED:
        from timg_tpu_torch.render.plane_cache import not_ported
        raise not_ported(f"the {name!r} model")
    return _REGISTRY[name]


def available() -> list:
    return sorted(_REGISTRY)
