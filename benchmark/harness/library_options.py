"""The embeddable library API with a model's options: driven as
harness/library.py drives it (one caller, batch after batch, each call
waited for; payload g is pool frame g % pool_frames), the model built
with the configuration's ``options`` as keyword arguments beside
``out_h``, ``out_w`` and ``bg_color``: for the sixel model, its
``dither`` mode and ``adaptive_reuse``.

The sixel payloads must all come from the program's C assembler: a run
in which its Python twin assembled one measured another path, and fails
when it reports its notes.

This kind differs from ``library`` in the options alone: once
library.Run.setup passes ``options`` and runner.py's ``python_twin``
counts the sixel assembler's Python twin, the sixel cell can be the
``library`` kind and this file can go."""

from __future__ import annotations

from harness import library
from harness.frames import make_pool


def assembled() -> dict:
    """Sixel payloads each assembler of the program has written in this
    process (render/sixel_render.py ``ASSEMBLED``)."""
    from timg_tpu_torch.render import sixel_render

    return dict(sixel_render.ASSEMBLED)


class Run(library.Run):
    def setup(self) -> None:
        """library.Run.setup, with the configuration's ``options``."""
        from timg_tpu_torch import models

        self.assembled_before = assembled()
        cfg, frames = self.config, self.config["frames"]
        self.model = models.get(cfg["model"])(
            out_h=int(cfg["out_h"]), out_w=int(cfg["out_w"]),
            bg_color=tuple(cfg["bg_color"]), **cfg.get("options", {}))
        n = int(self.traffic["pool_frames"])
        if n % self.batch:
            raise ValueError("pool_frames must be a multiple of the batch")
        self.pool = make_pool(self.traffic["content"], n,
                              int(frames["height"]), int(frames["width"]),
                              self.seed)

    def notes(self) -> dict:
        now = assembled()
        by = {k: now[k] - self.assembled_before.get(k, 0) for k in now}
        if by.get("python"):
            raise RuntimeError(
                f"{by['python']} sixel payloads came from the program's "
                "Python twin of its C assembler: another path than the "
                "one measured")
        return {**super().notes(), "sixel payloads assembled": by}
