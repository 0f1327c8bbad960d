"""PostScript (.ps/.eps) rendering via a ghostscript subprocess.

The port's copy of timg_tpu/sources/ps_source.py; only the imports differ.

Role of the full-GM reference's PS coder: GraphicsMagick has no native
PostScript interpreter either — its PS/EPS coders shell out to the
``gs`` delegate, rasterize pages, and the multi-image blacklist rule
(ref src/graphics-magick-source.cc:193-214: ``.ps`` is in
{.ico,.pdf,.ps,.txt}) shows the pages *stacked*, never as an
animation.  This source mirrors that architecture: gs renders every
page to PNG in a temp dir, pages honor --frame-offset/--frames like
the PDF source, and send_frames stacks them.

Environment-gated like the SVG/PDF/OpenSlide sources: when no gs
binary is on PATH, loading raises a RuntimeError whose message becomes
the CLI diagnostic (a GM-less/GS-less reference build fails the same
way, silently with exit 1).

Deliberate quality deviation (documented in ROADMAP.md): GM rasterizes
at a fixed 72 dpi and upscales; we pick the render dpi so the raster
meets the display target (supersampled, capped 8x) before the exact
polyphase resize — strictly sharper output on large sixel/kitty
displays, identical layout.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
from typing import List, Optional

from timg_tpu_torch.geometry import calc_scale_to_fit
from timg_tpu_torch.options import DisplayOptions
from timg_tpu_torch.sources.base import FrameSink, ImageSource, PreprocessedFrame

# DSC header scan budget: %%BoundingBox normally sits in the first
# comment block; 32 KB covers generators that emit long prologs.
_DSC_SCAN_BYTES = 32768
_LETTER_PTS = (612.0, 792.0)  # gs default page device (US letter)
_MAX_SUPERSAMPLE = 8.0
_GS_TIMEOUT_S = 60


def find_gs() -> Optional[str]:
    """Locate the ghostscript delegate (split out for tests)."""
    return shutil.which("gs") or shutil.which("ghostscript")


def _page_size_points(path: str) -> tuple:
    """(width_pts, height_pts) from the DSC %%BoundingBox, else the gs
    default letter size.  (atend) and malformed boxes fall back too."""
    try:
        with open(path, "rb") as f:
            head = f.read(_DSC_SCAN_BYTES)
    except OSError:
        return _LETTER_PTS
    m = re.search(
        rb"^%%BoundingBox:\s*(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)"
        rb"\s+(-?[\d.]+)", head, re.MULTILINE)
    if not m:
        return _LETTER_PTS
    try:
        llx, lly, urx, ury = (float(v) for v in m.groups())
    except ValueError:
        return _LETTER_PTS
    if urx <= llx or ury <= lly:
        return _LETTER_PTS
    return urx - llx, ury - lly


class PSSource(ImageSource):
    """Multi-page PostScript, pages rendered by gs and shown stacked."""

    def __init__(self, filename: str):
        super().__init__(filename)
        self.decoder_name = "postscript"
        self._options: Optional[DisplayOptions] = None

    def load_and_scale(self, options: DisplayOptions, frame_offset: int,
                       frame_count: int) -> bool:
        fname = self.filename.lower()
        if not fname.endswith((".ps", ".eps")):
            return False
        try:
            with open(self.filename, "rb") as f:
                magic = f.read(4)
        except OSError:
            return False
        # DSC text PostScript only; DOS-EPS binary headers (C5 D0 D3 C6)
        # carry a preview offset table gs does not accept directly.
        if not magic.startswith(b"%!"):
            return False
        gs = find_gs()
        if gs is None:
            raise RuntimeError(
                f"{self.filename}: PostScript support needs the "
                "ghostscript delegate (gs), which is not available "
                "(like a timg build whose GraphicsMagick lacks gs)")

        pts_w, pts_h = _page_size_points(self.filename)
        target_w, target_h, _ = calc_scale_to_fit(pts_w, pts_h, options)
        scale = max(1.0, min(_MAX_SUPERSAMPLE,
                             target_w / pts_w, target_h / pts_h))
        dpi = max(1, round(72.0 * scale))

        with tempfile.TemporaryDirectory(prefix="timg_tpu_ps") as tmp:
            out_pattern = os.path.join(tmp, "p%04d.png")
            cmd = [gs, "-q", "-dSAFER", "-dBATCH", "-dNOPAUSE",
                   "-sDEVICE=png16m", f"-r{dpi}",
                   "-dTextAlphaBits=4", "-dGraphicsAlphaBits=4",
                   f"-sOutputFile={out_pattern}"]
            if fname.endswith(".eps"):
                cmd.append("-dEPSCrop")
            cmd.append(os.path.abspath(self.filename))
            try:
                proc = subprocess.run(
                    cmd, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL, stdin=subprocess.DEVNULL,
                    timeout=_GS_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired):
                return False
            pages = sorted(os.listdir(tmp))
            # gs exits non-zero on hard errors but may still have
            # rendered leading pages; like GM, show what decoded.
            if not pages or (proc.returncode != 0 and not pages):
                return False

            start = max(0, frame_offset)
            end = len(pages) if frame_count < 0 else min(
                len(pages), start + frame_count)

            import numpy as np
            from PIL import Image

            from timg_tpu_torch.sources.pil_source import (_process_frames,
                                                     _to_rgba)

            frames: List[PreprocessedFrame] = []
            for name in pages[start:end]:
                try:
                    with Image.open(os.path.join(tmp, name)) as img:
                        rgba = _to_rgba(img)
                except Exception:
                    return False
                rgba = np.ascontiguousarray(rgba)
                processed = _process_frames(
                    [rgba], target_w, target_h, options)
                frames.append(PreprocessedFrame(frame=processed[0]))

        if not frames:
            return False
        self.frames = frames
        self.max_frames = len(frames)
        # GM reports the 72-dpi raster size == the page point size.
        self.orig_width = int(round(pts_w))
        self.orig_height = int(round(pts_h))
        self._options = options
        return True

    def is_animation_before_frame_limit(self) -> bool:
        return False  # pages are not an animation

    def send_frames(self, duration_ms: float, loops: int, interrupt,
                    sink: FrameSink) -> None:
        """Every page once, immediately, stacked (blacklist semantics,
        ref graphics-magick-source.cc:196-214)."""
        from timg_tpu_torch.render.sequencer import SeqType

        opts = self._options
        for f in self.frames:
            if interrupt():
                break
            dx = 0
            if opts is not None and opts.center_horizontally:
                dx = int((opts.width - f.frame.shape[1]) / 2)
            sink(dx, 0, f.frame, SeqType.FRAME_IMMEDIATE, 0.0)
