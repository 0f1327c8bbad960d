"""Long-form help, paged like the reference's embedded manpage
(ref src/timg-help.cc:28-45: gunzip embedded manpage into $PAGER).

Coverage matches the reference's man/timg.1.md section-for-section
(NAME/SYNOPSIS/DESCRIPTION/OPTIONS incl. the per-flag subtleties,
SCROLLING, ANIMATIONS, PIXELATION notes, ENVIRONMENT, EXAMPLES, EXIT
CODES), with the timg-tpu extensions and TIMG_TPU_* variables added.
"""

from __future__ import annotations

import os
import subprocess
import sys

MANPAGE = """\
timg-tpu(1)                     User Commands                    timg-tpu(1)

NAME
    timg-tpu - a TPU-accelerated terminal image and video viewer

SYNOPSIS
    timg-tpu [options] <image/video> [<image/video>...]
    timg-tpu [options] -f <filelist>

DESCRIPTION
    timg-tpu renders images and videos in the terminal using unicode
    half/quarter blocks, or - where the terminal supports them - the
    sixel, kitty or iTerm2 graphics protocols. Host code decodes and
    assembles escape streams; all pixel processing (resizing, alpha
    composition, auto-cropping, block glyph selection, sixel palette
    quantization and Floyd-Steinberg dithering) runs as batched
    JAX/XLA/Pallas programs on TPU, with bit-exact CPU mirrors for
    hosts without an accelerator. One-shot still images render through
    a native fastpath with no accelerator runtime startup at all.

    Shown images are scaled to fit the available terminal area unless
    -g is given, keeping aspect ratio and correcting for the terminal
    font's cell shape. Images are never scaled up unless -U is given.

OPTIONS
    -p <pixelation>, --pixelation=<pixelation>
        Pixelation mode: h(alf) blocks, q(uarter) blocks, k(itty),
        i(term2), s(ixel). Only the first character matters; 'half'
        and 'h' are equivalent. Without -p, timg-tpu auto-detects: if
        the terminal reports a graphics protocol (kitty, iTerm2 or
        sixel via device attributes), that is used; otherwise quarter
        blocks. Half blocks show one terminal-colored pixel pair per
        cell and survive copy-paste better; quarter blocks double the
        horizontal resolution by choosing among 2x2 sub-block glyphs
        with a least-squares color fit per cell.

    --grid=<cols>[x<rows>]
        Arrange multiple images in a grid ("contact sheet") of the
        given number of columns; rows defaults to columns. Each cell
        receives an equal share of the terminal area. With --title,
        each image gets its own headline. Grid cells from still images
        are rendered in one batched device dispatch.

    -C, --center
        Center images horizontally in the available width.

    --title[=<format>]
        Print a title above each image. Every occurrence of --title
        toggles the title on/off (so it can override a TIMG_DEFAULT_
        TITLE-induced default); a =<format> value also sets the format
        string. Placeholders: %f full filename, %b basename, %w image
        width, %h image height, %D decoder used. Default format: %f.

    -f <filelist>
        Read a newline-separated list of image files to show. Relative
        paths in the list are relative to the current directory. Can
        be given multiple times, and mixed with files on the command
        line; "-f -" reads the list from stdin.

    -F <filelist>
        Like -f, but relative filenames in the list are interpreted
        relative to the directory the filelist itself is in.

    -b <background-color>
        Background color to compose transparent images over. Accepts
        an HTML/X11 color name ('red', 'rebeccapurple', ...),
        '#rrggbb' hex, 'rgb(r, g, b)' (decimal or 0x hex components),
        the special value 'auto' (query the terminal for its actual
        background color, with a safe fallback if it does not answer),
        or 'none' (no composition; alpha is left to the terminal in
        kitty/iTerm2 modes). Default: auto for block/sixel modes, none
        for kitty/iTerm2.

    -B <checkerboard-other-color>
        Show transparent images on a checkerboard of -b and -B colors.

    --pattern-size=<n>
        Integer scale factor of the checkerboard pattern squares.

    --auto-crop[=<pre-crop>]
        Trim a same-color border before scaling. The optional value
        crops that many pixels on every edge first (useful to remove a
        thin decorative frame before the flat border detection runs).
        Animations are not auto-cropped (geometry must stay stable).

    --rotate=<exif|off>
        Apply (default) or ignore EXIF orientation.

    -W, --fit-width
        Scale to fill the full width of the available area even if the
        height overflows the terminal (the terminal scrolls).

    -U, --upscale[=i]
        Allow scaling images above their natural size (off by
        default). Every occurrence toggles; --upscale=i restricts to
        integer scale factors for pixel-art-exact magnification.

    --clear[=every]
        Clear the screen (and scrollback position) before showing the
        first image; with =every (any unambiguous prefix, case-
        insensitive), before every image. In a grid, =every degrades
        to the before-first behavior.

    -V  Only consider the video decoder for all inputs. Useful for
        video on stdin ("timg-tpu -V -"), which cannot be probed as an
        image without consuming the stream.

    -I  Only consider image decoders; never attempt video decoding.

    -w <seconds>
        Wait this long after every image (C float parse; 'r' prefix -
        see next entry).

    -wr <seconds>
        In a grid: wait after every *row* instead of every image.

    -a  Disable antialiasing: nearest-neighbor sampling instead of the
        filtered resize. Fast and crisp for pixel art.

    -g <width>x<height>
        Output geometry in character cells. Either dimension may be
        omitted ("-g80x" / "-gx24") to keep the terminal-derived
        value. Default: terminal size minus a 2-cell margin.

    -o <outfile>
        Write the escape stream to a file instead of stdout. The
        stream replays with "cat outfile" on a compatible terminal.

    -E  Don't hide the cursor while showing images.

    --compress[=<0..9>]
        PNG deflate level for the kitty/iTerm2 protocols. Bare
        --compress or an out-of-range value selects 1 (speed).
        0 disables compression.

    --threads=<n>
        Decode thread pool size. Default: 3/4 of the hardware threads.

    --color8
        Use 8-bit (256-color) SGR sequences in block modes instead of
        24-bit truecolor, for terminals without truecolor support.

    --version
        Print version and component information (decoders, device
        backend, native runtime) and exit.

    --verbose
        Print terminal query details before, and transfer statistics
        after the run (bytes written, throughput, frames, fps for
        longer animations, relevant environment variables).

    -h  Short option summary.     --help  This page.

SCROLLING
    --scroll[=<ms>]
        Scroll text or wide images horizontally through the terminal
        (marquee), one step every <ms> milliseconds (default 50).

    -d <dx:dy>, --delta-move=<dx:dy>
        Scroll direction in pixels per step; dy may be omitted.
        Default 1:0 (rightward). 0:0 disables scrolling with a note.

ANIMATIONS AND VIDEOS
    -t <seconds>
        Stop an animation or video after this time budget.

    -c <num>, --loops=<num>
        Play the animation/video this many rounds; -1 or bare --loops
        means forever. Defaults: videos play once; GIF animations and
        APNGs loop forever - unless multiple files are on the command
        line, in which case everything plays once so the show
        terminates.

    --frames=<n>
        Only use the first n frames of an animation/video. With
        --frames=1 an animation renders as a still.

    --frame-offset=<n>
        Skip this many frames before starting (images and video).

    Videos decode through the native libav runtime at full rate; 4:2:0
    streams ship raw YUV planes to the device (1.5 bytes/pixel) with
    the BT.601 conversion fused into the device resize.

TIMG-TPU EXTENSIONS
    --dither=<libsixel|adaptive|cube>
        Sixel quantization strategy. Default 'libsixel': still images
        run a faithful reimplementation of libsixel's quant.c (the
        library the reference viewer uses) - sampled histogram,
        median-cut palette, cached integer Floyd-Steinberg - and
        videos/animations run the same palette construction per frame
        with a bucket-table variant of the lookup cache on the device
        (see docs for the one documented deviation). 'adaptive' builds
        one median-cut tree palette per animation segment and dithers
        by tree descent at the highest device rate for an adaptive
        palette. 'cube' uses a fixed 6x7x6 color cube with an
        arithmetic quantizer - the fastest video mode. 'auto' picks
        'libsixel' unless the session opens with a video whose native
        frame rate exceeds the libsixel kernel's measured device floor
        (TIMG_TPU_LIBSIXEL_FLOOR_FPS, default 1700 frames/s), in which
        case the faster 'adaptive' path plays it; the choice is made
        once per session so all frames stay byte-consistent.

    --resample=<auto|sws|sws-bitexact>
        Video frame resampling. 'auto' (default) ships raw YUV planes
        to the device and resizes there (BT.601 + MXU resampling).
        'sws' scales each decoded frame on the host with swscale
        SWS_BILINEAR straight to display size in one call - the exact
        pipeline of a full-featured reference timg build, so output
        bytes match such a build linked against the same libswscale.
        'sws-bitexact' runs the same swscale algorithm as a device
        kernel with SWS_BITEXACT (platform-independent) arithmetic,
        keeping the raw-YUV device transport while byte-matching a
        reference build run with bitexact flags; falls back to the
        host 'sws' leg for geometries the kernel does not model (odd
        display widths, non-4:2:0 streams, transparent suffixes).

    --devices=<n|auto>
        Shard sustained frame-batch work (video windows, animations,
        batched dither planes) over n CUDA cards, cuda:0 to cuda:n-1,
        each shard's kernels launched on its own card; 'auto' uses
        every visible card, and n is clamped to the cards there are.
        Single very large stills (2048x2048 pixels and up) also split
        their rows over the cards so one image uses every card. Output
        is byte-identical to the single-card run. Default 1.

    --serve
        Resident session mode: hold this process warm (torch session,
        CUDA context, kernel library, native helper) and serve
        one-shot invocations over a unix socket
        ($XDG_RUNTIME_DIR/timg-tpu-torch.sock, else
        /tmp/timg-tpu-torch-<uid>.sock; override TIMG_TPU_SERVE_SOCKET).
        Clients pass their terminal fds, so served runs behave exactly
        like direct ones; the timg-tpu-torch launcher sends its
        invocation there, before importing torch, whenever the socket
        exists (TIMG_TPU_NO_SERVE=1 disables). The socket is created
        0600; the launcher uses it only when its own user owns it and
        the server runs as that user, and the server serves only peers
        of its own uid. A request for another TIMG_TPU_TORCH_DEVICE,
        CUDA_VISIBLE_DEVICES or CUDA_DEVICE_ORDER, or a nested --serve,
        is handed back to the launcher, which runs it itself. Each
        request is cut off
        after TIMG_TPU_SERVE_REQUEST_TIMEOUT seconds (default 300).
        SIGTERM or SIGINT stops the server and removes the socket.
        Byte-identical to cold runs.

ENVIRONMENT
    TIMG_DEFAULT_TITLE
        Default --title format string (default "%f").

    TIMG_PIXELATION
        Default pixelation mode when -p is not given (same values).
        Auto-detection applies when neither is set.

    TIMG_USE_UPPER_BLOCK
        Set to 1 to use U+2580 'Upper Half Block' instead of the
        default U+2584 'Lower Half Block' in block modes. The default
        renders best on most tested terminals; flip this if your
        terminal/font combination shows seams between cells.

    TIMG_FONT_WIDTH_CORRECT
        Floating-point horizontal stretch correction for fonts whose
        cells are not exactly twice as tall as wide. E.g. 1.1 widens
        images by 10%. Set once in your profile for your terminal.

    TIMG_ALLOW_FRAME_SKIP
        Set to 1 to let playback drop frames when it falls behind
        (slow connections or very high-rate videos); at most 250 ms of
        skew accumulates before frames are skipped.

    TIMG_SIXEL_NEWLINE_WORKAROUND
        2-bit quirk mask (0..3) for sixel terminals whose cursor ends
        up in different positions after a sixel image; adjust if
        videos 'scroll' or grid cells misalign vertically. Normally
        auto-detected from the terminal identification. Default 0.

    TIMG_TPU_DEVICES
        Default for --devices.

    TIMG_TPU_COMPILE_CACHE
        Persistent XLA compile cache directory so one-shot runs don't
        recompile kernels per process (default ~/.cache/timg-tpu/jax;
        set empty to disable).

    TIMG_TPU_FORCE_NUMPY
        Force every pixel op onto the strict CPU mirrors (bit-exact
        with the device kernels) and pin jax to the cpu backend.
        The reference-parity test harnesses use this.

    TIMG_TPU_FORCE_DEVICE
        Pin every routed dispatch to the device path, even workloads
        the size heuristic would keep on host (bench/parity use).

    TIMG_TPU_DEVICE_MIN_BATCH
        Frame-count threshold below which one-shot work stays on the
        host mirrors instead of paying a device compile (default 64;
        sustained video/animation windows always use the device).

    TIMG_TPU_NO_FASTPATH
        Disable the native one-shot still fastpath; always run the
        full session path.

    TIMG_TPU_VIDEO_RGBA
        Disable the raw YUV 4:2:0 device transport; convert video
        frames to RGBA on host via swscale like the reference.

    TIMG_TPU_PROFILE
        Directory to write a torch.profiler Chrome trace of the show
        to (timg-tpu-torch.<pid>.trace.json): the host's torch calls,
        on the card its kernels and copies, and the program's spans
        (window.*, seq.*) with their byte and frame counts.  The host
        still path (TIMG_TPU_TORCH_DEVICE=cpu) runs without torch and
        writes none; TIMG_TPU_NO_FASTPATH=1 keeps it off.

EXAMPLES
    timg-tpu image.jpg                   Show a JPEG.
    timg-tpu --grid=3x2 --title *.png    Contact sheet with titles.
    timg-tpu -b auto -B gray photo.png   Checkerboard under alpha.
    timg-tpu video.mp4                   Play a video.
    timg-tpu -V -                        Play video from stdin.
    timg-tpu -g60x -U -pq logo.png       Upscaled, fixed width.
    timg-tpu -o out.txt -pq -g80x24 x.png   Record a replayable stream.

EXIT CODES
    0 success; 1 image read error; 2 parameter error; 3 not a
    terminal / unusable geometry; 4 cannot open output file;
    5 filelist problem.

SEE ALSO
    The behavioral reference is hzeller/timg; timg-tpu preserves its
    CLI semantics and escape-stream output byte-for-byte on the
    supported corpus while executing the pixel pipeline on TPU.
"""


def invoke_help_pager() -> int:
    # Shell expansion like the reference's popen("${PAGER:-less}")
    # (ref timg-help.cc:41): PAGER values with arguments ("less -FRX")
    # must work.  A pager the shell can't find exits 127; dump the
    # manpage plainly then.
    pager = os.environ.get("PAGER") or "less"
    try:
        proc = subprocess.Popen(pager, shell=True, stdin=subprocess.PIPE)
        proc.communicate(MANPAGE.encode())
        if proc.returncode == 127:
            sys.stdout.write(MANPAGE)
    except (OSError, BrokenPipeError):
        sys.stdout.write(MANPAGE)
    return 0
