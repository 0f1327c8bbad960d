"""Share of the traced window in which the card was idle while the
program's ``lib.emit`` span (models/blocks.py render_batch: the loop
over a batch's payloads through the C ANSI emitter) was the innermost
span open; read as idle_in_resize_pct.lib reads its span."""

from harness import spec


def read(r):
    return spec.metric_module("idle_in_resize_pct.lib").idle_in(
        r, "lib.emit")
