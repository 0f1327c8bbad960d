"""Share of the traced window in which no kernel, copy or memset ran on
the card (torch.profiler's device activity).  Its spans name the
breakdown's idle gaps: the host inside a model's batch, outside it."""

SPANS = {"pipeline": [
    "timg_tpu_torch.models.blocks:_BlockModel.process_batch"]}


def read(r):
    if r.trace is None or not r.trace.intervals:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.seconds)
