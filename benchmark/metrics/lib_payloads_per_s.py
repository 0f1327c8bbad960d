"""lib_payloads_per_s: payloads that render_batch returned inside the
measured window, over the window's seconds (host clock)."""


def read(r):
    return r.run.answered_between(r.t0, r.t1) / r.seconds
