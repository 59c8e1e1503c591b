"""The window's operation count over its seconds, as a percentage of the
card's float32 peak without tensor cores (``peaks.json``; the port keeps
TF32 off): the whole call's share of the chip."""


def read(run):
    if run.peaks is None:
        return None
    rate = run.window.flops / run.window.seconds
    return 100.0 * rate / run.peaks["f32_flops_per_s"]
