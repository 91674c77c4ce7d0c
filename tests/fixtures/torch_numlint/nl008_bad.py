"""NL008 bad twin: float literals outside float32's normal range in
device code."""


def smoothed(x):
    # flushes to 0/denormal the moment this kernel runs at f32
    return x + 1e-300


def capped(x):
    return x.clamp(max=1e39)


def smoothed_waived(x):
    return x + 1e-300  # numlint: disable=NL008 (the twin's suppressed copy)
