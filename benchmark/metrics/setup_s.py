"""setup_s: seconds from the start of the benchmark's process to the
first timed frame: loading or building the kernels, building the scene,
the frames that estimate, calibrate and grow the capacity class, the
captures of its programs, and the warm-up frames."""


def read(ctx):
    return ctx["setup_s"]
