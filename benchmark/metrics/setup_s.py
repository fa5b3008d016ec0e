"""setup_s: process start to the first timed unit (kernel load, the
program's construction, the inputs, the warm-up)."""


def read(run):
    return run["setup_s"]
