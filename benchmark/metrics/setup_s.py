"""setup_s: from the start of the benchmark's process (the top of run.py) to
the first timed call: imports, the CUDA context, the kernel libraries, the
input pools and the warm-up calls."""


def read(run):
    return run["setup_s"]
