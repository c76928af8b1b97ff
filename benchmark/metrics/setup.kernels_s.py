"""Set-up seconds to build (first run of a checkout) or load the kernel
library: the host clock around ``utils.build.load_library``."""


def read(run):
    return run["setup"]["kernels_s"]
