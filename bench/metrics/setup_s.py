"""setup_s: seconds from the process's start to the window's (loading,
building or loading the kernels, the program from the cache or its
synthesis and compile, the first request and the warm-up waves)."""


def read(run):
    return run.setup_s
