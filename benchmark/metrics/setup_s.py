"""setup_s (s, host clock): from the process's start to the window's:
imports, CUDA start, the configuration and the controller built, K1 loaded
(built on a checkout's first run) and one control tick at the cell's
shapes."""


def read(run):
    return run.setup_s
