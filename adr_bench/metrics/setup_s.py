"""Set-up seconds: from the process's start to the window's start (host
clock). It holds the imports, the env's build, the kernels' build where
the checkout has none yet, and the warm-up that captures the programs."""


def read(run):
    return run.setup_s
