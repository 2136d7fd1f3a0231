"""setup_s: from the process's start to the first timed request: imports,
the kernels' build or load, meshes and frames from the seed, the
recogniser, the service, one warm-up request of the first frame."""


def read(run):
    return run.setup_s
