"""Process start to the first timed request (host clock): the kernels found
or built, the frames, the warm passes."""


def read(run):
    return run.setup_s
