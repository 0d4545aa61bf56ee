"""Process start to the first timed request, on the host clock: imports,
the CUDA context, kernel builds (a cold checkout only), keygen, the
engine, warm-up and graph capture, the pool's encryption."""


def read(run, name):
    return run.setup_s
