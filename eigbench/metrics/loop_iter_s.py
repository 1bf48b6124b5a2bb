"""Design loop: the untraced window's length over the design iterations
completed in it (the optimiser's step, ``initialize``,
``initialize_adjoint``, the seeds and ``finalize_adjoint``), in s. The
host's speed moves it by up to a quarter from run to run, so it is
reported here and not held to a bound."""


def read(run):
    return getattr(run, "loop_iter_s", None)
