"""Host decisions on device values.

JAX runs the solvers' data-dependent loops (PCG, the Lanczos adaptive
exit, the SIBK ladder and rounds) as ``lax.while_loop`` on the device.
Eager PyTorch evaluates each loop condition on the host, which waits for
the device. Every such decision goes through ``host_bool`` or
``host_flags`` so that a run can count them: ``HOST_SYNCS[site]`` is the
number of decisions the loop named ``site`` made, each a device-to-host
wait on a CUDA tensor (on a CPU tensor the same decision costs no wait, but
is counted all the same, so CPU and CUDA runs count alike). Library calls
that wait on their own, such as cuSOLVER's eigh, are not counted.

``LOOP_EXITS["site.reason"]`` counts why loops ended: a PCG solve on
convergence, on stagnation (``stag_bad`` iterations without a 10% gain)
or at its iteration cap; the Lanczos sweep on its adaptive exit or after
its last block. ``LOOP_STEPS[site]`` sums the steps those loops ran (PCG
iterations, Lanczos blocks). Recording an exit costs no wait: the reason
is read from flags the last decision already brought to the host.
"""

import collections

HOST_SYNCS = collections.Counter()
LOOP_EXITS = collections.Counter()
LOOP_STEPS = collections.Counter()


def host_bool(t, site):
    """bool(t) for a 0-d tensor, counted in HOST_SYNCS[site]."""
    HOST_SYNCS[site] += 1
    return bool(t)


def host_flags(t, site):
    """The bools of a 1-d bool tensor, read in one wait, counted once in
    HOST_SYNCS[site]."""
    HOST_SYNCS[site] += 1
    return t.tolist()


def loop_exit(site, reason, steps):
    """Count one exit of the loop ``site`` for ``reason``, after
    ``steps`` steps."""
    LOOP_EXITS[f"{site}.{reason}"] += 1
    LOOP_STEPS[site] += steps


def clear():
    """Reset the counters."""
    HOST_SYNCS.clear()
    LOOP_EXITS.clear()
    LOOP_STEPS.clear()
