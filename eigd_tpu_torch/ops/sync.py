"""Host decisions on device values.

JAX runs the solvers' data-dependent loops (PCG, the Lanczos adaptive
exit, the SIBK ladder and rounds) as ``lax.while_loop`` on the device.
Eager PyTorch evaluates each loop condition on the host, which waits for
the device. Every such decision goes through ``host_bool`` so that a run
can count them: ``HOST_SYNCS[site]`` is the number of decisions the loop
named ``site`` made, each a device-to-host wait on a CUDA tensor (on a CPU
tensor the same decision costs no wait, but is counted all the same, so
CPU and CUDA runs count alike). Library calls that wait on their own, such
as cuSOLVER's eigh, are not counted.
"""

import collections

HOST_SYNCS = collections.Counter()


def host_bool(t, site):
    """bool(t) for a 0-d tensor, counted in HOST_SYNCS[site]."""
    HOST_SYNCS[site] += 1
    return bool(t)
