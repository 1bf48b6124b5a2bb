"""Host decisions: ``ops.sync.HOST_SYNCS`` summed over every site in the
window, per design iteration (each a wait of the host on the device)."""


def read(run):
    return sum(run.host_syncs.values()) / run.iterations
